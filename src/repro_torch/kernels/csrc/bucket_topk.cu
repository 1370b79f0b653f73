// bucket_topk: score a query's gathered candidates and keep the top m.
//
// Replaces the TPU kernel src/repro/kernels/bucket_topk.py::
// bucket_topk_pallas (_topk_kernel): scores cand[b, KC, D] . q[b, D]; a
// lane whose bit is clear in the validity words (bit i of word w = lane
// w*32 + i) scores -inf; the top m by (score desc, lane asc), -1 where no
// valid lane is left.
//
// Bound on the H100: bytes, reading the valid rows of cand (D*4 B each);
// the products are 2 flops a byte, far under any compute roof.  At the
// engine's shape (b = 128 rows of KC = 6656 lanes) one block a row would
// leave one block an SM with too few loads in flight for HBM3, and m
// block-wide rounds of selection over every lane would follow.
//
// Design: two phases.
//  * bt_part_*: each row's validity words are dealt to S parts, word w to
//    part w % S (the host picks S from b, KC and the SM count,
//    kernels/bucket_topk.py::grid, so the grid fills the card several
//    times over); a block of 4 warps takes one (row, part), and deals the
//    part's words to its warps the same way.  Dealing, not cutting, keeps
//    the parts even where a row's valid lanes cluster (the engine sorts
//    its candidates by id, so the invalid ones come first).  A warp reads
//    each of its validity words once, compacts the set bits into a list
//    of lanes in shared memory (invalid rows are never touched), and
//    scores the list 8 rows at a time: every lane issues its 16-byte
//    loads of the next 8 rows before it reduces these 8 (4-8 KB a warp in
//    flight), q stays in registers, and a reduce-scatter of 9 shuffles
//    leaves each row's sum on 4 lanes.  m <= 32: the scores enter a
//    per-warp sorted list (ballot + shuffle, common.cuh) and warp 0
//    merges the 4 lists; m > 32: the part's sort keys go through a
//    bitonic sort in shared memory.  The part's m best go to a [b, S, m]
//    scratch.
//  * The merge of a row's S*m entries into its m best, a second kernel:
//    for m <= 32 bt_merge_fast, a warp a row with a warp list (a row of
//    one part skips it: the part writes the output); for m > 32
//    bt_merge_sort, a block a row with a bitonic sort.
// Ties go to the lowest lane in both: `better` orders (score, lane).

#include "common.cuh"

#define BT_WARPS 4        // warps a part block
#define BT_U 8            // candidate rows a warp loads before reducing
#define BT_FAST_M 32      // largest m of the warp-list selection
#define BT_ROUND 16       // validity words a warp compacts at once

// The validity word w of a row, bits past kc cleared.
__device__ __forceinline__ uint32_t valid_word(const uint32_t* vw, int w,
                                               int kc) {
  const uint32_t v = __ldg(vw + w);
  const int tail = kc - 32 * w;
  return tail >= 32 ? v : v & ((1u << tail) - 1u);
}

// Reduce the 8 rows' partial dot products and hand each (score, lane)
// to `take` on the lane that holds it: row u's sum ends on lanes 4u ..
// 4u + 3, and lane 4u takes it (the others take none).
template <typename Take>
__device__ __forceinline__ void take_group(float (&p)[BT_U], const int* lanes,
                                           int g, int cnt, int lane,
                                           Take take) {
  reduce_half<8, 16>(p, lane);
  reduce_half<4, 8>(p, lane);
  reduce_half<2, 4>(p, lane);
  float s = p[0] + __shfl_xor_sync(FULL_MASK, p[0], 2);
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  const int u = lane >> 2;
  const bool mine = (lane & 3) == 0 && g + u < cnt;
  take(mine ? s : -CUDART_INF_F, mine ? lanes[g + u] : -1);
}

// Score the `cnt` lanes listed in `lanes` against q, 8 at a time.  At
// d <= 128 with 16-byte loads (a float4 a lane) the next group's loads are
// issued before this group is reduced, so a warp keeps 8 rows in flight
// while it selects; otherwise every lane issues all of a group's loads
// before it uses any.
template <bool VEC, typename Take>
__device__ __forceinline__ void score_list(const float* __restrict__ qr,
                                           const float* __restrict__ cb,
                                           const int* lanes, int cnt, int d,
                                           int lane, Take take) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC && d <= 128) {
    const bool on = 4 * lane < d;
    const float4 qv = on ? __ldg(reinterpret_cast<const float4*>(qr) + lane)
                         : zero;
    float4 cur[BT_U], nxt[BT_U];
#pragma unroll
    for (int u = 0; u < BT_U; ++u)
      cur[u] = on && u < cnt ? __ldg(reinterpret_cast<const float4*>(
                                         cb + (long long)lanes[u] * d) + lane)
                             : zero;
    for (int g = 0; g < cnt; g += BT_U) {
#pragma unroll
      for (int u = 0; u < BT_U; ++u)
        nxt[u] = on && g + BT_U + u < cnt
                     ? __ldg(reinterpret_cast<const float4*>(
                                 cb + (long long)lanes[g + BT_U + u] * d) +
                             lane)
                     : zero;
      float p[BT_U];
#pragma unroll
      for (int u = 0; u < BT_U; ++u)
        p[u] = fmaf(cur[u].w, qv.w, fmaf(cur[u].z, qv.z,
               fmaf(cur[u].y, qv.y, cur[u].x * qv.x)));
      take_group(p, lanes, g, cnt, lane, take);
#pragma unroll
      for (int u = 0; u < BT_U; ++u) cur[u] = nxt[u];
    }
    return;
  }
  for (int g = 0; g < cnt; g += BT_U) {
    const float* rows[BT_U];
#pragma unroll
    for (int u = 0; u < BT_U; ++u)
      rows[u] = g + u < cnt ? cb + (long long)lanes[g + u] * d : nullptr;
    float p[BT_U];
#pragma unroll
    for (int u = 0; u < BT_U; ++u) p[u] = 0.f;
    if (VEC) {
      for (int e = 4 * lane; e < d; e += 128) {
        const float4 qv = __ldg(reinterpret_cast<const float4*>(qr + e));
        float4 v[BT_U];
#pragma unroll
        for (int u = 0; u < BT_U; ++u)  // all loads before any use
          v[u] = rows[u] ? __ldg(reinterpret_cast<const float4*>(rows[u] + e))
                         : zero;
#pragma unroll
        for (int u = 0; u < BT_U; ++u)
          p[u] = fmaf(v[u].w, qv.w, fmaf(v[u].z, qv.z,
                 fmaf(v[u].y, qv.y, fmaf(v[u].x, qv.x, p[u]))));
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        const float qv = __ldg(qr + e);
        float v[BT_U];
#pragma unroll
        for (int u = 0; u < BT_U; ++u) v[u] = rows[u] ? __ldg(rows[u] + e) : 0.f;
#pragma unroll
        for (int u = 0; u < BT_U; ++u) p[u] = fmaf(v[u], qv, p[u]);
      }
    }
    take_group(p, lanes, g, cnt, lane, take);
  }
}

// The warp's share of part `part` of `parts`: the row's words part +
// parts * (warp + nwarps * t), t = 0, 1, ... (interleaved, so that parts
// and warps share rows whose valid lanes cluster), in rounds of BT_ROUND
// words compacted into `lanes` (BT_ROUND * 32 ints of the warp's own),
// then scored.
template <bool VEC, typename Take>
__device__ __forceinline__ void walk_part(const float* __restrict__ qr,
                                          const float* __restrict__ cb,
                                          const uint32_t* __restrict__ vw,
                                          int* lanes, int part, int parts,
                                          int nw, int kc, int d, int warp,
                                          int nwarps, int lane, Take take) {
  const int stride = parts * nwarps;
  for (int first = part + parts * warp; first < nw;
       first += stride * BT_ROUND) {
    uint32_t words[BT_ROUND];  // every word's load issued before any use
#pragma unroll
    for (int i = 0; i < BT_ROUND; ++i) {
      const int w = first + stride * i;
      words[i] = w < nw ? valid_word(vw, w, kc) : 0u;
    }
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < BT_ROUND; ++i) {
      const uint32_t v = words[i];
      if ((v >> lane) & 1u)
        lanes[cnt + __popc(v & ((1u << lane) - 1u))] =
            32 * (first + stride * i) + lane;
      cnt += __popc(v);
    }
    __syncwarp();
    score_list<VEC>(qr, cb, lanes, cnt, d, lane, take);
    __syncwarp();  // the list is read before the next round writes it
  }
}

// Write a row's list (m <= 32 entries, lanes < m): -inf / -1 past the
// live entries.
__device__ __forceinline__ void write_list(const WarpList& l, float* out_s,
                                           int32_t* out_i, long long o,
                                           int m, int lane) {
  if (lane < m) {
    const bool live = l.e.s > -CUDART_INF_F;
    out_s[o + lane] = live ? l.e.s : -CUDART_INF_F;
    out_i[o + lane] = live ? l.e.id : -1;
  }
}

// m <= 32: the part's m best into the [b, S, m] scratch, or, for a row of
// one part, into the output.
template <bool VEC>
__global__ void __launch_bounds__(BT_WARPS * 32)
bt_part_fast(const float* __restrict__ q,          // [b, d]
             const float* __restrict__ cand,       // [b, kc, d]
             const uint32_t* __restrict__ vwords,  // [b, nw]
             float* __restrict__ part_s,           // [b, S, m]
             int32_t* __restrict__ part_i,         // [b, S, m]
             float* __restrict__ out_s,            // [b, m]
             int32_t* __restrict__ out_i,          // [b, m]
             int kc, int d, int nw, int m, int parts) {
  __shared__ int lane_list[BT_WARPS][BT_ROUND * 32];
  __shared__ Entry wl[BT_WARPS][BT_FAST_M];
  const long long row = blockIdx.x / parts;
  const int part = blockIdx.x - (int)(row * parts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpList l = empty_list();
  walk_part<VEC>(q + row * d, cand + row * kc * d, vwords + row * nw,
                 lane_list[warp], part, parts, nw, kc, d, warp, BT_WARPS,
                 lane, [&](float s, int c) {
                   list_offer(l, Entry{s, c, 0}, m, lane);
                 });
  if (lane < m) wl[warp][lane] = l.e;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < BT_WARPS; ++w)
    list_offer(l, lane < m ? wl[w][lane] : no_entry(), m, lane);
  if (parts == 1)
    write_list(l, out_s, out_i, row * m, m, lane);
  else
    write_list(l, part_s, part_i, (row * parts + part) * m, m, lane);
}

// m <= 32: a warp a row merges its S*m part entries with a warp list.
__global__ void __launch_bounds__(BT_WARPS * 32)
bt_merge_fast(const float* __restrict__ part_s,
              const int32_t* __restrict__ part_i, float* __restrict__ out_s,
              int32_t* __restrict__ out_i, int b, int parts, int m) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= b) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long n = (long long)parts * m;
  WarpList f = empty_list();
  for (long long i0 = 0; i0 < n; i0 += 32) {
    const long long i = i0 + lane;
    list_offer(f, i < n ? Entry{part_s[row * n + i], part_i[row * n + i], 0}
                        : no_entry(), m, lane);
  }
  write_list(f, out_s, out_i, row * m, m, lane);
}

// m > 32: the part's sort keys (its j-th word's lanes at 32j ..), over
// the next power of two >= its lanes, in dynamic shared memory before
// the warps' lane lists.
template <bool VEC>
__global__ void __launch_bounds__(BT_WARPS * 32)
bt_part_sort(const float* __restrict__ q, const float* __restrict__ cand,
             const uint32_t* __restrict__ vwords, float* __restrict__ part_s,
             int32_t* __restrict__ part_i, int kc, int d, int nw, int m,
             int parts, unsigned t2) {
  extern __shared__ __align__(16) u64 keys[];  // [t2], then lane lists
  int* lane_list = reinterpret_cast<int*>(keys + t2);
  const long long row = blockIdx.x / parts;
  const int part = blockIdx.x - (int)(row * parts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (unsigned i = threadIdx.x; i < t2; i += blockDim.x) keys[i] = KEY_NONE;
  __syncthreads();
  u64* part_keys = keys;
  walk_part<VEC>(q + row * d, cand + row * kc * d, vwords + row * nw,
                 lane_list + warp * BT_ROUND * 32, part, parts, nw, kc, d,
                 warp, BT_WARPS, lane, [&](float s, int c) {
                   if (c >= 0 && s > -CUDART_INF_F)
                     part_keys[32 * ((c >> 5) - part) / parts + (c & 31)] =
                         sort_key(s, c);
                 });
  __syncthreads();
  block_sort(keys, t2);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const u64 key = j < (int)t2 ? keys[j] : KEY_NONE;
    const bool ok = key != KEY_NONE;
    const long long o = (row * parts + part) * m + j;
    part_s[o] = ok ? key_score(key) : -CUDART_INF_F;
    part_i[o] = ok ? (int)(unsigned)key : -1;
  }
}

// m > 32: a block a row, a bitonic sort of its S*m part entries.
__global__ void __launch_bounds__(BT_WARPS * 32)
bt_merge_sort(const float* __restrict__ part_s,
              const int32_t* __restrict__ part_i, float* __restrict__ out_s,
              int32_t* __restrict__ out_i, int parts, int m, unsigned t2) {
  extern __shared__ __align__(16) u64 keys[];  // [t2]
  const long long row = blockIdx.x;
  const int n = parts * m;
  for (unsigned i = threadIdx.x; i < t2; i += blockDim.x) {
    const long long o = row * n + i;
    keys[i] = (int)i < n && part_i[o] >= 0 ? sort_key(part_s[o], part_i[o])
                                            : KEY_NONE;
  }
  __syncthreads();
  block_sort(keys, t2);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const u64 key = j < (int)t2 ? keys[j] : KEY_NONE;
    const bool ok = key != KEY_NONE;
    out_s[row * m + j] = ok ? key_score(key) : -CUDART_INF_F;
    out_i[row * m + j] = ok ? (int)(unsigned)key : -1;
  }
}

static unsigned pow2_at_least(long long n) {
  unsigned t = 1;
  while (t < n) t <<= 1;
  return t;
}

static int bt_part_sort_limit[2][SMEM_MAX_DEVICES];
static int bt_merge_sort_limit[SMEM_MAX_DEVICES];

// The grid comes from the host (kernels/bucket_topk.py::grid): `parts`
// parts a row, part p holding validity words p, p + parts, ...;
// part_s / part_i are the [b, parts, m] scratch (unused by m <= 32 at one
// part a row).
extern "C" int bucket_topk_launch(const void* q, const void* cand,
                                  const void* vwords, void* part_s,
                                  void* part_i, void* out_s, void* out_i,
                                  int b, int kc, int d, int nw, int m,
                                  int parts, void* stream) {
  if (b < 0 || kc < 1 || m < 1 || parts < 1 || parts > nw)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  const bool vec = d % 4 == 0 && (uintptr_t)cand % 16 == 0 &&
                   (uintptr_t)q % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *cf = (const float*)cand;
  const uint32_t* vw = (const uint32_t*)vwords;
  float *ps = (float*)part_s, *os = (float*)out_s;
  int32_t *pi = (int32_t*)part_i, *oi = (int32_t*)out_i;
  const unsigned blocks = (unsigned)((long long)b * parts);
  if (m <= BT_FAST_M) {
    if (vec)
      bt_part_fast<true><<<blocks, BT_WARPS * 32, 0, st>>>(
          qf, cf, vw, ps, pi, os, oi, kc, d, nw, m, parts);
    else
      bt_part_fast<false><<<blocks, BT_WARPS * 32, 0, st>>>(
          qf, cf, vw, ps, pi, os, oi, kc, d, nw, m, parts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || parts == 1) return (int)err;
    bt_merge_fast<<<(b + BT_WARPS - 1) / BT_WARPS, BT_WARPS * 32, 0, st>>>(
        ps, pi, os, oi, b, parts, m);
    return (int)cudaGetLastError();
  }
  const unsigned t2 = pow2_at_least(32LL * ((nw + parts - 1) / parts));
  const size_t smem = t2 * sizeof(u64) + BT_WARPS * BT_ROUND * 32 * sizeof(int);
  const void* fn = vec ? (const void*)bt_part_sort<true>
                       : (const void*)bt_part_sort<false>;
  int fit = opt_in_smem(fn, bt_part_sort_limit[vec], smem);
  if (fit != 0) return fit;
  const unsigned t2m = pow2_at_least((long long)parts * m);
  const size_t smem_m = t2m * sizeof(u64);
  fit = opt_in_smem((const void*)bt_merge_sort, bt_merge_sort_limit, smem_m);
  if (fit != 0) return fit;
  if (vec)
    bt_part_sort<true><<<blocks, BT_WARPS * 32, smem, st>>>(
        qf, cf, vw, ps, pi, kc, d, nw, m, parts, t2);
  else
    bt_part_sort<false><<<blocks, BT_WARPS * 32, smem, st>>>(
        qf, cf, vw, ps, pi, kc, d, nw, m, parts, t2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bt_merge_sort<<<b, BT_WARPS * 32, smem_m, st>>>(ps, pi, os, oi, parts, m,
                                                  t2m);
  return (int)cudaGetLastError();
}
