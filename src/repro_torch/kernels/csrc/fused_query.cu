// fused_query / fused_contains: gather -> score -> dedup -> top-m of the
// probed buckets of each (query, table) row.
//
// Replaces the TPU kernels src/repro/kernels/fused_query.py::
// fused_query_pallas (_fused_query_kernel, _probe_scores, _select_topm)
// and fused_query.py::fused_contains_pallas (_fused_contains_kernel).
//
// Semantics (those of ref.fused_query_ref, i.e. the staged path):
//   * a slot is a candidate iff probe bit p of meta[r, 0] is set, its id
//     is >= 0 and its id != meta[r, 1];
//   * score: f32 dot, or -sum_w popcount(q[w] ^ pay[w]) over packed words;
//   * duplicate ids: the FIRST occurrence in (probe-major, slot-minor)
//     order survives with its OWN score (a stale copy left in an old
//     bucket may carry another payload);
//   * top m by score desc, ties to the lowest id; dead lanes -1 / -inf.
//
// Bound on the H100: bytes.  Each distinct probed bucket row's ids
// (C*4 B) and the payloads of its live slots (D*4 B for dot, W*4 B for
// hamming) read once.  The rows of one batch name the same bucket many
// times over (the 1-node path: 53 248 probe rows over 15 346 buckets).
//
// Design, over the valid (row, probe) pairs, numbered row-major (pair j
// of row r is row_ptr[r] + the rank of its probe among the row's valid
// ones):
//   0. dot only: fq_group_*, a counting sort of the pairs by bucket row
//      (counts, scans, placement), cut into work items of at most
//      FQ_ITEM_ROWS pairs, so a bucket named by many rows spreads over
//      many blocks.  The kernels after it read the counts (n_pairs,
//      n_small, n_items) from the card; the host sizes the score buffer
//      for r*P pairs, or, where that buffer would be too large, reads
//      n_pairs back once.  `fused_query.group_pairs` is its plain version.
//   1. dot only: fq_score_dot, bucket-major, persistent blocks taking the
//      work items in turn: stages the item's query rows in shared memory,
//      lists the bucket's live slots (id >= 0), reads each live slot's
//      payload ONCE (8 lanes a slot, 16-byte loads, 4 in flight a lane)
//      and scores it against every row of the item.  Scores go to
//      scores[pair, slot] (f32 [>= n_pairs, C]); dead slots are not
//      written.
//      Hamming needs no such pass: its 8-byte words cost less to read in
//      place (step 2) than the buffer costs to write and read.
//   2. fq_select_small (a warp a row, for rows with at most one valid
//      probe: the mesh's fill rows) and fq_select (a block a row), on the
//      row's candidate ids staged in shared memory by flat position
//      (probe-major, slot-minor):
//      m <= 32: each warp keeps its m best entries (score desc, id,
//          position) in a list held one entry a lane (ballot, shuffle),
//          behind a floor taken from its first chunks; the block merges
//          them.  One pass over the row's ids checks that each of the m
//          is its id's first occurrence; if one is not (a stale copy left
//          by churn), an open-addressing hash of 2K 16-bit slots keeping
//          the lowest position per id decides, and the lists are redone
//          over first occurrences only.
//      m > 32: the hash, then a bitonic sort of the first occurrences.
// The TPU kernel's [K, K] equality cube has no counterpart: selection
// costs one or two passes over the row's valid pairs, not m block-wide
// rounds over all P*C lanes.
//
// fused_contains (a warp a row, below) reads ids only, no payload.
// Bound: the id rows of the distinct probed buckets, read once (on a
// hit, those up to the probe that holds it).  Ungrouped, a batch reads a
// bucket row once for each of its rows that probes it (the 1-node path:
// 53 248 probe rows over about 15 400 buckets), mostly from L2; a miss
// reads every valid probe, so miss traffic runs at the L2's read rate.
// Grouping the pairs by bucket (the counting sort above) would read each
// row once, but the sort alone takes longer than the whole kernel.

#include "common.cuh"

#define FQ_ITEM_ROWS 16   // pairs of one work item (fused_query.ITEM_ROWS)
#define FQ_SCORE_THREADS 256
#define FQ_SELECT_THREADS 256
#define FQ_SMALL_WARPS 8  // rows a block of the single-pair select takes
#define FQ_FAST_M 32      // largest m of the warp-list selection
#define FQ_UNROLL 4       // independent loads in flight per lane

static size_t fq_score_smem(int c, int dw) {
  return (size_t)FQ_ITEM_ROWS * dw * 4 + (size_t)c * 4;
}

// ---- grouping: a counting sort of the valid pairs by bucket row ---------
//
// Workspace (int32, laid out as `fused_query.ws_layout` lays it out):
// row_cnt [r], row_ptr [r+1], row_order [r], by_row / by_pair /
// by_bucket [r*P], item_start [r*P], bucket_cnt [R], bucket_off [R+1],
// item_off [R+1], tot [8] with tot = (n_pairs, n_small, n_items, small
// cursor, big cursor, next item).

#define FQ_GROUP_THREADS 256
#define FQ_SCAN_THREADS 1024

struct FqWs {
  int *row_cnt, *row_ptr, *row_order, *by_row, *by_pair, *by_bucket,
      *item_start, *bucket_cnt, *bucket_off, *item_off, *tot;
};

static FqWs fq_ws(void* base, long long r, long long n_probes,
                  long long n_rows) {
  int* p = (int*)base;
  FqWs w;
  const long long rp = r * n_probes;
  w.row_cnt = p; p += r;
  w.row_ptr = p; p += r + 1;
  w.row_order = p; p += r;
  w.by_row = p; p += rp;
  w.by_pair = p; p += rp;
  w.by_bucket = p; p += rp;
  w.item_start = p; p += rp;
  w.bucket_cnt = p; p += n_rows;
  w.bucket_off = p; p += n_rows + 1;
  w.item_off = p; p += n_rows + 1;
  w.tot = p;
  return w;
}

__device__ __forceinline__ int clamp_row(int f, int n_rows) {
  return min(max(f, 0), n_rows - 1);
}

// Per row: its valid pairs, their buckets' counts, the single-pair rows.
__global__ void fq_group_count(const int32_t* __restrict__ fb,
                               const int32_t* __restrict__ meta, FqWs w,
                               int r, int n_probes, int n_rows,
                               int split_small) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= r) return;
  const unsigned pw = (unsigned)meta[2 * row] & ((1u << n_probes) - 1u);
  w.row_cnt[row] = __popc(pw);
  if (split_small && __popc(pw) <= 1) atomicAdd(&w.tot[1], 1);
  for (int p = 0; p < n_probes; ++p)
    if ((pw >> p) & 1)
      atomicAdd(&w.bucket_cnt[clamp_row(fb[row * n_probes + p], n_rows)], 1);
}

// Exclusive scans, a block each: row_ptr of row_cnt (block 0), bucket_off
// of bucket_cnt (1), item_off of ceil(bucket_cnt / FQ_ITEM_ROWS) (2); each
// output has n + 1 entries, the last the total (n_pairs and n_items also
// into tot).
__global__ void __launch_bounds__(FQ_SCAN_THREADS)
fq_group_scan(FqWs w, int r, int n_rows) {
  __shared__ long long warp_sum[FQ_SCAN_THREADS / 32];
  __shared__ long long tile_sum;
  const int job = blockIdx.x;
  const int* in = job == 0 ? w.row_cnt : w.bucket_cnt;
  int* out = job == 0 ? w.row_ptr : job == 1 ? w.bucket_off : w.item_off;
  const long long n = job == 0 ? r : n_rows;
  const int div = job == 2 ? FQ_ITEM_ROWS : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long carry = 0;
  // tiles of 4 consecutive entries a thread
  for (long long t0 = 0; t0 < n; t0 += 4 * FQ_SCAN_THREADS) {
    const long long i0 = t0 + 4LL * tid;
    int v[4];
    long long sum = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      v[x] = i0 + x < n ? (in[i0 + x] + div - 1) / div : 0;
      sum += v[x];
    }
    long long incl = sum;  // inclusive over the warp's threads
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const long long ws = warp_sum[lane];
      long long x = ws;
      for (int off = 1; off < 32; off <<= 1) {
        const long long o = __shfl_up_sync(FULL_MASK, x, off);
        if (lane >= off) x += o;
      }
      warp_sum[lane] = x - ws;  // exclusive over warps
      if (lane == 31) tile_sum = x;
    }
    __syncthreads();
    long long run = carry + warp_sum[warp] + incl - sum;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (i0 + x < n) out[i0 + x] = (int)run;
      run += v[x];
    }
    carry += tile_sum;
    __syncthreads();  // warp_sum and tile_sum are rewritten next tile
  }
  if (tid == 0) {
    out[n] = (int)carry;
    if (job != 1) w.tot[job == 0 ? 0 : 2] = (int)carry;  // n_pairs, n_items
  }
}

// Per row: place its pairs in their buckets' ranges, and the row in
// row_order (single-pair rows first).  Order within a bucket, and
// within each class of rows, is whatever the atomics give.
__global__ void fq_group_place(const int32_t* __restrict__ fb,
                               const int32_t* __restrict__ meta, FqWs w,
                               int r, int n_probes, int n_rows,
                               int split_small) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= r) return;
  const unsigned pw = (unsigned)meta[2 * row] & ((1u << n_probes) - 1u);
  int j = w.row_ptr[row];
  for (int p = 0; p < n_probes; ++p) {
    if (!((pw >> p) & 1)) continue;
    const int b = clamp_row(fb[row * n_probes + p], n_rows);
    const int pos = w.bucket_off[b] + atomicSub(&w.bucket_cnt[b], 1) - 1;
    w.by_row[pos] = (int)row;
    w.by_pair[pos] = j++;
    w.by_bucket[pos] = b;
  }
  if (split_small && __popc(pw) <= 1)
    w.row_order[atomicAdd(&w.tot[3], 1)] = (int)row;
  else
    w.row_order[r - 1 - atomicAdd(&w.tot[4], 1)] = (int)row;
}

// Per bucket row: its work items, FQ_ITEM_ROWS pairs each from its first.
__global__ void fq_group_items(FqWs w, int n_rows) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  const int start = w.bucket_off[b], cnt = w.bucket_off[b + 1] - start;
  for (int i = 0, it = w.item_off[b]; i * FQ_ITEM_ROWS < cnt; ++i, ++it)
    w.item_start[it] = start + i * FQ_ITEM_ROWS;
}

// First half of the grouping: counts and scans, then, if `host` (pinned)
// is not null, the copy of (n_pairs, n_small) to it.  The caller records
// an event here, then runs fused_query_group_place.
extern "C" int fused_query_group_count(const void* fb, const void* meta,
                                       void* ws, void* host, int r,
                                       int n_rows, int n_probes,
                                       int split_small, void* stream) {
  if (n_probes > 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const FqWs w = fq_ws(ws, r, n_probes, n_rows);
  cudaError_t err = cudaMemsetAsync(w.bucket_cnt, 0, sizeof(int) * n_rows, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(w.tot, 0, sizeof(int) * 8, st);
  if (err != cudaSuccess) return (int)err;
  if (r > 0)
    fq_group_count<<<(r + FQ_GROUP_THREADS - 1) / FQ_GROUP_THREADS,
                     FQ_GROUP_THREADS, 0, st>>>(
        (const int32_t*)fb, (const int32_t*)meta, w, r, n_probes, n_rows,
        split_small);
  fq_group_scan<<<3, FQ_SCAN_THREADS, 0, st>>>(w, r, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || host == nullptr) return (int)err;
  return (int)cudaMemcpyAsync(host, w.tot, 2 * sizeof(int),
                              cudaMemcpyDeviceToHost, st);
}

extern "C" int fused_query_group_place(const void* fb, const void* meta,
                                       void* ws, int r, int n_rows,
                                       int n_probes, int split_small,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const FqWs w = fq_ws(ws, r, n_probes, n_rows);
  if (r > 0)
    fq_group_place<<<(r + FQ_GROUP_THREADS - 1) / FQ_GROUP_THREADS,
                     FQ_GROUP_THREADS, 0, st>>>(
        (const int32_t*)fb, (const int32_t*)meta, w, r, n_probes, n_rows,
        split_small);
  if (n_rows > 0)
    fq_group_items<<<(n_rows + FQ_GROUP_THREADS - 1) / FQ_GROUP_THREADS,
                     FQ_GROUP_THREADS, 0, st>>>(w, n_rows);
  return (int)cudaGetLastError();
}

// Stage work item `item`: its query rows into q_s, its pairs' buffer rows
// into pair_s, the bucket's live slots into live.  Returns the item's row
// count; *b_out is the bucket row, *nl_out the live count.
__device__ __forceinline__ int stage_item(
    const int32_t* __restrict__ ids_flat, const float* __restrict__ q,
    const int32_t* __restrict__ s_row, const int32_t* __restrict__ s_pair,
    const int32_t* __restrict__ s_bucket,
    const int32_t* __restrict__ item_start, int item, int n_items,
    int n_pairs, int c, int dw, float* q_s, int* live, int* pair_s,
    int* n_live,
    long long* b_out, int* nl_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = FQ_SCORE_THREADS / 32;
  const int i0 = item_start[item];
  const int i1 = item + 1 < n_items ? item_start[item + 1] : n_pairs;
  const int n = i1 - i0;
  const long long b = s_bucket[i0];
  if (tid == 0) *n_live = 0;
  if (tid < n) pair_s[tid] = s_pair[i0 + tid];
  for (int i = tid; i < n * dw; i += FQ_SCORE_THREADS) {
    const int k = i / dw;
    q_s[i] = q[(long long)s_row[i0 + k] * dw + (i - k * dw)];
  }
  __syncthreads();
  // the bucket's live slots (order within the list is free)
  const int32_t* ids = ids_flat + b * c;
  for (int s0 = warp * 32; s0 < c; s0 += nwarps * 32) {
    const int s = s0 + lane;
    const bool ok = s < c && __ldg(ids + s) >= 0;
    const unsigned bal = __ballot_sync(FULL_MASK, ok);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(n_live, __popc(bal));
    base = __shfl_sync(FULL_MASK, base, 0);
    if (ok) live[base + __popc(bal & ((1u << lane) - 1))] = s;
  }
  __syncthreads();
  *b_out = b;
  *nl_out = *n_live;
  return n;
}

// Persistent blocks take the work items in turn: the first gridDim.x by
// block index, each later one from the counter tot[5] (zeroed by the
// grouping), so blocks that drew light items take more.  tot is the
// grouping's: n_pairs = tot[0], n_items = tot[2].
__global__ void __launch_bounds__(FQ_SCORE_THREADS)
fq_score_dot(const int32_t* __restrict__ ids_flat,  // [R, C]
             const float* __restrict__ pay,         // [R, C, D]
             const float* __restrict__ q,           // [r, D]
             const int32_t* __restrict__ s_row,     // [n_pairs] by bucket
             const int32_t* __restrict__ s_pair,
             const int32_t* __restrict__ s_bucket,
             const int32_t* __restrict__ item_start,
             int* __restrict__ tot,
             float* __restrict__ scores,            // [>= n_pairs, C]
             int c, int d) {
  extern __shared__ __align__(16) float fq_smem[];
  float* q_s = fq_smem;                                        // [ROWS, d]
  int* live = reinterpret_cast<int*>(q_s + FQ_ITEM_ROWS * d);  // [c]
  __shared__ int pair_s[FQ_ITEM_ROWS];
  __shared__ int n_live;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = FQ_SCORE_THREADS / 32;
  // 8 lanes a slot, 4 slots a warp; each lane holds up to 16 floats of
  // the row per pass (4 loads in flight) and FQ_ITEM_ROWS partial sums
  const int grp = lane >> 3, u = lane & 7;
  const bool vec4 = (d & 3) == 0 && ((size_t)pay & 15) == 0;
  const int n_pairs = tot[0], n_items = tot[2];

  __shared__ int next;
  for (int item = blockIdx.x; item < n_items; item = next) {
    long long b;
    int nl;
    const int n = stage_item(ids_flat, q, s_row, s_pair, s_bucket, item_start,
                             item, n_items, n_pairs, c, d, q_s, live, pair_s,
                             &n_live, &b, &nl);
    for (int l0 = warp * 4; l0 < nl; l0 += nwarps * 4) {
      const int li = l0 + grp;
      const bool act = li < nl;
      const int sl = act ? live[li] : 0;
      const float* row = pay + (b * c + sl) * d;
      float acc[FQ_ITEM_ROWS];
#pragma unroll
      for (int k = 0; k < FQ_ITEM_ROWS; ++k) acc[k] = 0.f;
      if (vec4) {
        for (int e0 = 0; e0 < d; e0 += 128) {
          float4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = e0 + j * 32 + u * 4;
            v[j] = act && e < d
                       ? __ldg(reinterpret_cast<const float4*>(row + e))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = e0 + j * 32 + u * 4;
            if (e >= d) break;
#pragma unroll
            for (int k = 0; k < FQ_ITEM_ROWS; ++k) {
              if (k >= n) break;
              const float4 qq =
                  *reinterpret_cast<const float4*>(q_s + k * d + e);
              acc[k] = fmaf(v[j].x, qq.x, acc[k]);
              acc[k] = fmaf(v[j].y, qq.y, acc[k]);
              acc[k] = fmaf(v[j].z, qq.z, acc[k]);
              acc[k] = fmaf(v[j].w, qq.w, acc[k]);
            }
          }
        }
      } else {
        for (int e0 = 0; e0 < d; e0 += 64) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = e0 + j * 8 + u;
            v[j] = act && e < d ? __ldg(row + e) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = e0 + j * 8 + u;
            if (e >= d) break;
#pragma unroll
            for (int k = 0; k < FQ_ITEM_ROWS; ++k) {
              if (k >= n) break;
              acc[k] = fmaf(v[j], q_s[k * d + e], acc[k]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < FQ_ITEM_ROWS; ++k) {
        if (k >= n) break;
        acc[k] += __shfl_xor_sync(FULL_MASK, acc[k], 4);
        acc[k] += __shfl_xor_sync(FULL_MASK, acc[k], 2);
        acc[k] += __shfl_xor_sync(FULL_MASK, acc[k], 1);
        if (act && (k & 7) == u)
          scores[(long long)pair_s[k] * c + sl] = acc[k];
      }
    }
    __syncthreads();  // the next item restages the shared arrays
    if (threadIdx.x == 0) next = gridDim.x + atomicAdd(&tot[5], 1);
    __syncthreads();
  }
}

// ---- selection ----------------------------------------------------------
//
// A row's K = np*C candidates sit in shared memory as ids (int32, -1 for
// dead or excluded lanes) indexed by flat position pos = k*C + slot.
//
// m <= 32: every warp keeps the m best (score, id, pos) entries it sees
// (a WarpList of common.cuh),
// with no dedup; the block's m best L follow by merging.  An entry of L
// counts iff it is its id's first occurrence, which one pass over the
// row's ids decides (a 4096-bit filter of L's ids in front of the exact
// check).  If all m count, or L holds every live entry, the answer is L's
// entries that count: the top m of the first occurrences lie in L
// whenever m of L's entries count.  Otherwise (a later copy of an id
// among the best m: a stale copy left by churn) the row falls back to
// the hash below.
//
// Hash (the fallback, and m > 32): open addressing over 2K 16-bit slots,
// each naming the lowest position seen of one id, the id read back from
// the staged ids.

#define FQ_NONE 0xffff
#define FQ_FILTER_WORDS 128  // 4096-bit filter of L's ids

// The m-th best of the warp's 32 lane entries (a bitonic sort, best to
// lane 0), on every lane.
__device__ __forceinline__ Entry warp_kth(Entry e, int m, int lane) {
  for (int k = 2; k <= 32; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      const Entry o = Entry{__shfl_xor_sync(FULL_MASK, e.s, j),
                            __shfl_xor_sync(FULL_MASK, e.id, j),
                            __shfl_xor_sync(FULL_MASK, e.pos, j)};
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_better ? ahead(o, e) : ahead(e, o)) e = o;
    }
  return shfl(e, m - 1);
}

// Hash tables of t slots (any t >= 1), linear probing.
__device__ __forceinline__ unsigned fq_hash(int id, unsigned t) {
  return __umulhi((unsigned)id * 0x9E3779B1u, t);
}

// Enter position pos of `id` (ids[pos] == id), keeping the lowest
// position per id.  A slot only ever holds positions of one id.
__device__ __forceinline__ void fq_insert(unsigned short* tab, unsigned t,
                                          const int* ids, int id, int pos) {
  unsigned h = fq_hash(id, t);
  while (true) {
    unsigned short cur = atomicCAS(&tab[h], (unsigned short)FQ_NONE,
                                   (unsigned short)pos);
    if (cur == FQ_NONE) return;
    if (ids[cur] == id) {
      while (pos < cur) {  // an atomic min
        const unsigned short old =
            atomicCAS(&tab[h], cur, (unsigned short)pos);
        if (old == cur) return;
        cur = old;
      }
      return;
    }
    h = h + 1 == t ? 0 : h + 1;
  }
}

// First position of an id that is in the table.
__device__ __forceinline__ int fq_first(const unsigned short* tab,
                                        unsigned t, const int* ids, int id) {
  unsigned h = fq_hash(id, t);
  while (true) {
    const int e = tab[h];
    if (ids[e] == id) return e;
    h = h + 1 == t ? 0 : h + 1;
  }
}

// Stage the row's candidates: ids[pos] for pos = start, start + stride,
// ... < k_all (-1 unless live and not excluded), FQ_UNROLL loads in
// flight.  bo[k] is the first slot of the row's k-th valid probe.
__device__ __forceinline__ void load_ids(
    int* ids, const int32_t* __restrict__ ids_flat, const long long* bo,
    int c, int excl, int k_all, int start, int stride) {
  for (int p0 = start; p0 < k_all; p0 += FQ_UNROLL * stride) {
    int id[FQ_UNROLL];
#pragma unroll
    for (int x = 0; x < FQ_UNROLL; ++x) {
      const int pos = p0 + x * stride, k = pos / c;
      id[x] = pos < k_all ? __ldg(ids_flat + bo[k] + (pos - k * c)) : -1;
    }
#pragma unroll
    for (int x = 0; x < FQ_UNROLL; ++x) {
      const int pos = p0 + x * stride;
      if (pos < k_all) ids[pos] = id[x] >= 0 && id[x] != excl ? id[x] : -1;
    }
  }
}

// The table of first positions: cleared, then every live position.
// `sync` is the caller's barrier (block or warp).
template <typename Sync>
__device__ __forceinline__ void build_table(unsigned short* tab, unsigned t,
                                            const int* ids, int k_all,
                                            int start, int stride,
                                            Sync sync) {
  for (int i = start; i < (int)t; i += stride) tab[i] = FQ_NONE;
  sync();
  for (int pos = start; pos < k_all; pos += stride)
    if (ids[pos] >= 0) fq_insert(tab, t, ids, ids[pos], pos);
  sync();
}

// Where a row's scores come from.  Dot: the score buffer, `sc` the row's
// first score (pair base, slot 0); a row's pairs are consecutive in it,
// so position pos scores at sc[pos].  Hamming (sc null): the packed words
// themselves, -popcount(q ^ word) over w words, read in place: 8 bytes a
// slot cost less than the buffer's write and read.
struct RowScores {
  const float* sc;
  const uint32_t* words;  // [R*C, w]
  const uint32_t* q;      // the row's w query words
  const long long* bo;    // first slot of the row's k-th valid probe
  int c, w;
  __device__ __forceinline__ float operator()(int pos) const {
    if (sc != nullptr) return __ldg(sc + pos);
    const int k = pos / c;
    const uint32_t* row = words + (bo[k] + (pos - k * c)) * w;
    int hd = 0;
    for (int x = 0; x < w; ++x) hd += __popc(__ldg(row + x) ^ __ldg(q + x));
    return -(float)hd;
  }
};

// A warp's pass over the 32-position chunks first, first + stride, ...
// of the row, offering each entry to the list; a position that is dead
// (or, with a table, not its id's first occurrence) offers nothing.
// After the first FQ_UNROLL chunks the list gets a floor: the m-th best
// of the lanes' best entries so far, at or above which at least m entries
// rank, so the rest of the pass offers only what can still count.
__device__ __forceinline__ void scan_row(const unsigned short* tab,
                                         unsigned t, const int* ids,
                                         const RowScores& sc, int k_all,
                                         int first, int stride, int m,
                                         WarpList& l) {
  const int lane = threadIdx.x & 31;
  bool floored = false;
  for (int ch0 = first; ch0 * 32 < k_all; ch0 += FQ_UNROLL * stride) {
    Entry e[FQ_UNROLL];
#pragma unroll
    for (int x = 0; x < FQ_UNROLL; ++x) {
      const int pos = (ch0 + x * stride) * 32 + lane;
      e[x] = Entry{pos < k_all && ids[pos] >= 0 ? sc(pos) : -CUDART_INF_F,
                   pos < k_all ? ids[pos] : -1, pos};
    }
#pragma unroll
    for (int x = 0; x < FQ_UNROLL; ++x)
      if (e[x].id < 0 ||
          (tab != nullptr && fq_first(tab, t, ids, e[x].id) != e[x].pos))
        e[x].s = -CUDART_INF_F;
    if (!floored) {  // warp-uniform
      Entry best = no_entry();
#pragma unroll
      for (int x = 0; x < FQ_UNROLL; ++x)
        if (e[x].s > -CUDART_INF_F && ahead(e[x], best)) best = e[x];
      l.floor = warp_kth(best, m, lane);
      floored = true;
    }
#pragma unroll
    for (int x = 0; x < FQ_UNROLL; ++x) list_offer(l, e[x], m, lane);
  }
}

// Shared state of the verification of a list L of at most m entries.
struct Verify {
  float s[FQ_FAST_M];
  int id[FQ_FAST_M], pos[FQ_FAST_M], later[FQ_FAST_M];
  unsigned filter[FQ_FILTER_WORDS];
};

// Lane i < m of the calling warp publishes entry i of `l`, and its id in
// the filter (cleared beforehand by the caller).  Returns |L|.
__device__ __forceinline__ int publish(Verify& v, const WarpList& l, int m,
                                       int lane) {
  const bool has = lane < m && l.e.id != INT_MAX_;
  v.s[lane] = l.e.s;
  v.id[lane] = has ? l.e.id : INT_MAX_;
  v.pos[lane] = l.e.pos;
  v.later[lane] = 0;
  if (has) {
    const unsigned h = fq_hash(l.e.id, 32 * FQ_FILTER_WORDS);
    atomicOr(&v.filter[h >> 5], 1u << (h & 31));
  }
  return __popc(__ballot_sync(FULL_MASK, has));
}

// Marks each entry of L that has an earlier occurrence of its id.
__device__ __forceinline__ void mark_later(Verify& v, int n_list,
                                           const int* ids, int k_all,
                                           int start, int stride) {
  for (int pos = start; pos < k_all; pos += stride) {
    const int id = ids[pos];
    if (id < 0) continue;
    const unsigned h = fq_hash(id, 32 * FQ_FILTER_WORDS);
    if (!((v.filter[h >> 5] >> (h & 31)) & 1)) continue;
    for (int j = 0; j < n_list; ++j)
      if (v.id[j] == id && pos < v.pos[j]) v.later[j] = 1;
  }
}

// The calling warp writes L's entries that count, padded to m.  Returns
// false, writing nothing, when one does not count while L may have left
// out live entries (|L| == m): the hash has to decide.
__device__ __forceinline__ bool emit_verified(const Verify& v, int n_list,
                                              int32_t* out_i, float* out_s,
                                              long long r, int m, int lane) {
  const bool ok = lane < n_list && !v.later[lane];
  const unsigned bal = __ballot_sync(FULL_MASK, ok);
  const int n_ok = __popc(bal);
  if (n_ok < m && n_list == m) return false;
  const int rank = __popc(bal & ((1u << lane) - 1u));
  if (ok && rank < m) {
    out_i[r * m + rank] = v.id[lane];
    out_s[r * m + rank] = v.s[lane];
  }
  for (int j = n_ok + lane; j < m; j += 32) {
    out_i[r * m + j] = -1;
    out_s[r * m + j] = -CUDART_INF_F;
  }
  return true;
}

__device__ __forceinline__ void emit_list(const WarpList& l, int32_t* out_i,
                                          float* out_s, long long r, int m,
                                          int lane) {
  if (lane < m) {
    const bool ok = l.e.id != INT_MAX_;
    out_i[r * m + lane] = ok ? l.e.id : -1;
    out_s[r * m + lane] = ok ? l.e.s : -CUDART_INF_F;
  }
}

__device__ __forceinline__ long long probe_row(const int32_t* __restrict__ fb,
                                               long long r, int n_probes,
                                               int p, int n_rows, int c) {
  return (long long)clamp_row(fb[r * n_probes + p], n_rows) * c;
}

__device__ __forceinline__ void write_padding(int32_t* out_i, float* out_s,
                                              long long r, int m, int start,
                                              int stride) {
  for (int j = start; j < m; j += stride) {
    out_i[r * m + j] = -1;
    out_s[r * m + j] = -CUDART_INF_F;
  }
}

// Per-warp shared memory of fq_select_small, in 4-byte words.
__host__ __device__ __forceinline__ int small_words(int c) {
  return 2 * c + (int)(sizeof(Verify) / 4);
}

// Which rows a select kernel takes.  With a grouping, row_order lists
// the n_small rows of at most one valid probe first (n_small is read
// from the grouping's counts, *n_small_dev; the grids may cover more
// rows than there are, and the extra warps or blocks return); without
// one (the hamming path) every kernel walks all rows by index and keeps
// its own.
__device__ __forceinline__ long long pick_row(const int32_t* row_order,
                                              long long i) {
  return row_order != nullptr ? row_order[i] : i;
}

// Rows with at most one valid probe (m <= 32): a warp a row, with its own
// ids [C], Verify state and (for the fallback) a table of 2C slots.
__global__ void __launch_bounds__(FQ_SMALL_WARPS * 32)
fq_select_small(const int32_t* __restrict__ ids_flat,  // [R, C]
                const float* __restrict__ scores,      // [n_pairs, C] or null
                const uint32_t* __restrict__ words,    // [R, C, w] (hamming)
                const uint32_t* __restrict__ q,        // [r, w] (hamming)
                const int32_t* __restrict__ fb,        // [r, P]
                const int32_t* __restrict__ meta,      // [r, 2]
                const int32_t* __restrict__ row_ptr,   // [r + 1] or null
                const int32_t* __restrict__ row_order,  // [r] or null
                const int32_t* __restrict__ n_small_dev,  // or null
                int32_t* __restrict__ out_i,           // [r, m]
                float* __restrict__ out_s,             // [r, m]
                int n_small, int n_rows, int c, int w, int n_probes, int m) {
  extern __shared__ __align__(16) int small_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wi = (long long)blockIdx.x * FQ_SMALL_WARPS + warp;
  if (wi >= (n_small_dev != nullptr ? *n_small_dev : n_small))
    return;  // whole warp
  const long long r = pick_row(row_order, wi);
  const unsigned pw = (unsigned)meta[2 * r] & ((1u << n_probes) - 1u);
  if (row_order == nullptr && __popc(pw) > 1) return;  // fq_select's
  if (pw == 0) {
    write_padding(out_i, out_s, r, m, lane, 32);
    return;
  }
  int* base = small_smem + (long long)warp * small_words(c);
  Verify& v = *reinterpret_cast<Verify*>(base);
  int* ids = base + sizeof(Verify) / 4;
  unsigned short* tab = reinterpret_cast<unsigned short*>(ids + c);
  const long long bo[1] = {probe_row(fb, r, n_probes, __ffs(pw) - 1, n_rows,
                                     c)};
  for (int i = lane; i < FQ_FILTER_WORDS; i += 32) v.filter[i] = 0;
  load_ids(ids, ids_flat, bo, c, meta[2 * r + 1], c, lane, 32);
  __syncwarp();
  const RowScores sc{scores ? scores + (long long)row_ptr[r] * c : nullptr,
                     words, q + r * w, bo, c, w};
  WarpList l = empty_list();
  scan_row(nullptr, 0, ids, sc, c, 0, 1, m, l);
  const int n_list = publish(v, l, m, lane);
  __syncwarp();
  mark_later(v, n_list, ids, c, lane, 32);
  __syncwarp();
  if (emit_verified(v, n_list, out_i, out_s, r, m, lane)) return;
  const auto sync = [] { __syncwarp(); };
  build_table(tab, 2 * c, ids, c, lane, 32, sync);
  WarpList f = empty_list();
  scan_row(tab, 2 * c, ids, sc, c, 0, 1, m, f);
  emit_list(f, out_i, out_s, r, m, lane);
}

// Merge the warps' lists (wl [warps][FQ_FAST_M]) into warp 0's `l`.
__device__ __forceinline__ void merge_lists(WarpList& l,
                                            const Entry (*wl)[FQ_FAST_M],
                                            int nwarps, int m, int lane) {
  for (int w = 1; w < nwarps; ++w)
    list_offer(l, lane < m ? wl[w][lane] : no_entry(), m, lane);
}

// The other rows: a block a row.  Shared memory: ids [k_alloc], the
// table [2 * k_alloc] of 16-bit positions and, for m > 32, sort keys
// [next power of two >= k_alloc].
template <bool FAST>
__global__ void __launch_bounds__(FQ_SELECT_THREADS)
fq_select(const int32_t* __restrict__ ids_flat,  // [R, C]
          const float* __restrict__ scores,      // [n_pairs, C] or null
          const uint32_t* __restrict__ words,    // [R, C, w] (hamming)
          const uint32_t* __restrict__ q,        // [r, w] (hamming)
          const int32_t* __restrict__ fb,        // [r, P]
          const int32_t* __restrict__ meta,      // [r, 2]
          const int32_t* __restrict__ row_ptr,   // [r + 1] or null
          const int32_t* __restrict__ row_order,  // [r] or null
          const int32_t* __restrict__ n_small_dev,  // or null
          int32_t* __restrict__ out_i,           // [r, m]
          float* __restrict__ out_s,             // [r, m]
          int n_small, int n_query_rows, int n_rows, int c, int w,
          int n_probes, int m, int k_alloc) {
  extern __shared__ __align__(16) int big_smem[];
  __shared__ long long bo[32];
  __shared__ Entry wl[FQ_SELECT_THREADS / 32][FQ_FAST_M];
  __shared__ Verify v;
  __shared__ int n_list, verified;

  const long long row_i =
      (n_small_dev != nullptr ? *n_small_dev : n_small) + (long long)blockIdx.x;
  if (row_i >= n_query_rows) return;  // whole block, before any barrier
  const long long r = pick_row(row_order, row_i);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = FQ_SELECT_THREADS / 32;
  const unsigned pw = (unsigned)meta[2 * r] & ((1u << n_probes) - 1u);
  const int np = __popc(pw);
  if (row_order == nullptr && FAST && np <= 1) return;  // fq_select_small's
  if (np == 0) {
    write_padding(out_i, out_s, r, m, tid, FQ_SELECT_THREADS);
    return;  // whole block
  }
  int* ids = big_smem;
  unsigned short* tab = reinterpret_cast<unsigned short*>(ids + k_alloc);
  if (tid < n_probes && ((pw >> tid) & 1))
    bo[__popc(pw & ((1u << tid) - 1u))] =
        probe_row(fb, r, n_probes, tid, n_rows, c);
  for (int i = tid; i < FQ_FILTER_WORDS; i += FQ_SELECT_THREADS)
    v.filter[i] = 0;
  const int k_all = np * c;
  const unsigned t = 2 * k_all;
  __syncthreads();
  load_ids(ids, ids_flat, bo, c, meta[2 * r + 1], k_all, tid,
           FQ_SELECT_THREADS);
  __syncthreads();
  const RowScores sc{scores ? scores + (long long)row_ptr[r] * c : nullptr,
                     words, q + r * w, bo, c, w};
  const auto sync = [] { __syncthreads(); };
  if (FAST) {
    // the block's m best entries, then their first-occurrence check
    WarpList l = empty_list();
    scan_row(nullptr, 0, ids, sc, k_all, warp, nwarps, m, l);
    if (lane < m) wl[warp][lane] = l.e;
    __syncthreads();
    if (warp == 0) {
      merge_lists(l, wl, nwarps, m, lane);
      const int n = publish(v, l, m, lane);
      if (lane == 0) n_list = n;
    }
    __syncthreads();
    mark_later(v, n_list, ids, k_all, tid, FQ_SELECT_THREADS);
    __syncthreads();
    if (warp == 0) {
      const bool done = emit_verified(v, n_list, out_i, out_s, r, m, lane);
      if (lane == 0) verified = done;
    }
    __syncthreads();
    if (verified) return;  // whole block
    // the fallback: first occurrences from the hash, top m of them
    build_table(tab, t, ids, k_all, tid, FQ_SELECT_THREADS, sync);
    WarpList f = empty_list();
    scan_row(tab, t, ids, sc, k_all, warp, nwarps, m, f);
    if (lane < m) wl[warp][lane] = f.e;
    __syncthreads();
    if (warp == 0) {
      merge_lists(f, wl, nwarps, m, lane);
      emit_list(f, out_i, out_s, r, m, lane);
    }
  } else {
    // m > 32: the first occurrences as sort keys, sorted bitonically over
    // the next power of two (other keys KEY_NONE, sorted last)
    build_table(tab, t, ids, k_all, tid, FQ_SELECT_THREADS, sync);
    u64* keys = reinterpret_cast<u64*>(big_smem + 2 * k_alloc);
    unsigned t2 = 1;
    while (t2 < (unsigned)k_all) t2 <<= 1;
    for (int i = tid; i < (int)t2; i += FQ_SELECT_THREADS) {
      u64 key = KEY_NONE;
      if (i < k_all && ids[i] >= 0 && fq_first(tab, t, ids, ids[i]) == i) {
        const float x = sc(i);
        if (x > -CUDART_INF_F) key = sort_key(x, ids[i]);
      }
      keys[i] = key;
    }
    __syncthreads();
    block_sort(keys, t2);
    for (int j = tid; j < m; j += FQ_SELECT_THREADS) {
      const u64 key = j < (int)t2 ? keys[j] : KEY_NONE;
      const bool ok = key != KEY_NONE;
      out_i[r * m + j] = ok ? (int)(unsigned)key : -1;
      out_s[r * m + j] = ok ? key_score(key) : -CUDART_INF_F;
    }
  }
}

// ---- fused_contains ------------------------------------------------------
//
// A warp a row, `rows` rows a block (`fused_query.contains_grid`).  The
// warp reads the row's metadata in one round (lane p: probe p's bucket
// row; every lane: the word and the target), ranks the valid probes with
// a ballot and keeps their bucket rows in a warp-private table in shared
// memory.  Then the first valid probe (the exact bucket on the main
// path) alone: a lane loads FC_VECS 16-byte vectors of it (single ids
// where the rows are not 16-byte aligned), and the row stops at a hit.
// The other valid probes follow FC_PROBES at a time, every load of a
// round in flight before its first compare.  Invalid probes, and rows
// with no valid probe, load no ids.
#define FC_MAX_ROWS 16  // rows (warps) a block of the default build, and
                        // CONTAINS_MAX_ROWS; a 32-row build serves 32
#define FC_VECS 4       // loads a lane takes along one bucket row a round
#define FC_PROBES 2     // probes a round after the first

template <bool VEC>
struct FcIds;
template <>
struct FcIds<true> {  // 4 ids a load
  using T = int4;
  static __device__ __forceinline__ int4 get(const int32_t* row, int v) {
    return __ldg(reinterpret_cast<const int4*>(row) + v);
  }
  static __device__ __forceinline__ int eq(int4 x, int t) {
    return (x.x == t) | (x.y == t) | (x.z == t) | (x.w == t);
  }
};
template <>
struct FcIds<false> {  // one id a load: C % 4 != 0, or a misaligned view
  using T = int32_t;
  static __device__ __forceinline__ int32_t get(const int32_t* row, int v) {
    return __ldg(row + v);
  }
  static __device__ __forceinline__ int eq(int32_t x, int t) { return x == t; }
};

// Whether `tgt` lies in the bucket rows of valid probes k0 .. k0+NP-1
// (those below n), over a lane's share of the nv loads along each.
template <bool VEC, int NP>
__device__ __forceinline__ int fc_scan(const int32_t* __restrict__ ids_flat,
                                       const int* bucket, int k0, int n,
                                       int nv, int c, int lane, int tgt) {
  using Ids = FcIds<VEC>;
  int hit = 0;
  for (int v0 = lane; v0 < nv; v0 += 32 * FC_VECS) {
    typename Ids::T x[NP][FC_VECS];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int32_t* b = ids_flat + (size_t)bucket[min(k0 + i, n - 1)] * c;
#pragma unroll
      for (int j = 0; j < FC_VECS; ++j)
        if (k0 + i < n && v0 + 32 * j < nv) x[i][j] = Ids::get(b, v0 + 32 * j);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < FC_VECS; ++j)
        if (k0 + i < n && v0 + 32 * j < nv) hit |= Ids::eq(x[i][j], tgt);
  }
  return hit;
}

// MAXR: the most rows a block of this build takes (16, or 32 for the
// tuned grids that ask for 32), which bounds its registers a thread.
template <bool VEC, int MAXR>
__global__ void __launch_bounds__(MAXR * 32)
fused_contains_kernel(const int32_t* __restrict__ ids_flat,  // [R, C]
                      const int32_t* __restrict__ fb,        // [r, P]
                      const int32_t* __restrict__ meta,      // [r, 2]
                      uint8_t* __restrict__ out,             // bool [r]
                      int r, int n_rows, int c, int n_probes) {
  __shared__ int bucket[MAXR][32];  // each warp's valid probes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= r) return;  // whole warp
  const int pw = __ldg(meta + 2 * row), tgt = __ldg(meta + 2 * row + 1);
  const int f = lane < n_probes ? __ldg(fb + row * n_probes + lane) : 0;
  const bool valid = lane < n_probes && ((pw >> lane) & 1);
  const unsigned vmask = __ballot_sync(FULL_MASK, valid);
  const int n = __popc(vmask);
  if (valid)
    bucket[warp][__popc(vmask & ((1u << lane) - 1))] =
        min(max(f, 0), n_rows - 1);
  __syncwarp();
  const int nv = VEC ? c >> 2 : c;  // loads along a bucket row
  int hit = n > 0 ? fc_scan<VEC, 1>(ids_flat, bucket[warp], 0, n, nv, c,
                                    lane, tgt)
                  : 0;
  for (int k0 = 1; k0 < n && !__any_sync(FULL_MASK, hit); k0 += FC_PROBES)
    hit = fc_scan<VEC, FC_PROBES>(ids_flat, bucket[warp], k0, n, nv, c, lane,
                                  tgt);
  hit = __any_sync(FULL_MASK, hit);
  if (lane == 0) out[row] = hit ? 1 : 0;
}

static int fq_smem_limit[4][SMEM_MAX_DEVICES];
static int fq_score_blocks[SMEM_MAX_DEVICES];

// Blocks of the persistent score kernel that the device holds at once.
static int score_grid(size_t smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= SMEM_MAX_DEVICES) return 0;
  if (fq_score_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)fq_score_dot, FQ_SCORE_THREADS, smem);
    fq_score_blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return fq_score_blocks[dev];
}

// The kernels of one fused_query call after the grouping.  Dot (`ws` the
// grouping of fused_query_group_*, `scores` pair_cap * c floats with
// pair_cap >= n_pairs): the score pass over the work items, then the
// selection of the single-pair rows and of the rest; the kernels read
// n_pairs and n_small from the grouping's counts, and the grids cover
// small_hi single-pair rows and r - small_lo others, where small_lo <=
// n_small <= small_hi.  Hamming (`ws` and `scores` null, no grouping):
// the selection alone, scoring the packed words in place, each select
// kernel walking all rows and keeping its own.
extern "C" int fused_query_launch(
    const void* ids_flat, const void* pay, const void* q, const void* fb,
    const void* meta, void* ws, void* scores, void* out_i, void* out_s,
    int r, int n_rows, int c, int dw, int n_probes, int m, int hamming,
    int pair_cap, int small_lo, int small_hi, void* stream) {
  if (n_probes > 31 || m < 1 || (small_hi > 0 && m > FQ_FAST_M) ||
      small_lo > small_hi || small_hi > r ||
      (hamming != 0) != (ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long k_alloc = (long long)n_probes * c;
  if (k_alloc >= FQ_NONE) return SMEM_TOO_LARGE;  // 16-bit positions
  const size_t score_smem = fq_score_smem(c, dw);
  int fit = hamming ? 0 : opt_in_smem((const void*)fq_score_dot,
                                      fq_smem_limit[0], score_smem);
  if (fit != 0) return fit;
  const bool fast = m <= FQ_FAST_M;
  size_t select_smem = 8 * (size_t)k_alloc;  // ids + 2 * k_alloc positions
  if (!fast) {  // + the sort keys of the bitonic sort
    long long t2 = 1;
    while (t2 < k_alloc) t2 <<= 1;
    select_smem += (size_t)t2 * sizeof(u64);
  }
  const void* select_fn = fast ? (const void*)fq_select<true>
                               : (const void*)fq_select<false>;
  fit = opt_in_smem(select_fn, fq_smem_limit[1 + fast], select_smem);
  if (fit != 0) return fit;
  const size_t small_smem = (size_t)FQ_SMALL_WARPS * 4 * small_words(c);
  fit = opt_in_smem((const void*)fq_select_small, fq_smem_limit[3],
                    small_smem);
  if (fit != 0) return fit;
  if (r == 0) return (int)cudaGetLastError();

  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ids = (const int32_t*)ids_flat;
  const int32_t *i_fb = (const int32_t*)fb, *i_meta = (const int32_t*)meta;
  const uint32_t* words = hamming ? (const uint32_t*)pay : nullptr;
  const uint32_t* q_words = hamming ? (const uint32_t*)q : nullptr;
  const int w = hamming ? dw : 0;
  const int32_t *row_ptr = nullptr, *row_order = nullptr, *n_small = nullptr;
  int n_big = r;
  if (!hamming) {
    const FqWs g = fq_ws(ws, r, n_probes, n_rows);
    row_ptr = g.row_ptr;
    row_order = g.row_order;
    n_small = g.tot + 1;
    n_big = r - small_lo;
    if (pair_cap > 0) {
      const int held = score_grid(score_smem);
      fq_score_dot<<<pair_cap < held ? pair_cap : held, FQ_SCORE_THREADS,
                     score_smem, st>>>(
          ids, (const float*)pay, (const float*)q, g.by_row, g.by_pair,
          g.by_bucket, g.item_start, g.tot, (float*)scores, c, dw);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  } else if (fast) {
    small_hi = r;  // each select kernel keeps its own rows
  }
  if (small_hi > 0) {
    fq_select_small<<<(small_hi + FQ_SMALL_WARPS - 1) / FQ_SMALL_WARPS,
                      FQ_SMALL_WARPS * 32, small_smem, st>>>(
        ids, (const float*)scores, words, q_words, i_fb, i_meta, row_ptr,
        row_order, n_small, (int32_t*)out_i, (float*)out_s, small_hi,
        n_rows, c, w, n_probes, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_big > 0) {
    if (fast)
      fq_select<true><<<n_big, FQ_SELECT_THREADS, select_smem, st>>>(
          ids, (const float*)scores, words, q_words, i_fb, i_meta, row_ptr,
          row_order, n_small, (int32_t*)out_i, (float*)out_s, 0, r, n_rows,
          c, w, n_probes, m, (int)k_alloc);
    else
      fq_select<false><<<n_big, FQ_SELECT_THREADS, select_smem, st>>>(
          ids, (const float*)scores, words, q_words, i_fb, i_meta, row_ptr,
          row_order, n_small, (int32_t*)out_i, (float*)out_s, 0, r, n_rows,
          c, w, n_probes, m, (int)k_alloc);
  }
  return (int)cudaGetLastError();
}

// `rows` rows a block, a warp each (`fused_query.contains_grid`).
extern "C" int fused_contains_launch(const void* ids_flat, const void* fb,
                                     const void* meta, void* out, int r,
                                     int n_rows, int c, int n_probes,
                                     int rows, void* stream) {
  if (n_probes > 31 || n_rows < 1 || c < 1 || rows < 1 ||
      rows > 2 * FC_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaGetLastError();
  const int32_t *ids = (const int32_t*)ids_flat, *i_fb = (const int32_t*)fb,
                *i_meta = (const int32_t*)meta;
  uint8_t* hit = (uint8_t*)out;
  const int blocks = (int)(((long long)r + rows - 1) / rows);
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = c % 4 == 0 && (uintptr_t)ids % 16 == 0;
#define FC_GO(V, R)                                      \
  fused_contains_kernel<V, R><<<blocks, rows * 32, 0, st>>>( \
      ids, i_fb, i_meta, hit, r, n_rows, c, n_probes)
  if (rows <= FC_MAX_ROWS) {
    if (vec) FC_GO(true, FC_MAX_ROWS);
    else FC_GO(false, FC_MAX_ROWS);
  } else {
    if (vec) FC_GO(true, 2 * FC_MAX_ROWS);
    else FC_GO(false, 2 * FC_MAX_ROWS);
  }
#undef FC_GO
  return (int)cudaGetLastError();
}
