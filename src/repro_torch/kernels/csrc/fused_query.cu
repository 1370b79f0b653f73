// fused_query / fused_contains: gather -> score -> dedup -> top-m of the
// probed buckets of one (query, table) row, in one kernel.
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
// Bound on the H100: bytes.  A row reads its valid probes' id rows
// (C*4 B each) and the payload rows of live slots only (D*4 B for dot,
// W*4 B for hamming); no [r, P*C] intermediate goes to device memory.
//
// Design: one block per row; the TPU grid (r/TB, P, TB) with scratch
// carried across grid steps becomes a loop over probes inside the block.
// The block keeps (id, score) of all P*C slots in shared memory (53 KB at
// P = 13, C = 512).  Dot payloads are read warp-per-slot with 16-byte
// loads of the 512 B row; hamming is thread-per-slot.  The TPU kernel
// dedups with a [K, K] equality cube, impossible at K = 6656; here dedup
// is lazy: each round takes the best (score, id, position) left; if that
// entry is not the first occurrence of its id, the round drops every
// later copy of the id and repeats, else it emits the entry and drops the
// id.  So a row costs (m + duplicates) block reductions over K, and the
// surviving score is always the first occurrence's.
//
// fused_contains: one warp per row ORs ids == target over the valid
// probes' id rows and reads no payload.  Bound: id-row bytes.

#include "common.cuh"

#define FQ_THREADS 256
#define FQ_MAX_PROBES 32

static size_t fused_query_smem(int n_probes, int c, int dw) {
  return (size_t)n_probes * c * (sizeof(int32_t) + sizeof(float)) +
         (size_t)dw * sizeof(float);
}

template <bool HAMMING>
__global__ void __launch_bounds__(FQ_THREADS)
fused_query_kernel(const int32_t* __restrict__ ids_flat,  // [R, C]
                   const void* __restrict__ pay,          // [R, C, DW]
                   const void* __restrict__ q,            // [r, DW]
                   const int32_t* __restrict__ fb,        // [r, P]
                   const int32_t* __restrict__ meta,      // [r, 2]
                   int32_t* __restrict__ out_i,           // [r, m]
                   float* __restrict__ out_s,             // [r, m]
                   int n_rows, int c, int dw, int n_probes, int m) {
  extern __shared__ unsigned char smem_raw[];
  const int K = n_probes * c;
  int32_t* cid = reinterpret_cast<int32_t*>(smem_raw);  // [K]
  float* csc = reinterpret_cast<float*>(cid + K);       // [K]
  float* q_s = csc + K;                                 // [DW]
  __shared__ long long row_s[FQ_MAX_PROBES];
  __shared__ Scratch sh;

  const int r = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int pw = meta[2 * r], excl = meta[2 * r + 1];
  if (tid < n_probes) {
    const int f = min(max(fb[(size_t)r * n_probes + tid], 0), n_rows - 1);
    row_s[tid] = (long long)f * c;  // first slot of the probed bucket row
  }
  for (int i = tid; i < dw; i += nthreads)  // bit copy: f32 or words
    reinterpret_cast<uint32_t*>(q_s)[i] =
        reinterpret_cast<const uint32_t*>(q)[(size_t)r * dw + i];
  __syncthreads();

  // candidate ids: probe validity, EMPTY and the exclude id in one pass
  for (int i = tid; i < K; i += nthreads) {
    const int p = i / c;
    int id = -1;
    if ((pw >> p) & 1) {
      const int v = ids_flat[row_s[p] + (i - p * c)];
      if (v >= 0 && v != excl) id = v;
    }
    cid[i] = id;
  }
  __syncthreads();

  // scores of live slots only
  if (HAMMING) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(pay);
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q_s);
    for (int i = tid; i < K; i += nthreads) {
      float s = -CUDART_INF_F;
      if (cid[i] >= 0) {
        const int p = i / c;
        const uint32_t* row = words + (row_s[p] + (i - p * c)) * dw;
        int hd = 0;
        for (int w = 0; w < dw; ++w) hd += __popc(__ldg(row + w) ^ qw[w]);
        s = -(float)hd;
      }
      csc[i] = s;
    }
  } else {
    const float* vecs = reinterpret_cast<const float*>(pay);
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
    for (int i = warp; i < K; i += nwarps) {
      float s = -CUDART_INF_F;
      if (cid[i] >= 0) {
        const int p = i / c;
        s = warp_dot(vecs + (row_s[p] + (i - p * c)) * dw, q_s, dw);
      }
      if (lane == 0) csc[i] = s;
    }
  }
  __syncthreads();

  // selection with lazy first-occurrence dedup
  int emitted = 0;
  while (emitted < m) {
    float bs = -CUDART_INF_F;
    int bid = INT_MAX_, bpos = INT_MAX_;
    for (int i = tid; i < K; i += nthreads) {
      const int id = cid[i];
      if (id >= 0 && better(csc[i], id, i, bs, bid, bpos)) {
        bs = csc[i];
        bid = id;
        bpos = i;
      }
    }
    block_best(bs, bid, bpos, sh);
    if (bid == INT_MAX_ || bs == -CUDART_INF_F) break;  // nothing live left
    int first = INT_MAX_;
    for (int i = tid; i < K; i += nthreads)
      if (cid[i] == bid) first = min(first, i);
    first = block_min(first, sh);
    const bool emit = first == bpos;
    if (emit && tid == 0) {
      out_i[(size_t)r * m + emitted] = bid;
      out_s[(size_t)r * m + emitted] = bs;
    }
    // emit: drop every copy; else drop every copy but the first
    for (int i = tid; i < K; i += nthreads)
      if (cid[i] == bid && (emit || i != first)) cid[i] = -1;
    __syncthreads();
    emitted += emit;
  }
  for (int j = emitted + tid; j < m; j += nthreads) {
    out_i[(size_t)r * m + j] = -1;
    out_s[(size_t)r * m + j] = -CUDART_INF_F;
  }
}

#define FC_WARPS 8

__global__ void __launch_bounds__(FC_WARPS * 32)
fused_contains_kernel(const int32_t* __restrict__ ids_flat,  // [R, C]
                      const int32_t* __restrict__ fb,        // [r, P]
                      const int32_t* __restrict__ meta,      // [r, 2]
                      int32_t* __restrict__ out,             // [r]
                      int r, int n_rows, int c, int n_probes) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * FC_WARPS + (threadIdx.x >> 5);
  if (row >= r) return;  // whole warp
  const int pw = meta[2 * row], tgt = meta[2 * row + 1];
  int hit = 0;
  for (int p = 0; p < n_probes; ++p) {
    if (!((pw >> p) & 1)) continue;
    const int f = min(max(fb[row * n_probes + p], 0), n_rows - 1);
    const int32_t* ids = ids_flat + (size_t)f * c;
    for (int s = lane; s < c; s += 32) hit |= __ldg(ids + s) == tgt;
  }
  hit = __any_sync(FULL_MASK, hit);
  if (lane == 0) out[row] = hit;
}

static int fused_query_smem_limit[2][SMEM_MAX_DEVICES];

extern "C" int fused_query_launch(const void* ids_flat, const void* pay,
                                  const void* q, const void* fb,
                                  const void* meta, void* out_i, void* out_s,
                                  int r, int n_rows, int c, int dw,
                                  int n_probes, int m, int hamming,
                                  void* stream) {
  const size_t smem = fused_query_smem(n_probes, c, dw);
  const void* fn = hamming ? (const void*)fused_query_kernel<true>
                           : (const void*)fused_query_kernel<false>;
  const int fit = opt_in_smem(fn, fused_query_smem_limit[hamming != 0], smem);
  if (fit != 0) return fit;
  if (r == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ids = (const int32_t*)ids_flat;
  if (hamming)
    fused_query_kernel<true><<<r, FQ_THREADS, smem, st>>>(
        ids, pay, q, (const int32_t*)fb, (const int32_t*)meta,
        (int32_t*)out_i, (float*)out_s, n_rows, c, dw, n_probes, m);
  else
    fused_query_kernel<false><<<r, FQ_THREADS, smem, st>>>(
        ids, pay, q, (const int32_t*)fb, (const int32_t*)meta,
        (int32_t*)out_i, (float*)out_s, n_rows, c, dw, n_probes, m);
  return (int)cudaGetLastError();
}

extern "C" int fused_contains_launch(const void* ids_flat, const void* fb,
                                     const void* meta, void* out, int r,
                                     int n_rows, int c, int n_probes,
                                     void* stream) {
  const int grid = (r + FC_WARPS - 1) / FC_WARPS;
  if (grid > 0)
    fused_contains_kernel<<<grid, FC_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids_flat, (const int32_t*)fb, (const int32_t*)meta,
        (int32_t*)out, r, n_rows, c, n_probes);
  return (int)cudaGetLastError();
}
