// simhash: fused sign-random-projection sketch, one pass.
//
// Replaces the TPU kernel src/repro/kernels/simhash.py::simhash_pallas
// (_simhash_kernel): codes = pack(sign(x @ H^T)), either per-table codes
// int32 [n, L] (bit j of table l) or dense packed words int32 [n, W],
// W = ceil(L*k/32), where global bit l*k + j lands in word (l*k+j)/32.
//
// Bound on the H100.  At the 1.1 M-row corpus build, fp32 operations and
// reading x nearly tie: per row it reads d*4 bytes and does 2*d*L*k
// flops; at d = 128, L*k = 48 that is 512 B against 12288 flops, 24 a
// byte, just over the fp32 ridge of about 20 (67 TFLOP/s over 3.35
// TB/s).  There the FMA pipes must stay fed while x streams in, and
// shared memory, which hands each lane 4 bytes a cycle broadcast or
// not, must deliver fewer bytes than the FMAs consume.  At the 1024-query
// batch of a search the work is tiny: the bound is latency, so every SM
// needs a block and no warp may run a long serial chain.
//
// The product is IEEE fp32 on the CUDA cores (fmaf), never TF32 tensor
// cores, whose 10-bit mantissa would flip sign bits of small
// projections.  The host (kernels/simhash.py::grid) picks one of two
// kernels and its grid:
//
// simhash_stream_kernel (large n).  A block of 1-8 warps an SM; each warp
// walks its own 64-row (32 at mid n) chunks of x, grid-stride, in slices
// of 32 columns, through a private two-stage ring in shared memory that
// 16-byte cp.async (cg, zero fill past the edges) refills while the
// other stage is multiplied: no block barrier after the hyperplanes are
// staged.  A warp's lanes are HG hyperplane groups of 12 x 32/HG row
// groups, HG = 4 (a block holds at most 48 hyperplanes) or 2 (24, and
// twice the row groups; the host picks it, kernels/autotune.py); the
// hyperplanes past a block's last element are zero, and their bits are
// cut away on output.  At HG = 4 a lane holds 8 rows (4 in a 32-row
// chunk) x 12 hyperplanes, and per 4 columns loads 8 float4 of x and 12
// float4 of hyperplanes (one address per quarter-warp) for 384 FMAs: 1.2
// FMAs per delivered byte, against the SM's 128 FMAs and 128
// shared-memory bytes a cycle.  Ring rows are 128
// bytes with an XOR swizzle of their 16-byte chunks, so 8 rows read at
// once hit distinct banks.  At the end of a chunk each lane turns its 12
// signs per row into a mask in registers (shift-or), 3 shuffles gather a
// row's 12 * HG bits, and each lane cuts its elements out with 64-bit shifts
// and writes them.
//
// simhash_warp_kernel (small n, a search batch).  One warp a (4 rows, one
// code) or (2 rows, one packed word): lanes split d (a float4 each at
// d = 128), each lane keeps the 64 (row, hyperplane) partial dot products
// of its columns, a reduce-scatter of 62 shuffles leaves two full sums on
// each lane, and two ballots hold every sign bit.  No shared memory, no
// barrier, one round of loads: at 1024 queries the grid is a single wave.
//
// d % 4 != 0 or an x that is not 16-byte aligned takes plain 4-byte loads
// (in the stream kernel: staging without overlap).

#include "common.cuh"

#define SH_J 12           // hyperplanes a lane holds accumulators for
// a stream warp's hyperplane groups (HG) are 4 or 2: 48 or 24 a block
#define SH_THREADS 256    // a stream block, at most
#define SS_DC 32          // columns of a ring stage (128-byte rows)
#define SS_STAGES 2
#define SW_WARPS 4        // warps a block of the warp kernel

__host__ __device__ static inline int sh_dpad(int d) { return (d + 3) & ~3; }
// global hyperplane range [lo, hi) of output element e
__host__ __device__ static inline void sh_span(int e, int k, int lk,
                                               int packed, int& lo, int& hi) {
  lo = packed ? 32 * e : e * k;
  hi = packed ? (lo + 32 < lk ? lo + 32 : lk) : lo + k;
}
// groups of 12 hyperplanes the block of column split `cs_i` stages
__host__ __device__ static inline int sh_groups(int cs_i, int epb, int width,
                                                int k, int lk, int packed) {
  int lo, hi, lo2, hi2;
  sh_span(cs_i * epb, k, lk, packed, lo, hi);
  const int last = cs_i * epb + epb < width ? cs_i * epb + epb : width;
  sh_span(last - 1, k, lk, packed, lo2, hi2);
  return (hi2 - lo + SH_J - 1) / SH_J;
}

// Shared memory of a stream block of `hg` hyperplane groups;
// kernels/simhash.py::stream_smem_bytes mirrors it.
static size_t stream_smem(int d, int warps, int rows, int hg) {
  return sizeof(float) * ((size_t)sh_dpad(d) * SH_J * hg +
                          (size_t)warps * SS_STAGES * rows * SS_DC);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Hyperplanes [h0, h1) transposed into h_t [dp, hs], zero past h1 and d;
// the copies are left in flight (the caller commits and waits).
__device__ __forceinline__ void stage_h(float* h_t, const float* __restrict__ h,
                                        int h0, int h1, int d, int hs) {
  const int dp = sh_dpad(d);
  for (int i = threadIdx.x; i < dp * hs; i += blockDim.x) {
    const int j = i / dp, c = i - j * dp;  // coalesced reads of h
    if (h0 + j < h1 && c < d)
      cp_async4(h_t + c * hs + j, h + (size_t)(h0 + j) * d + c);
    else
      h_t[c * hs + j] = 0.f;
  }
}

// The element range of this block's column split and its hyperplanes.
__device__ __forceinline__ void block_span(int epb, int width, int k, int lk,
                                           int packed, int& e0, int& e1,
                                           int& h0, int& h1) {
  int unused;
  e0 = blockIdx.y * epb;
  e1 = min(width, e0 + epb);
  sh_span(e0, k, lk, packed, h0, unused);
  sh_span(e1 - 1, k, lk, packed, unused, h1);
}

// Write elements e0 + first, e0 + first + step, ... < e1 of one row from
// its hyperplane bits (bit j = hyperplane h0 + j).
__device__ __forceinline__ void write_row(int32_t* __restrict__ out_row,
                                          uint64_t bits, int e0, int e1,
                                          int first, int step, int k, int lk,
                                          int packed, int h0) {
  for (int e = e0 + first; e < e1; e += step) {
    int lo, hi;
    sh_span(e, k, lk, packed, lo, hi);
    out_row[e] = (int32_t)(uint32_t)((bits >> (lo - h0)) &
                                     ((1ull << (hi - lo)) - 1));
  }
}

// HG hyperplane groups x 32/HG row groups a warp, ROWS rows a chunk.
template <bool VEC, int ROWS, int HG>
__global__ void __launch_bounds__(SH_THREADS, 1)
simhash_stream_kernel(const float* __restrict__ x,  // [n, d]
                      const float* __restrict__ h,  // [L*k, d], table-major
                      int32_t* __restrict__ out,    // [n, width]
                      int n, int d, int k, int L, int packed, int epb) {
  constexpr int RG = 32 / HG, RPL = ROWS / RG, HS = SH_J * HG;
  static_assert(RG % 8 == 0, "the ring swizzle needs row groups of 8");
  constexpr int STAGE = ROWS * SS_DC;
  extern __shared__ __align__(16) float smem[];
  const int lk = L * k, width = packed ? (lk + 31) / 32 : L;
  int e0, e1, h0, h1;
  block_span(epb, width, k, lk, packed, e0, e1, h0, h1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int hq = lane / RG, rg = lane - hq * RG;
  float* h_t = smem;  // [dp, HS]
  float* ring =
      smem + (size_t)sh_dpad(d) * HS + (size_t)warp * SS_STAGES * STAGE;

  stage_h(h_t, h, h0, h1, d, HS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the only block barrier

  const int nd = (d + SS_DC - 1) / SS_DC;  // column slices a chunk
  const long long n_chunks = ((long long)n + ROWS - 1) / ROWS;
  const long long gw = (long long)blockIdx.x * nwarps + warp;
  const long long n_warps = (long long)gridDim.x * nwarps;
  const long long my_chunks =
      gw < n_chunks ? (n_chunks - gw + n_warps - 1) / n_warps : 0;
  const long long steps = my_chunks * nd;

  // step s = (chunk gw + (s / nd) * n_warps, column slice s % nd)
  auto issue = [&](long long s) {
    float* dst = ring + (int)(s % SS_STAGES) * STAGE;
    const long long row0 = (gw + s / nd * n_warps) * ROWS;
    const int col0 = (int)(s % nd) * SS_DC;
    if (VEC) {
      for (int q = lane; q < ROWS * SS_DC / 4; q += 32) {
        const int r = q >> 3, c4 = q & 7;
        const long long row = row0 + r;
        const int col = col0 + 4 * c4;
        const bool ok = row < n && col < d;
        cp_async16(dst + r * SS_DC + 4 * (c4 ^ (r & 7)),
                   ok ? x + row * d + col : x, ok ? 16 : 0);
      }
    } else {
      for (int q = lane; q < ROWS * SS_DC; q += 32) {
        const int r = q >> 5, c = q & 31;
        const long long row = row0 + r;
        const int col = col0 + c;
        dst[r * SS_DC + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)] =
            row < n && col < d ? __ldg(x + row * d + col) : 0.f;
      }
    }
  };

  for (int j = 0; j < SS_STAGES - 1; ++j) {
    if (j < steps) issue(j);
    cp_async_commit();
  }
  float acc[RPL][SH_J];
#pragma unroll
  for (int t = 0; t < RPL; ++t)
#pragma unroll
    for (int j = 0; j < SH_J; ++j) acc[t][j] = 0.f;
  const float* hq_t = h_t + hq * SH_J;
  // ring rows rg + RG*t all share (row & 7) == (rg & 7): one swizzle a lane
  const int swz = rg & 7;

  for (long long s = 0; s < steps; ++s) {
    if (s + SS_STAGES - 1 < steps) issue(s + SS_STAGES - 1);
    cp_async_commit();
    cp_async_wait<SS_STAGES - 1>();
    __syncwarp();  // every lane's copies of slice s have landed
    const float* st = ring + (int)(s % SS_STAGES) * STAGE;
    const int col0 = (int)(s % nd) * SS_DC;
    const int cols = min(SS_DC, sh_dpad(d) - col0);
    for (int c = 0; c < cols; c += 4) {
      float4 xv[RPL];
#pragma unroll
      for (int t = 0; t < RPL; ++t)
        xv[t] = *reinterpret_cast<const float4*>(
            st + (rg + RG * t) * SS_DC + 4 * ((c >> 2) ^ swz));
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4* hp =
            reinterpret_cast<const float4*>(hq_t + (col0 + c + cc) * HS);
        const float4 a = hp[0], b = hp[1], e = hp[2];
        const float hv[SH_J] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                b.z, b.w, e.x, e.y, e.z, e.w};
#pragma unroll
        for (int t = 0; t < RPL; ++t) {
          const float xc = cc == 0 ? xv[t].x
                         : cc == 1 ? xv[t].y
                         : cc == 2 ? xv[t].z : xv[t].w;
#pragma unroll
          for (int j = 0; j < SH_J; ++j)
            acc[t][j] = fmaf(xc, hv[j], acc[t][j]);
        }
      }
    }
    __syncwarp();  // slice s read before its stage is refilled

    if (s % nd == nd - 1) {  // the chunk's last slice: signs out
      const long long row0 = (gw + s / nd * n_warps) * ROWS;
#pragma unroll
      for (int t = 0; t < RPL; ++t) {
        uint32_t mask = 0;
#pragma unroll
        for (int j = 0; j < SH_J; ++j) {
          mask |= (uint32_t)(acc[t][j] >= 0.f) << j;
          acc[t][j] = 0.f;
        }
        uint64_t bits = 0;
#pragma unroll
        for (int q = 0; q < HG; ++q)
          bits |= (uint64_t)__shfl_sync(FULL_MASK, mask, q * RG + rg)
                  << (q * SH_J);
        const long long row = row0 + rg + RG * t;
        if (row < n)
          write_row(out + row * width, bits, e0, e1, hq, HG, k, lk, packed,
                    h0);
      }
    }
  }
  cp_async_wait<0>();
}

// NR rows x one output element a warp, NB = 64 / NR slots (hyperplanes)
// a row: 4 x 16 for codes of k <= 16, 2 x 32 for packed words.
template <bool VEC, int NR>
__global__ void __launch_bounds__(32 * SW_WARPS)
simhash_warp_kernel(const float* __restrict__ x,  // [n, d]
                    const float* __restrict__ h,  // [L*k, d], table-major
                    int32_t* __restrict__ out,    // [n, width]
                    int n, int d, int k, int L, int packed) {
  constexpr int NB = 64 / NR;
  const int lk = L * k, width = packed ? (lk + 31) / 32 : L;
  const int lane = threadIdx.x & 31;
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long row_blocks = ((long long)n + NR - 1) / NR;
  if (gw >= row_blocks * width) return;  // warp-uniform
  const long long row0 = gw / width * NR;
  const int e = (int)(gw % width);
  int lo, hi;
  sh_span(e, k, lk, packed, lo, hi);
  const int nb = hi - lo;  // <= NB
  const float* hr = h + (size_t)lo * d;
  const float* xr[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)  // rows past n read row n - 1, unwritten
    xr[r] = x + min(row0 + r, (long long)n - 1) * d;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // every load of a step is issued (predicated) before any FMA uses one:
  // a guarded load per hyperplane would wait out one round trip each
  if (VEC) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 4 * lane; c < d; c += 128) {
      float4 xv[NR], hv[NB];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        xv[r] = __ldg(reinterpret_cast<const float4*>(xr[r] + c));
#pragma unroll
      for (int j = 0; j < NB; ++j)
        hv[j] = j < nb ? __ldg(reinterpret_cast<const float4*>(
                             hr + (size_t)j * d + c))
                       : zero;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r * NB + j] =
              fmaf(xv[r].w, hv[j].w, fmaf(xv[r].z, hv[j].z,
              fmaf(xv[r].y, hv[j].y, fmaf(xv[r].x, hv[j].x, acc[r * NB + j]))));
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float xv[NR], hv[NB];
#pragma unroll
      for (int r = 0; r < NR; ++r) xv[r] = __ldg(xr[r] + c);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        hv[j] = j < nb ? __ldg(hr + (size_t)j * d + c) : 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r * NB + j] = fmaf(xv[r], hv[j], acc[r * NB + j]);
    }
  }
  // reduce-scatter: slots 2*lane and 2*lane + 1 summed over the warp
  reduce_half<64, 16>(acc, lane);
  reduce_half<32, 8>(acc, lane);
  reduce_half<16, 4>(acc, lane);
  reduce_half<8, 2>(acc, lane);
  reduce_half<4, 1>(acc, lane);
  // slot 2*lane + t is (row, hyperplane) = (2*lane / NB, 2*lane % NB + t)
  const uint32_t even = __ballot_sync(FULL_MASK, acc[0] >= 0.f);
  const uint32_t odd = __ballot_sync(FULL_MASK, acc[1] >= 0.f);
  if (lane < NR && row0 + lane < n) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      const int src = lane * (NB / 2) + i;
      v |= ((even >> src) & 1u) << (2 * i) | ((odd >> src) & 1u) << (2 * i + 1);
    }
    out[(row0 + lane) * width + e] =
        (int32_t)(nb == 32 ? v : v & ((1u << nb) - 1));
  }
}

static int simhash_smem_limit[8][SMEM_MAX_DEVICES];

template <typename... Params, typename... Args>
static int simhash_go(void (*fn)(Params...), int* limit, size_t smem,
                      dim3 grid, int threads, cudaStream_t st,
                      Args... args) {
  const int fit = opt_in_smem((const void*)fn, limit, smem);
  if (fit != 0) return fit;
  if (grid.x > 0) fn<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The grid comes from the host (kernels/simhash.py::grid).  The stream
// kernel: `warps` a block, `rows` rows a warp's chunk (64 or 32), `epb`
// output elements a block (a grid column each), `groups` hyperplane
// groups of 12 a block (4 or 2), `grid_rows` blocks along the rows.  The
// warp kernel
// (stream_mode 0): `rows` rows a warp (4, or 2 past 16 hyperplanes an
// element), SW_WARPS warps a block.
extern "C" int simhash_launch(const void* x, const void* h, void* out, int n,
                              int d, int k, int L, int packed,
                              int stream_mode, int warps, int rows, int epb,
                              int groups, int grid_rows, void* stream) {
  const int lk = L * k, width = packed ? (lk + 31) / 32 : L;
  if (k > 32 || n < 0) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const float *xf = (const float*)x, *hf = (const float*)h;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (!stream_mode) {
    int most = 0;  // hyperplanes of the widest element
    for (int e = 0; e < width; ++e) {
      int lo, hi;
      sh_span(e, k, lk, packed, lo, hi);
      most = hi - lo > most ? hi - lo : most;
    }
    const int nr = rows;  // a warp's rows: its 64 slots hold nr elements
    if ((nr != 2 && nr != 4) || most > 64 / nr)
      return (int)cudaErrorInvalidValue;
    const long long warps_all = ((long long)n + nr - 1) / nr * width;
    const unsigned blocks = (unsigned)((warps_all + SW_WARPS - 1) / SW_WARPS);
    if (blocks > 0) {
#define SH_WARP(V, R)                                                    \
  simhash_warp_kernel<V, R><<<blocks, 32 * SW_WARPS, 0, st>>>(       \
      xf, hf, o, n, d, k, L, packed)
      if (vec && nr == 4) SH_WARP(true, 4);
      else if (vec) SH_WARP(true, 2);
      else if (nr == 4) SH_WARP(false, 4);
      else SH_WARP(false, 2);
#undef SH_WARP
    }
    return (int)cudaGetLastError();
  }
  if (epb < 1 || grid_rows < 0 || warps < 1 || warps > SH_THREADS / 32)
    return (int)cudaErrorInvalidValue;
  const int col_splits = (width + epb - 1) / epb;
  int gmax = 1;
  for (int i = 0; i < col_splits; ++i) {
    const int gi = sh_groups(i, epb, width, k, lk, packed);
    gmax = gi > gmax ? gi : gmax;
  }
  if ((groups != 4 && groups != 2) || gmax > groups ||
      (rows != 64 && rows != 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(d, warps, rows, groups);
  const dim3 grid(grid_rows, col_splits);
  int* lim = simhash_smem_limit[(vec ? 4 : 0) + (rows == 64 ? 0 : 2) +
                                (groups == 4 ? 0 : 1)];
#define SH_STREAM(V, R, G)                                                  \
  return simhash_go(simhash_stream_kernel<V, R, G>, lim, smem, grid,        \
                    32 * warps, st, xf, hf, o, n, d, k, L, packed, epb)
#define SH_STREAM_G(V, R) \
  if (groups == 4) SH_STREAM(V, R, 4); \
  SH_STREAM(V, R, 2)
  if (vec) {
    if (rows == 64) { SH_STREAM_G(true, 64); }
    SH_STREAM_G(true, 32);
  }
  if (rows == 64) { SH_STREAM_G(false, 64); }
  SH_STREAM_G(false, 32);
#undef SH_STREAM_G
#undef SH_STREAM
}
