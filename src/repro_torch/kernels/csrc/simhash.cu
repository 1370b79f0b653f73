// simhash: fused sign-random-projection sketch, one pass.
//
// Replaces the TPU kernel src/repro/kernels/simhash.py::simhash_pallas
// (_simhash_kernel): codes = pack(sign(x @ H^T)), either per-table codes
// int32 [n, L] (bit j of table l) or dense packed words int32 [n, W],
// W = ceil(L*k/32), where global bit l*k + j lands in word (l*k+j)/32.
//
// Bound on the H100: reading x.  Per row it reads d*4 bytes and does
// 2*d*L*k fp32 operations; at d = 128, L*k = 48 that is 512 B against
// 12288 flops, 24 flops a byte, under the fp32 ridge of about 20 (67
// TFLOP/s over 3.35 TB/s) only by a little, so the kernel has to stream
// x once with many loads in flight, keep the projections on chip, and
// issue few shared-memory loads per FMA.
//
// Design: the product is IEEE fp32 on the CUDA cores (fmaf), never TF32
// tensor cores, whose 10-bit mantissa would flip sign bits of small
// projections.  A block stages all L*k hyperplanes once, transposed to
// [d, L*k padded to 12], then walks tiles of 128 rows of x (grid-stride,
// two blocks per SM).  A tile is copied to shared memory in rounds of 8
// float4 loads per thread, all issued before any is stored, into rows
// whose stride is an odd number of 16-byte chunks, so the float4 stores
// and the float4 reads below are free of bank conflicts.  A warp's work
// item is 64 rows x 12 hyperplanes: each lane holds 2 rows x 12
// accumulators and per 4 steps of d loads 2 float4 of x and 12 float4 of
// hyperplanes (the same for the whole warp, a broadcast) for 96 FMAs.
// The signs go to a byte tile in shared memory and the epilogue packs
// them, so only the codes leave the SM.

#include "common.cuh"

#define SH_TN 128            // rows of x per tile
#define SH_RPL 2             // rows per lane in a work item
#define SH_J 12              // hyperplanes per work item
#define SH_V 8               // loads in flight per thread while staging x
#define SH_THREADS 256
#define SH_BLOCKS_PER_SM 2

__host__ __device__ static inline int sh_lkp(int lk) {
  return (lk + SH_J - 1) / SH_J * SH_J;
}
__host__ __device__ static inline int sh_dpad(int d) { return (d + 3) & ~3; }
// row stride of the x tile: an odd number of 16-byte chunks past dpad(d)
__host__ __device__ static inline int sh_stride(int d) {
  return ((sh_dpad(d) / 4 + 1) | 1) * 4;
}

static size_t simhash_smem(int d, int lk) {
  return sizeof(float) * ((size_t)sh_dpad(d) * sh_lkp(lk) +
                          (size_t)SH_TN * sh_stride(d)) +
         (size_t)SH_TN * lk;
}

// VEC: d % 4 == 0 and x 16-byte aligned, so tiles are copied as float4.
template <bool VEC>
__global__ void __launch_bounds__(SH_THREADS, SH_BLOCKS_PER_SM)
simhash_kernel(const float* __restrict__ x,  // [n, d]
               const float* __restrict__ h,  // [L*k, d], table-major
               int32_t* __restrict__ out,    // [n, width]
               int n, int d, int k, int L, int packed) {
  extern __shared__ __align__(16) float smem[];
  const int lk = L * k, lkp = sh_lkp(lk), dp = sh_dpad(d), ds = sh_stride(d);
  float* h_t = smem;                     // [dp, lkp], zero past d and lk
  float* x_s = smem + (size_t)dp * lkp;  // [SH_TN, ds], zero in [d, dp)
  unsigned char* bits =
      reinterpret_cast<unsigned char*>(x_s + (size_t)SH_TN * ds);  // [TN, lk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int n_chunks = SH_TN / (32 * SH_RPL);
  const int n_items = n_chunks * (lkp / SH_J);
  const int width = packed ? (lk + 31) / 32 : L;
  const int n_tiles = (n + SH_TN - 1) / SH_TN;

  for (int i = tid; i < dp * lkp; i += nthreads) {
    const int j = i / dp, c = i - j * dp;  // coalesced reads of h
    h_t[c * lkp + j] = j < lk && c < d ? h[(size_t)j * d + c] : 0.f;
  }
  for (int i = tid; i < SH_TN * (dp - d); i += nthreads) {
    const int r = i / (dp - d);
    x_s[r * ds + d + (i - r * (dp - d))] = 0.f;
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * SH_TN;
    const int valid = (int)min((long long)SH_TN, (long long)n - row0);
    __syncthreads();  // h_t and pads written; the last tile's x_s read
    // rows past n are left stale: their codes are never written
    if (VEC) {
      const float4* src = reinterpret_cast<const float4*>(x + row0 * d);
      const int d4 = d >> 2, nv = valid * d4;
      for (int base = 0; base < nv; base += nthreads * SH_V) {
        float4 v[SH_V];
#pragma unroll
        for (int u = 0; u < SH_V; ++u) {
          const int e = base + u * nthreads + tid;
          v[u] = e < nv ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < SH_V; ++u) {
          const int e = base + u * nthreads + tid;
          if (e < nv) {
            const int r = e / d4;
            *reinterpret_cast<float4*>(x_s + r * ds + 4 * (e - r * d4)) = v[u];
          }
        }
      }
    } else {
      const float* src = x + row0 * d;
      const int ne = valid * d;
      for (int base = 0; base < ne; base += nthreads * SH_V) {
        float v[SH_V];
#pragma unroll
        for (int u = 0; u < SH_V; ++u) {
          const int e = base + u * nthreads + tid;
          v[u] = e < ne ? __ldg(src + e) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < SH_V; ++u) {
          const int e = base + u * nthreads + tid;
          if (e < ne) {
            const int r = e / d;
            x_s[r * ds + (e - r * d)] = v[u];
          }
        }
      }
    }
    __syncthreads();

    for (int it = warp; it < n_items; it += nwarps) {
      const int chunk = it % n_chunks, g = it / n_chunks;
      const int rbase = chunk * 32 * SH_RPL + lane;  // rows rbase + 32*t
      const float* hg = h_t + g * SH_J;
      float acc[SH_RPL][SH_J];
#pragma unroll
      for (int t = 0; t < SH_RPL; ++t)
#pragma unroll
        for (int j = 0; j < SH_J; ++j) acc[t][j] = 0.f;
      for (int c = 0; c < dp; c += 4) {
        float4 xv[SH_RPL];
#pragma unroll
        for (int t = 0; t < SH_RPL; ++t)
          xv[t] = *reinterpret_cast<const float4*>(
              x_s + (rbase + 32 * t) * ds + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4* hp = reinterpret_cast<const float4*>(hg + (c + cc) * lkp);
          const float4 h0 = hp[0], h1 = hp[1], h2 = hp[2];
          const float hv[SH_J] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y,
                                  h1.z, h1.w, h2.x, h2.y, h2.z, h2.w};
#pragma unroll
          for (int t = 0; t < SH_RPL; ++t) {
            const float xs = cc == 0 ? xv[t].x
                           : cc == 1 ? xv[t].y
                           : cc == 2 ? xv[t].z : xv[t].w;
#pragma unroll
            for (int j = 0; j < SH_J; ++j)
              acc[t][j] = fmaf(xs, hv[j], acc[t][j]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < SH_RPL; ++t)
#pragma unroll
        for (int j = 0; j < SH_J; ++j)
          if (g * SH_J + j < lk)
            bits[(rbase + 32 * t) * lk + g * SH_J + j] = acc[t][j] >= 0.f;
    }
    __syncthreads();

    for (int i = tid; i < SH_TN * width; i += nthreads) {
      const int r = i / width, w = i - r * width;
      if (r >= valid) continue;
      const unsigned char* br = bits + r * lk;
      uint32_t v = 0;
      if (packed) {
        const int g0 = w * 32, g1 = min(g0 + 32, lk);
        for (int g = g0; g < g1; ++g) v |= (uint32_t)br[g] << (g - g0);
      } else {
        for (int j = 0; j < k; ++j) v |= (uint32_t)br[w * k + j] << j;
      }
      out[(row0 + r) * width + w] = (int32_t)v;
    }
  }
}

static int simhash_smem_limit[2][SMEM_MAX_DEVICES];
static int simhash_sms[SMEM_MAX_DEVICES];

extern "C" int simhash_launch(const void* x, const void* h, void* out, int n,
                              int d, int k, int L, int packed, void* stream) {
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const void* fn = vec ? (const void*)simhash_kernel<true>
                       : (const void*)simhash_kernel<false>;
  const size_t smem = simhash_smem(d, L * k);
  const int fit = opt_in_smem(fn, simhash_smem_limit[vec], smem);
  if (fit != 0) return fit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (simhash_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&simhash_sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (n + SH_TN - 1) / SH_TN;
  const int resident = SH_BLOCKS_PER_SM * simhash_sms[dev];
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    simhash_kernel<true><<<grid, SH_THREADS, smem, st>>>(
        (const float*)x, (const float*)h, (int32_t*)out, n, d, k, L, packed);
  else
    simhash_kernel<false><<<grid, SH_THREADS, smem, st>>>(
        (const float*)x, (const float*)h, (int32_t*)out, n, d, k, L, packed);
  return (int)cudaGetLastError();
}
