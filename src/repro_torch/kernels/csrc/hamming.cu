// hamming: popcount Hamming distance of packed sketch words.
//
// Replaces the TPU kernels src/repro/kernels/hamming.py::
// hamming_words_pallas (_hamming_words_kernel) and ::hamming_pallas
// (_hamming_kernel):
//   hamming_words: out[n, kc] = sum_w popc(codes[n, w] ^ cand[n, kc, w]);
//   hamming:       out[n, kc] = popc(codes[n] ^ cand[n, kc]), the W = 1 case.
// Words travel as int32 bit patterns and are popcounted as uint32.
//
// Bound on the H100: bytes.  Each output reads W candidate words and
// writes one int32, for W popcounts and adds: well under one operation a
// byte.
//
// Design: the simple one.  A 2-D grid: blockIdx.y walks the rows, the
// threads of blockIdx.x walk a row's kc lanes, one thread per (row,
// lane).  Neighbouring threads read neighbouring candidate rows and write
// neighbouring outputs, and the row's W query words are read by every
// thread of the block at one address (a broadcast from the read-only
// cache), with no index division.

#include <cuda_runtime.h>
#include <stdint.h>

#define HM_THREADS 256
#define HM_MAX_GRID_Y 65535

// WC > 0: the word count is a compile-time constant (the main path's W = 2,
// and W = 1); WC == 0 reads it from `w`.
template <int WC>
__global__ void __launch_bounds__(HM_THREADS)
hamming_kernel(const uint32_t* __restrict__ codes,  // [n, W]
               const uint32_t* __restrict__ cand,   // [n, kc, W]
               int32_t* __restrict__ out,           // [n, kc]
               int n, int kc, int w) {
  const int W = WC > 0 ? WC : w;
  const int lane_stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.y; row < n; row += gridDim.y) {
    const uint32_t* q = codes + (long long)row * W;
    const long long base = (long long)row * kc;
    for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < kc;
         lane += lane_stride) {
      const uint32_t* c = cand + (base + lane) * W;
      int acc = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) acc += __popc(__ldg(q + j) ^ __ldg(c + j));
      out[base + lane] = acc;
    }
  }
}

static int hamming_launch_w(const void* codes, const void* cand, void* out,
                            int n, int kc, int w, void* stream) {
  if (n == 0 || kc == 0) return 0;
  const dim3 grid((kc + HM_THREADS - 1) / HM_THREADS,
                  n < HM_MAX_GRID_Y ? n : HM_MAX_GRID_Y);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* c = (const uint32_t*)codes;
  const uint32_t* k = (const uint32_t*)cand;
  int32_t* o = (int32_t*)out;
  if (w == 1)
    hamming_kernel<1><<<grid, HM_THREADS, 0, st>>>(c, k, o, n, kc, w);
  else if (w == 2)
    hamming_kernel<2><<<grid, HM_THREADS, 0, st>>>(c, k, o, n, kc, w);
  else
    hamming_kernel<0><<<grid, HM_THREADS, 0, st>>>(c, k, o, n, kc, w);
  return (int)cudaGetLastError();
}

// codes int32 [n, w], cand int32 [n, kc, w] -> out int32 [n, kc].
extern "C" int hamming_words_launch(const void* codes, const void* cand,
                                    void* out, int n, int kc, int w,
                                    void* stream) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  return hamming_launch_w(codes, cand, out, n, kc, w, stream);
}

// codes int32 [n], cand int32 [n, kc] -> out int32 [n, kc].
extern "C" int hamming_launch(const void* codes, const void* cand, void* out,
                              int n, int kc, void* stream) {
  return hamming_launch_w(codes, cand, out, n, kc, 1, stream);
}
