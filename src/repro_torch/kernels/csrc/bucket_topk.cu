// bucket_topk: score a query's gathered candidates and keep the top m.
//
// Replaces the TPU kernel src/repro/kernels/bucket_topk.py::
// bucket_topk_pallas (_topk_kernel): scores cand[b, KC, D] . q[b, D]; a
// lane whose bit is clear in the validity words (bit i of word w = lane
// w*32 + i) scores -inf; m rounds of (max score, min index) select the
// top m, -1 where no valid lane is left.
//
// Bound on the H100: bytes, reading the valid rows of cand (D*4 B each);
// the products are 2 flops a byte, far under any compute roof.
//
// Design: one block per query, warp per candidate with 16-byte loads of
// the 512 B row (rows of invalid lanes are never read); the KC scores sit
// in dynamic shared memory (104 KB at KC = 26624) and never reach device
// memory; selection is m block-wide (max score, min index) reductions.

#include "common.cuh"

#define BT_THREADS 512

static size_t bucket_topk_smem(int kc, int d) {
  return ((size_t)kc + d) * sizeof(float);
}

__global__ void __launch_bounds__(BT_THREADS)
bucket_topk_kernel(const float* __restrict__ q,         // [b, d]
                   const float* __restrict__ cand,      // [b, kc, d]
                   const uint32_t* __restrict__ vwords, // [b, nw]
                   float* __restrict__ out_s,           // [b, m]
                   int32_t* __restrict__ out_i,         // [b, m]
                   int kc, int d, int nw, int m) {
  extern __shared__ float smem[];
  float* sc = smem;        // [kc]
  float* q_s = smem + kc;  // [d]
  __shared__ Scratch sh;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;

  for (int i = tid; i < d; i += nthreads) q_s[i] = q[b * d + i];
  __syncthreads();

  const float* cb = cand + b * kc * d;
  const uint32_t* vw = vwords + b * nw;
  for (int c = warp; c < kc; c += nwarps) {
    float s = -CUDART_INF_F;
    if ((__ldg(vw + (c >> 5)) >> (c & 31)) & 1u)
      s = warp_dot(cb + (long long)c * d, q_s, d);
    if (lane == 0) sc[c] = s;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    float bs = -CUDART_INF_F;
    int bi = INT_MAX_, unused = 0;
    for (int c = tid; c < kc; c += nthreads)
      if (better(sc[c], c, 0, bs, bi, 0)) {
        bs = sc[c];
        bi = c;
      }
    block_best(bs, bi, unused, sh);
    const bool dead = bi == INT_MAX_ || bs == -CUDART_INF_F;
    if (tid == 0) {
      out_s[b * m + j] = dead ? -CUDART_INF_F : bs;
      out_i[b * m + j] = dead ? -1 : bi;
      if (!dead) sc[bi] = -CUDART_INF_F;
    }
    __syncthreads();
  }
}

static int bucket_topk_smem_limit[SMEM_MAX_DEVICES];

extern "C" int bucket_topk_launch(const void* q, const void* cand,
                                  const void* vwords, void* out_s,
                                  void* out_i, int b, int kc, int d, int nw,
                                  int m, void* stream) {
  const size_t smem = bucket_topk_smem(kc, d);
  const int fit = opt_in_smem((const void*)bucket_topk_kernel,
                              bucket_topk_smem_limit, smem);
  if (fit != 0) return fit;
  if (b > 0)
    bucket_topk_kernel<<<b, BT_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)cand, (const uint32_t*)vwords,
        (float*)out_s, (int32_t*)out_i, kc, d, nw, m);
  return (int)cudaGetLastError();
}
