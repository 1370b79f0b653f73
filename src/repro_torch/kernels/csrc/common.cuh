// Block-wide selection helpers shared by the top-m kernels.
//
// Every reduction leaves its result in all threads of the block and ends
// with __syncthreads(), so callers may reuse the scratch right away.  A
// block has at most 32 warps.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define INT_MAX_ 2147483647

// What a launcher returns, instead of a cudaError_t, when the shapes ask a
// block for more dynamic shared memory than the card allows.
#define SMEM_TOO_LARGE (-1)
#define SMEM_MAX_DEVICES 64

// Lets kernel `fn` take all the dynamic shared memory the current device
// allows a block (set once per device; `limit` is the kernel's own cache,
// zero-initialised) and says whether `smem` bytes fit: 0, SMEM_TOO_LARGE,
// or a cudaError_t.
static int opt_in_smem(const void* fn, int* limit, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= SMEM_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (limit[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    const int dyn = optin - (int)attr.sharedSizeBytes;  // less static smem
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = dyn;
  }
  return smem > (size_t)limit[dev] ? SMEM_TOO_LARGE : 0;
}

// Candidate order of every top-m selection here: higher score first, then
// lower id, then lower position.
__device__ __forceinline__ bool better(float s, int id, int pos,
                                       float bs, int bid, int bpos) {
  return s > bs || (s == bs && (id < bid || (id == bid && pos < bpos)));
}

struct Scratch {
  float s[32];
  int id[32];
  int pos[32];
};

__device__ __forceinline__ void warp_best(float& s, int& id, int& pos) {
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_xor_sync(FULL_MASK, s, off);
    int oid = __shfl_xor_sync(FULL_MASK, id, off);
    int opos = __shfl_xor_sync(FULL_MASK, pos, off);
    if (better(os, oid, opos, s, id, pos)) {
      s = os;
      id = oid;
      pos = opos;
    }
  }
}

// Block-wide best (score, id, pos) under `better`.
__device__ __forceinline__ void block_best(float& s, int& id, int& pos,
                                           Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_best(s, id, pos);
  if (lane == 0) {
    sh.s[warp] = s;
    sh.id[warp] = id;
    sh.pos[warp] = pos;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < nwarps ? sh.s[lane] : -CUDART_INF_F;
    id = lane < nwarps ? sh.id[lane] : INT_MAX_;
    pos = lane < nwarps ? sh.pos[lane] : INT_MAX_;
    warp_best(s, id, pos);
    if (lane == 0) {
      sh.s[0] = s;
      sh.id[0] = id;
      sh.pos[0] = pos;
    }
  }
  __syncthreads();
  s = sh.s[0];
  id = sh.id[0];
  pos = sh.pos[0];
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// Dot product of one f32 row with a query held in shared memory, by one
// warp: 16-byte loads when the width allows, else 4-byte ones.  Every
// lane returns the full sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ row,
                                          const float* q_s, int d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if ((d & 3) == 0) {
    for (int e = lane * 4; e < d; e += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + e));
      acc = fmaf(v.x, q_s[e], acc);
      acc = fmaf(v.y, q_s[e + 1], acc);
      acc = fmaf(v.z, q_s[e + 2], acc);
      acc = fmaf(v.w, q_s[e + 3], acc);
    }
  } else {
    for (int e = lane; e < d; e += 32) acc = fmaf(__ldg(row + e), q_s[e], acc);
  }
  return warp_sum(acc);
}
