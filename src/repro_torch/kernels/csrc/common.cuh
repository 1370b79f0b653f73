// Helpers shared by the kernels: the reduce-scatter of a warp, and for
// the top-m selections the candidate order, per-warp sorted lists, and
// sort keys with a block bitonic sort.
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

// One round of a warp's reduce-scatter over acc[0, CNT): a lane keeps the
// half that its bit OFF names, in acc[0, CNT/2), and adds its partner's
// copy of that half.  Rounds OFF = 16, 8, ... from CNT = 2 * OFF * c
// leave c values on each lane, each summed over the warp: after rounds
// down to OFF = 1, lane l holds slots c*l .. c*l + c - 1.
template <int CNT, int OFF, int N>
__device__ __forceinline__ void reduce_half(float (&acc)[N], int lane) {
  static_assert(CNT <= N, "reduce_half: too few values");
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < CNT / 2; ++i) {
    const float keep = upper ? acc[i + CNT / 2] : acc[i];
    const float give = upper ? acc[i] : acc[i + CNT / 2];
    acc[i] = keep + __shfl_xor_sync(FULL_MASK, give, OFF);
  }
}

// A candidate of a top-m selection.
struct Entry {
  float s;
  int id, pos;
};

__device__ __forceinline__ Entry no_entry() {
  return Entry{-CUDART_INF_F, INT_MAX_, INT_MAX_};
}

__device__ __forceinline__ bool ahead(const Entry& a, const Entry& b) {
  return better(a.s, a.id, a.pos, b.s, b.id, b.pos);
}

__device__ __forceinline__ Entry shfl(const Entry& e, int src) {
  return Entry{__shfl_sync(FULL_MASK, e.s, src),
               __shfl_sync(FULL_MASK, e.id, src),
               __shfl_sync(FULL_MASK, e.pos, src)};
}

// Entry i on lane i < m, best first; `mth` the m-th best and `floor` a
// bound no entry below which can be among the row's best m (both on
// every lane).
struct WarpList {
  Entry e, mth, floor;
};

__device__ __forceinline__ WarpList empty_list() {
  return WarpList{no_entry(), no_entry(), no_entry()};
}

// Insert c, held by every lane, into the list (order `better`: score
// desc, then id, then position).
__device__ __forceinline__ void list_insert(WarpList& l, const Entry& c,
                                            int m, int lane) {
  if (!ahead(c, l.mth)) return;  // warp-uniform
  const int p = __popc(__ballot_sync(FULL_MASK, lane < m && ahead(l.e, c)));
  const Entry up = Entry{__shfl_up_sync(FULL_MASK, l.e.s, 1),
                         __shfl_up_sync(FULL_MASK, l.e.id, 1),
                         __shfl_up_sync(FULL_MASK, l.e.pos, 1)};
  if (lane > p)
    l.e = up;
  else if (lane == p)
    l.e = c;
  l.mth = shfl(l.e, m - 1);
}

// Each lane offers one entry (s = -inf: none); those at or above the
// floor and above the list's m-th best enter it one by one.
__device__ __forceinline__ void list_offer(WarpList& l, const Entry& c,
                                           int m, int lane) {
  unsigned bal = __ballot_sync(FULL_MASK, c.s > -CUDART_INF_F &&
                                              !ahead(l.floor, c) &&
                                              ahead(c, l.mth));
  while (bal) {
    const int src = __ffs(bal) - 1;
    bal &= bal - 1;
    list_insert(l, shfl(c, src), m, lane);
  }
}

typedef unsigned long long u64;
#define KEY_NONE 0xffffffffffffffffull  // sorts after every key

// u64 sort key, ascending = (score desc, id asc)
__device__ __forceinline__ u64 sort_key(float s, int id) {
  const unsigned b = __float_as_uint(s);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)(~o) << 32) | (unsigned)id;
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned o = ~(unsigned)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Sort keys[0, t2) ascending, t2 a power of 2, with every thread of the
// block; ends with __syncthreads().
__device__ __forceinline__ void block_sort(u64* keys, unsigned t2) {
  for (unsigned kk = 2; kk <= t2; kk <<= 1) {
    for (unsigned j = kk >> 1; j > 0; j >>= 1) {
      for (unsigned i = threadIdx.x; i < t2; i += blockDim.x) {
        const unsigned o = i ^ j;
        if (o > i) {
          const u64 a = keys[i], bb = keys[o];
          if ((a > bb) == ((i & kk) == 0)) {
            keys[i] = bb;
            keys[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}
