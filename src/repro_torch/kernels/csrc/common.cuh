// Helpers shared by the port's kernels (cmetric_fold.cu, tag_hist.cu).
//
// build.py keys each library's file name on this header as well as on its
// source, so an edit here rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gapp {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A shared-memory pointer as the 32-bit address PTX's shared space takes.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(kFullMask, v, o);
    if (lane_id() >= o) v += u;
  }
  return v;
}

// Four consecutive items from p[base:base+4], as one 16-byte load when vec
// is set (every pointer 16-byte aligned) and all four lie below e; items
// at or past e read as fill.
template <typename V, typename T>
__device__ __forceinline__ void load4(const T* p, int64_t base, int64_t e,
                                      int vec, T fill, T (&x)[4]) {
  if (vec && base + 4 <= e) {
    const V v = *reinterpret_cast<const V*>(p + base);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = base + j < e ? p[base + j] : fill;
  }
}

template <typename V, typename T>
__device__ __forceinline__ void store4(T* p, int64_t base, int64_t e, int vec,
                                       const T (&x)[4]) {
  if (vec && base + 4 <= e) {
    V v;
    v.x = x[0]; v.y = x[1]; v.z = x[2]; v.w = x[3];
    *reinterpret_cast<V*>(p + base) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < e) p[base + j] = x[j];
  }
}

}  // namespace gapp

#define GAPP_LAUNCH_CHECK()                      \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)
