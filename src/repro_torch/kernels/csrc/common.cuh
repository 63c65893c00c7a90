// Helpers shared by the port's kernels (cmetric_fold.cu, tag_hist.cu,
// stream_scan.cu): warp scans, 16-byte loads and stores, and the decoupled
// look-back (Merrill & Garland) that the single-pass scans build on.
//
// build.py keys each library's file name on this header as well as on its
// source, so an edit here rebuilds them all.
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

// ---- decoupled look-back ---------------------------------------------------
//
// A block takes its tile from an atomic ticket, scans it, publishes the
// tile's aggregate, combines its predecessors' published aggregates up to
// the nearest inclusive prefix, and publishes its own inclusive prefix.
//
// A status word is one 64-bit value that says what it holds: first the
// tile's aggregate, then its inclusive prefix, carry included.  A float64
// sum keeps the state in its two lowest mantissa bits (a relative change
// below 2^-50); an int32 count sits in the high half, the state in the low
// one; a 62-bit key (unsigned long long) sits above the two state bits.  A
// word is read and written whole (relaxed 64-bit accesses at device
// scope), so a reader needs no ordering against any other memory.  Zero is
// "not yet".
enum : unsigned long long {
  kStatusInvalid = 0,
  kStatusAggregate = 1,
  kStatusInclusive = 2,
  kStatusMask = 3
};

__device__ __forceinline__ unsigned long long status_word(double v,
                                                          unsigned long long s) {
  return ((unsigned long long)__double_as_longlong(v) & ~kStatusMask) | s;
}

__device__ __forceinline__ unsigned long long status_word(unsigned v,
                                                          unsigned long long s) {
  return ((unsigned long long)v << 32) | s;
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long v,
                                                          unsigned long long s) {
  return (v << 2) | s;
}

template <typename T>
__device__ T word_value(unsigned long long w);

template <>
__device__ __forceinline__ double word_value<double>(unsigned long long w) {
  return __longlong_as_double((long long)(w & ~kStatusMask));
}

// Counts are summed as unsigned (wrapping) and read back as int32, so a
// negative count keeps its sign.
template <>
__device__ __forceinline__ unsigned word_value<unsigned>(unsigned long long w) {
  return (unsigned)(w >> 32);
}

template <>
__device__ __forceinline__ unsigned long long word_value<unsigned long long>(
    unsigned long long w) {
  return w >> 2;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// The block's tile: tiles are numbered in the order blocks start, so every
// tile a block waits for belongs to a block that is already running.
__device__ __forceinline__ int64_t take_tile(unsigned long long* ticket) {
  __shared__ int64_t s_tile;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(ticket), 1u);
  __syncthreads();
  return s_tile;
}

// The look-back's combining operators: a sum (identity 0) and, for keys
// that are never negative, a maximum (identity 0 as well).
struct SumOp {
  template <typename T>
  static __device__ __forceinline__ T apply(T a, T b) { return a + b; }
};

struct MaxOp {
  template <typename T>
  static __device__ __forceinline__ T apply(T a, T b) { return a > b ? a : b; }
};

// Wait until the tiles before `tile` have published enough to combine
// every item before it, on each of kChains chains whose words for tile p
// lie at words[kChains * p + x]; acc[x] receives chain x's prefix, carry
// included (the walk ends on an inclusive word, and tile 0's holds the
// carry).  Each lane reads one predecessor's words per step; the chains
// end independently.  Called by all 32 lanes of one warp.
template <typename T, int kChains, typename Op = SumOp>
__device__ __forceinline__ void look_back(int64_t tile,
                                          const unsigned long long* words,
                                          T (&acc)[kChains]) {
  const int lane = lane_id();
  bool open[kChains];
  int nopen = kChains;
#pragma unroll
  for (int x = 0; x < kChains; ++x) {
    acc[x] = T(0);
    open[x] = true;
  }
  for (int64_t pos = tile - 1; nopen > 0; pos -= 32) {
    const int64_t p = pos - lane;
    unsigned long long w[kChains];
    bool wait;
    do {
      wait = false;
#pragma unroll
      for (int x = 0; x < kChains; ++x) {
        w[x] = p >= 0 && open[x] ? load_status(words + kChains * p + x)
                                 : kStatusInclusive;
        wait |= (w[x] & kStatusMask) == kStatusInvalid;
      }
    } while (__any_sync(kFullMask, wait));
#pragma unroll
    for (int x = 0; x < kChains; ++x) {
      if (!open[x]) continue;  // the same for every lane
      const unsigned incl = __ballot_sync(
          kFullMask, (w[x] & kStatusMask) == kStatusInclusive && p >= 0);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      T v = lane <= stop && p >= 0 ? word_value<T>(w[x]) : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = Op::apply(v, __shfl_xor_sync(kFullMask, v, o));
      acc[x] = Op::apply(acc[x], v);
      if (incl) {
        open[x] = false;
        --nopen;
      }
    }
  }
}

}  // namespace gapp

#define GAPP_LAUNCH_CHECK()                      \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)
