// CMetric interval fold and carry-seeded prefix, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package's kernels/cmetric_fold.py:
//   _fold_kernel   (wrapper fold)         -> gapp_fold
//   _cumsum_kernel (wrapper carry_cumsum) -> gapp_carry_cumsum
//
// The TPU kernels carry the running prefix from one grid step to the next
// in VMEM scratch, which relies on the TPU running its grid in order.  CUDA
// blocks run concurrently, so both kernels here are one pass with Merrill &
// Garland's decoupled look-back: a block takes its tile from an atomic
// ticket, scans it, publishes the tile's aggregate, sums its predecessors'
// published aggregates or the nearest inclusive prefix, and publishes its
// own inclusive prefix.  One memset (the status words and the ticket) and
// one launch per call.
//
// The fold chains two look-backs: a tile's contributions dt / n need the
// active count coming into the tile.  It scans its deltas, publishes the
// tile's count aggregate at once, looks back over the count words, forms
// n and the contributions, and only then scans and looks back over the
// (contrib, idle) words.  Publishing the count aggregate before any
// look-back keeps the count chain short for the tiles behind it.
//
// The count is int32 (the TPU kept it in f32).  Sums are float32 within a
// tile (a warp's 512 events, then the tile's 16 warps) and float64 across
// tiles: the error is that of one 8,192-event float32 scan plus the final
// rounding, not that of a 2^24-term float32 chain.
//
// Bound: memory.  fold must read dt (f32) and deltas (i32) and write n (i32)
// and gcm (f32), 16 bytes per event, and moves 16, plus 24 bytes of status
// per 8,192-event tile.  carry_cumsum must move 12 bytes per event
// (contrib, idle_contrib, g) and moves 12, plus 16 bytes of status per
// tile.  Loads and stores are 16 bytes per thread, neighbouring threads on
// neighbouring addresses.  The fold's tile waits out its look-backs in
// shared memory rather than in registers, which lets three blocks share an
// SM instead of two.
//
// Plain C interface for ctypes.  Every launch goes on the caller's stream;
// each function returns the first launch error (cudaSuccess == 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using gapp::kFullMask;
using gapp::kStatusAggregate;
using gapp::kStatusInclusive;
using gapp::lane_id;
using gapp::load4;
using gapp::look_back;
using gapp::status_word;
using gapp::store4;
using gapp::store_status;
using gapp::take_tile;
using gapp::warp_inclusive;

// A tile is 8,192 events: 16 warps of 512.  Lane l of a warp holds, for
// each of its four 16-byte vectors j, the events warp_base + 128 j + 4 l +
// q, so every load instruction of the warp reads 512 contiguous bytes.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                          // 16-byte vectors per array
constexpr int kWarpSpan = 32 * 4 * kVecs;         // 512 events
constexpr int kTile = kWarps * kWarpSpan;         // 8,192 events

// The carried scan state: read from the device when dev is set (a carry
// returned by an earlier call stays there), else passed by value.
struct Carry {
  const float* dev;
  float v[3];
  __device__ __forceinline__ float operator[](int i) const {
    return dev ? dev[i] : v[i];
  }
};

// The interval's share of global_cm: dt / n while workers are active.
__device__ __forceinline__ float contrib_of(float dt, int n) {
  return n > 0 ? dt / (float)n : 0.f;
}

// One vector of a warp's scan: x (this lane's four events of vector j of
// the layout above) becomes its prefix within the warp, inclusive or
// exclusive, and *run (the warp's sum over the vectors before j) grows by
// the vector's warp total.
template <bool kExclusive, typename T>
__device__ __forceinline__ void warp_scan_step(T (&x)[4], T* run) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T v = x[q];
    x[q] = kExclusive ? s : s + v;
    s += v;
  }
  const T wi = warp_inclusive(s);
  T ex = __shfl_up_sync(kFullMask, wi, 1);
  if (lane_id() == 0) ex = T(0);
  const T base = *run + ex;
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] += base;
  *run += __shfl_sync(kFullMask, wi, 31);
}

// The tile's (contrib, idle) sums from each warp's totals (held by lane
// 31), and the offset of this thread's warp within the tile.  Ends with the
// barrier that makes the totals visible to every warp.
__device__ __forceinline__ void tile_sums(float wc, float wi, float* woff,
                                          float* ctot, float* itot) {
  __shared__ float s_c[kWarps], s_i[kWarps];
  const int warp = threadIdx.x >> 5;
  if (lane_id() == 31) {
    s_c[warp] = wc;
    s_i[warp] = wi;
  }
  __syncthreads();
  float c = 0.f, i = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k == warp) *woff = c;
    c += s_c[k];
    i += s_i[k];
  }
  *ctot = c;
  *itot = i;
}

// Warp 0's publication of a tile's float64 (contrib, idle) sums on the
// chain at words (two a tile): the aggregate, the look-back, the inclusive
// prefix.  Returns the prefix before the tile (every lane of warp 0).
__device__ __forceinline__ void publish_sums(int64_t tile,
                                             unsigned long long* words,
                                             double ctot, double itot,
                                             double (&pre)[2]) {
  if (tile > 0) {
    if (lane_id() == 0) {
      store_status(words + 2 * tile, status_word(ctot, kStatusAggregate));
      store_status(words + 2 * tile + 1, status_word(itot, kStatusAggregate));
    }
    look_back(tile, words, pre);
  }
  if (lane_id() == 0) {
    store_status(words + 2 * tile,
                 status_word(pre[0] + ctot, kStatusInclusive));
    store_status(words + 2 * tile + 1,
                 status_word(pre[1] + itot, kStatusInclusive));
  }
}

// ---- fold: one pass, two chained look-backs --------------------------------
//
// The tile waits in shared memory (dt, then deltas; 64 KB, dynamic),
// brought in by cp.async, so no register holds tile data across the two
// look-backs: 40 registers a thread and three blocks an SM, where tile data
// held in registers took 64 and allowed two.  Each thread reads back only
// the words it copied.  status: ntiles count words, then ntiles (contrib,
// idle) pairs, then the tile ticket.
constexpr int kFoldSmem = kTile * (int)(sizeof(float) + sizeof(int));

// p[i:i+4] to the shared words at s: one 16-byte asynchronous copy when
// vec is set and all four lie below e; items at or past e become 0.
template <typename T>
__device__ __forceinline__ void stage4(T* s, const T* p, int64_t i, int64_t e,
                                       int vec) {
  if (vec && i + 4 <= e) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     gapp::smem_addr(s)),
                 "l"(p + i)
                 : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = i + q < e ? p[i + q] : T(0);
  }
}

template <typename V, typename T>
__device__ __forceinline__ void smem_load4(const T* s, T (&x)[4]) {
  const V v = *reinterpret_cast<const V*>(s);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <typename V, typename T>
__device__ __forceinline__ void smem_store4(T* s, const T (&x)[4]) {
  V v;
  v.x = x[0]; v.y = x[1]; v.z = x[2]; v.w = x[3];
  *reinterpret_cast<V*>(s) = v;
}

__global__ void __launch_bounds__(kThreads, 3)
fold_lookback(const float* dt, const int* deltas, int64_t e, int vec,
              Carry carry0, int64_t ntiles, unsigned long long* status,
              int* n_out, float* gcm, float* scalars) {
  extern __shared__ __align__(16) unsigned char s_tile_data[];
  __shared__ int s_warp_n[kWarps];
  __shared__ int s_count;
  __shared__ double s_off;
  unsigned long long* count_words = status;
  unsigned long long* sum_words = status + ntiles;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int64_t tile = take_tile(status + 3 * ntiles);
  const int local = warp * kWarpSpan + lane * 4;
  const int64_t at = tile * kTile + local;
  const bool last = tile == ntiles - 1;
  // The tile in shared memory: dt, which becomes the contributions'
  // in-warp prefix, and the deltas, which become theirs.
  float* s_t = reinterpret_cast<float*>(s_tile_data) + local;
  int* s_d = reinterpret_cast<int*>(s_tile_data + kTile * sizeof(float)) +
             local;

  // Two copy groups: the deltas are scanned while dt is still in flight.
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    stage4(s_d + 128 * j, deltas, at + 128 * j, e, vec);
  asm volatile("cp.async.commit_group;" ::: "memory");
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    stage4(s_t + 128 * j, dt, at + 128 * j, e, vec);
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 1;" ::: "memory");

  // The count: the in-warp inclusive scan, the warps' offsets, and the
  // tile's aggregate published before the look-back.
  int wn = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int x[4];
    smem_load4<int4>(s_d + 128 * j, x);
    warp_scan_step<false>(x, &wn);
    smem_store4<int4>(s_d + 128 * j, x);
  }
  if (lane == 0) s_warp_n[warp] = wn;
  __syncthreads();
  int noff = 0, ntot = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k == warp) noff = ntot;
    ntot += s_warp_n[k];
  }
  if (warp == 0) {
    unsigned pre[1] = {(unsigned)__float2int_rz(carry0[0])};
    if (tile > 0) {
      if (lane == 0)
        store_status(count_words + tile,
                     status_word((unsigned)ntot, kStatusAggregate));
      look_back(tile, count_words, pre);
    }
    if (lane == 0) {
      const unsigned incl = pre[0] + (unsigned)ntot;
      store_status(count_words + tile, status_word(incl, kStatusInclusive));
      s_count = (int)pre[0];
      if (last) scalars[2] = (float)(int)incl;
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // n, the idle time, and the contributions' in-warp exclusive prefix.
  const int nbase = s_count + noff;
  float isum = 0.f, wc = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int n[4];
    float t[4];
    smem_load4<int4>(s_d + 128 * j, n);
    smem_load4<float4>(s_t + 128 * j, t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      n[q] += nbase;
      if (n[q] <= 0 && t[q] > 0.f) isum += t[q];
      t[q] = contrib_of(t[q], n[q]);
    }
    store4<int4>(n_out, at + 128 * j, e, vec, n);
    warp_scan_step<true>(t, &wc);
    smem_store4<float4>(s_t + 128 * j, t);
  }

  // gcm: the look-back over the (contrib, idle) sums.
  float woff, ctot, itot;
  tile_sums(wc, warp_inclusive(isum), &woff, &ctot, &itot);
  if (warp == 0) {
    double pre[2] = {(double)carry0[1], (double)carry0[2]};
    publish_sums(tile, sum_words, ctot, itot, pre);
    if (lane == 0) {
      s_off = pre[0];
      if (last) {
        scalars[0] = (float)(pre[0] + ctot);
        scalars[1] = (float)(pre[1] + itot);
      }
    }
  }
  __syncthreads();
  const double off = s_off;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    float g[4];
    smem_load4<float4>(s_t + 128 * j, g);
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = (float)(off + (double)(woff + g[q]));
    store4<float4>(gcm, at + 128 * j, e, vec, g);
  }
}

// ---- carry_cumsum: one pass, one look-back ---------------------------------
//
// status: ntiles (contrib, idle) pairs, then the tile ticket.
__global__ void __launch_bounds__(kThreads)
carry_cumsum_lookback(const float* contrib, const float* idle, int64_t e,
                      int vec, Carry carry0, int64_t ntiles,
                      unsigned long long* status, float* g, float* scalars) {
  __shared__ double s_off;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int64_t tile = take_tile(status + 2 * ntiles);
  const int64_t at = tile * kTile + warp * kWarpSpan + lane * 4;

  float c[kVecs][4], w[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    load4<float4>(contrib, at + 128 * j, e, vec, 0.f, c[j]);
    load4<float4>(idle, at + 128 * j, e, vec, 0.f, w[j]);
  }
  // In-warp inclusive scan of 512 events; c becomes the prefix.
  float wc = 0.f, isum = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    warp_scan_step<false>(c[j], &wc);
#pragma unroll
    for (int q = 0; q < 4; ++q) isum += w[j][q];
  }
  float woff, ctot, itot;
  tile_sums(wc, warp_inclusive(isum), &woff, &ctot, &itot);
  if (warp == 0) {
    double pre[2] = {(double)carry0[0], (double)carry0[1]};
    publish_sums(tile, status, ctot, itot, pre);
    if (lane == 0) {
      s_off = pre[0];
      if (tile == ntiles - 1) {
        scalars[0] = (float)(pre[0] + ctot);
        scalars[1] = (float)(pre[1] + itot);
      }
    }
  }
  __syncthreads();
  const double off = s_off;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = (float)(off + (double)(woff + c[j][q]));
    store4<float4>(g, at + 128 * j, e, vec, out);
  }
}

// The fold's 64 KB of dynamic shared memory is above the default limit of
// 48 KB: raise the kernel's limit once per device (racing threads at worst
// repeat the call).
cudaError_t allow_fold_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      fold_lookback, cudaFuncAttributeMaxDynamicSharedMemorySize, kFoldSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

// Events per tile: the wrappers size their status words with it.
int gapp_tile_size(void) { return kTile; }

// n[i] = count0 + sum(deltas[:i+1]); gcm[i] = gcm0 + sum(contrib[:i]) with
// contrib = dt / n where n > 0, else 0; idle = idle0 + sum(dt where n <= 0
// and dt > 0).  The carry (count0, gcm0, idle0) is float[3] on the device
// at carry_dev, or (c0, g0, i0) when carry_dev is null; scalars = (total_cm,
// idle, count) is float[3] on the device.  Scratch: status uint64[3 *
// ntiles + 1] (three status words a tile and the tile ticket), zeroed here
// on the stream.  vec: every pointer is 16-byte aligned.  One memset and
// one kernel launch.
int gapp_fold(const float* dt, const int* deltas, long long e,
              const float* carry_dev, float c0, float g0, float i0, int* n,
              float* gcm, float* scalars, unsigned long long* status, int vec,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Carry carry0 = {carry_dev, {c0, g0, i0}};
  const long long ntiles = (e + kTile - 1) / kTile;
  cudaError_t err = allow_fold_smem();
  if (err == cudaSuccess)
    err = cudaMemsetAsync(
        status, 0, sizeof(unsigned long long) * (size_t)(3 * ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  fold_lookback<<<(unsigned)ntiles, kThreads, kFoldSmem, s>>>(
      dt, deltas, e, vec, carry0, ntiles, status, n, gcm, scalars);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// g[i] = gcm0 + sum(contrib[:i+1]); scalars = (g[-1], idle0 +
// sum(idle_contrib)).  The carry (gcm0, idle0) is float[2] on the device at
// carry_dev, or (g0, i0) when carry_dev is null.  Scratch: status
// uint64[2 * ntiles + 1] (two status words a tile and the tile ticket),
// zeroed here on the stream.  One memset and one kernel launch.
int gapp_carry_cumsum(const float* contrib, const float* idle_contrib,
                      long long e, const float* carry_dev, float g0, float i0,
                      float* g, float* scalars, unsigned long long* status,
                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Carry carry0 = {carry_dev, {g0, i0, 0.f}};
  const long long ntiles = (e + kTile - 1) / kTile;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(2 * ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  carry_cumsum_lookback<<<(unsigned)ntiles, kThreads, 0, s>>>(
      contrib, idle_contrib, e, vec, carry0, ntiles, status, g, scalars);
  GAPP_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
