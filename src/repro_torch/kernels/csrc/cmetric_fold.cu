// CMetric interval fold and carry-seeded prefix, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package's kernels/cmetric_fold.py:
//   _fold_kernel   (wrapper fold)         -> gapp_fold
//   _cumsum_kernel (wrapper carry_cumsum) -> gapp_carry_cumsum
//
// The TPU kernels carry the running prefix from one grid step to the next
// in VMEM scratch, which relies on the TPU running its grid in order.  CUDA
// blocks run concurrently.
//
// gapp_fold is a multi-pass tiled scan: per-tile aggregates, one
// single-block scan of the aggregates, then a per-tile pass that applies
// the tile's offset.  The fold's contributions depend on the active count
// coming into a tile, so its integer count scan completes before any
// contribution is formed.
//
// gapp_carry_cumsum is one pass (Merrill & Garland's decoupled look-back):
// a block takes its tile from an atomic ticket, scans it, publishes the
// tile's aggregate, sums its predecessors' published aggregates or the
// nearest inclusive prefix, and publishes its own inclusive prefix.  One
// memset (the status words and the ticket) and one launch per call.
//
// Both carry the prefix across tiles in float64: the error is that of one
// tile's float32 scan plus the final rounding, not that of a 2^24-term
// float32 chain.
//
// Bound: memory.  fold must read dt (f32) and deltas (i32) and write n (i32)
// and gcm (f32), 16 bytes per event; this design moves 28 (deltas are read
// twice, n is written and read back).  carry_cumsum must move 12 bytes per
// event (contrib, idle_contrib, g) and moves 12, plus 16 bytes of status
// per 8,192-event tile.  Loads and stores are 16 bytes per thread,
// neighbouring threads on neighbouring addresses.
//
// Plain C interface for ctypes.  Every launch goes on the caller's stream;
// each function returns the first launch error (cudaSuccess == 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gapp::kFullMask;
using gapp::lane_id;
using gapp::load4;
using gapp::store4;
using gapp::warp_inclusive;

constexpr int kThreads = 512;             // threads of a tile block
constexpr int kItems = 4;                 // contiguous items per thread
constexpr int kTile = kThreads * kItems;  // events per tile
constexpr int kScanThreads = 1024;        // single-block scan of tile sums

// The carried scan state: read from the device when dev is set (a carry
// returned by an earlier call stays there), else passed by value.
struct Carry {
  const float* dev;
  float v[3];
  __device__ __forceinline__ float operator[](int i) const {
    return dev ? dev[i] : v[i];
  }
};

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32).  *total receives the block's sum.  smem holds 33 values;
// the trailing barrier lets the caller reuse it at once.
template <typename T>
__device__ T block_exclusive(T v, T* smem, T* total) {
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T incl = warp_inclusive(v);
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nwarps ? smem[lane] : T(0);
    const T wi = warp_inclusive(w);
    T we = __shfl_up_sync(0xffffffffu, wi, 1);
    if (lane == 0) we = T(0);
    smem[lane] = we;
    if (lane == 31) smem[32] = wi;
  }
  __syncthreads();
  const T out = smem[warp] + excl;
  *total = smem[32];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int64_t item_base() {
  return (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
}

// The interval's share of global_cm: dt / n while workers are active.
__device__ __forceinline__ float contrib_of(float dt, int n) {
  return n > 0 ? dt / (float)n : 0.f;
}

// ---- fold pass 1: per-tile sum of the deltas ------------------------------
__global__ void __launch_bounds__(kThreads)
fold_count_tiles(const int* deltas, int64_t e, int vec, int* tile_count) {
  __shared__ int smem[33];
  int d[kItems];
  load4<int4>(deltas, item_base(), e, vec, 0, d);
  int total;
  block_exclusive(d[0] + d[1] + d[2] + d[3], smem, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

// ---- fold pass 2: exclusive scan of the tile counts, seeded by the carry --
__global__ void __launch_bounds__(kScanThreads)
fold_scan_counts(const int* tile_count, int64_t ntiles, Carry carry0,
                 int* tile_count_off, float* count_out) {
  __shared__ int smem[33];
  int carry = __float2int_rz(carry0[0]);
  for (int64_t lo = 0; lo < ntiles; lo += blockDim.x) {
    const int64_t i = lo + threadIdx.x;
    int total;
    const int ex = block_exclusive(i < ntiles ? tile_count[i] : 0, smem,
                                   &total);
    if (i < ntiles) tile_count_off[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *count_out = (float)carry;
}

// ---- fold pass 3: n, and each tile's contribution and idle sums -----------
__global__ void __launch_bounds__(kThreads)
fold_tile_n(const float* dt, const int* deltas, int64_t e, int vec,
            const int* tile_count_off, int* n_out, double* tile_cm,
            double* tile_idle) {
  __shared__ int si[33];
  __shared__ float sf[33];
  const int64_t base = item_base();
  int d[kItems];
  float t[kItems];
  load4<int4>(deltas, base, e, vec, 0, d);
  load4<float4>(dt, base, e, vec, 0.f, t);
  int run[kItems];
  int s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += d[j];
    run[j] = s;
  }
  int itotal;
  const int off = tile_count_off[blockIdx.x] + block_exclusive(s, si, &itotal);
  int n[kItems];
  float csum = 0.f, isum = 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    n[j] = off + run[j];
    csum += contrib_of(t[j], n[j]);
    if (n[j] <= 0 && t[j] > 0.f) isum += t[j];
  }
  store4<int4>(n_out, base, e, vec, n);
  float ctot, itot;
  block_exclusive(csum, sf, &ctot);
  block_exclusive(isum, sf, &itot);
  if (threadIdx.x == 0) {
    tile_cm[blockIdx.x] = ctot;
    tile_idle[blockIdx.x] = itot;
  }
}

// ---- shared: float64 exclusive scan of the tile sums, plus the idle total -
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums(const double* tile_cm, const double* tile_idle, int64_t ntiles,
               Carry carry0, int gcm_at, int idle_at, double* tile_off,
               float* gcm_out, float* idle_out) {
  __shared__ double smem[33];
  double carry = (double)carry0[gcm_at];
  double idle = 0.0;
  for (int64_t lo = 0; lo < ntiles; lo += blockDim.x) {
    const int64_t i = lo + threadIdx.x;
    double total;
    const double ex = block_exclusive(i < ntiles ? tile_cm[i] : 0.0, smem,
                                      &total);
    if (i < ntiles) tile_off[i] = carry + ex;
    carry += total;
    block_exclusive(i < ntiles ? tile_idle[i] : 0.0, smem, &total);
    idle += total;
  }
  if (threadIdx.x == 0) {
    *gcm_out = (float)carry;
    *idle_out = (float)((double)carry0[idle_at] + idle);
  }
}

// ---- fold pass 5: gcm, the exclusive prefix of the contributions ----------
__global__ void __launch_bounds__(kThreads)
fold_tile_gcm(const float* dt, const int* n_in, int64_t e, int vec,
              const double* tile_off, float* gcm) {
  __shared__ float sf[33];
  const int64_t base = item_base();
  float t[kItems];
  int n[kItems];
  load4<float4>(dt, base, e, vec, 0.f, t);
  load4<int4>(n_in, base, e, vec, 0, n);
  float pre[kItems];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    pre[j] = s;
    s += contrib_of(t[j], n[j]);
  }
  float total;
  const float ex = block_exclusive(s, sf, &total);
  const double off = tile_off[blockIdx.x];
  float g[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) g[j] = (float)(off + (double)(ex + pre[j]));
  store4<float4>(gcm, base, e, vec, g);
}

// ---- carry_cumsum: one pass, decoupled look-back ---------------------------
//
// A tile is 8,192 events: 16 warps of 512.  Lane l of a warp holds, for
// each of its four float4 vectors j, the events warp_base + 128 j + 4 l + q,
// so every load instruction of the warp reads 512 contiguous bytes.  The
// warp scans its 512 events in float32 (four warp scans, carried), the
// block adds the warps' totals, and one warp finds the tile's offset by
// looking back over the status words of the tiles before it (Merrill &
// Garland).
constexpr int kCsThreads = 512;
constexpr int kCsWarps = kCsThreads / 32;
constexpr int kCsVecs = 4;                                // float4 per array
constexpr int kCsWarpSpan = 32 * 4 * kCsVecs;             // 512 events
constexpr int kCsTile = kCsWarps * kCsWarpSpan;           // 8,192 events

// A status word is one 64-bit value that says what it holds: a float64
// with its two lowest mantissa bits replaced by the state (a relative
// change below 2^-50).  Each tile has two, one for contrib and one for
// idle, at status[2 * tile] and status[2 * tile + 1]: first the tile's
// aggregate, then its inclusive prefix, carry included.  A word is read
// and written whole (relaxed 64-bit accesses at device scope), so a reader
// needs no ordering against any other memory.  Zero is "not yet".
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

__device__ __forceinline__ double status_value(unsigned long long w) {
  return __longlong_as_double((long long)(w & ~kStatusMask));
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

// Wait until the tiles before `tile` have published enough to sum every
// event before it; returns the (contrib, idle) prefix, carry included (the
// walk ends on an inclusive word, and tile 0's holds the carry).  Each
// lane reads one predecessor's two words per step; the two sums end
// independently.  Called by all 32 lanes of one warp.
__device__ __forceinline__ void look_back(int64_t tile,
                                          const unsigned long long* status,
                                          double* pc, double* pi) {
  const int lane = lane_id();
  double acc[2] = {0.0, 0.0};
  bool open[2] = {true, true};
  for (int64_t pos = tile - 1; open[0] || open[1]; pos -= 32) {
    const int64_t p = pos - lane;
    unsigned long long w[2];
    bool wait;
    do {
      wait = false;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        w[x] = p >= 0 && open[x] ? load_status(status + 2 * p + x)
                                 : kStatusInclusive;
        wait |= (w[x] & kStatusMask) == kStatusInvalid;
      }
    } while (__any_sync(kFullMask, wait));
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (!open[x]) continue;  // the same for every lane
      const unsigned incl = __ballot_sync(
          kFullMask, (w[x] & kStatusMask) == kStatusInclusive && p >= 0);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      double v = lane <= stop && p >= 0 ? status_value(w[x]) : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
      acc[x] += v;
      open[x] = incl == 0;
    }
  }
  *pc = acc[0];
  *pi = acc[1];
}

__global__ void __launch_bounds__(kCsThreads)
carry_cumsum_lookback(const float* contrib, const float* idle, int64_t e,
                      int vec, Carry carry0, int64_t ntiles,
                      unsigned long long* status, float* g, float* scalars) {
  __shared__ int64_t s_tile;
  __shared__ float s_warp_c[kCsWarps], s_warp_i[kCsWarps];
  __shared__ double s_off;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  // Tiles are numbered in the order blocks start, so every tile a block
  // waits for belongs to a block that is already running.
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(status + 2 * ntiles), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile_base = tile * kCsTile;
  const int local = warp * kCsWarpSpan + lane * 4;

  float c[kCsVecs][4], w[kCsVecs][4];
#pragma unroll
  for (int j = 0; j < kCsVecs; ++j) {
    load4<float4>(contrib, tile_base + local + 128 * j, e, vec, 0.f, c[j]);
    load4<float4>(idle, tile_base + local + 128 * j, e, vec, 0.f, w[j]);
  }

  // In-warp inclusive scan of 512 events, float32; c becomes the prefix.
  float run = 0.f, isum = 0.f;
#pragma unroll
  for (int j = 0; j < kCsVecs; ++j) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s += c[j][q];
      c[j][q] = s;
      isum += w[j][q];
    }
    const float wi = warp_inclusive(s);
    float ex = __shfl_up_sync(kFullMask, wi, 1);
    if (lane == 0) ex = 0.f;
    const float base = run + ex;
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] += base;
    run += __shfl_sync(kFullMask, wi, 31);
  }
  const float wis = warp_inclusive(isum);
  if (lane == 31) {
    s_warp_c[warp] = run;
    s_warp_i[warp] = wis;
  }
  __syncthreads();
  float woff = 0.f, tot = 0.f, itot = 0.f;
#pragma unroll
  for (int k = 0; k < kCsWarps; ++k) {
    if (k == warp) woff = tot;
    tot += s_warp_c[k];
    itot += s_warp_i[k];
  }

  if (warp == 0) {
    // Tile 0 starts from the carry; every inclusive word holds it.
    double pc = (double)carry0[0], pi = (double)carry0[1];
    if (tile > 0) {
      if (lane == 0) {
        store_status(status + 2 * tile, status_word(tot, kStatusAggregate));
        store_status(status + 2 * tile + 1,
                     status_word(itot, kStatusAggregate));
      }
      look_back(tile, status, &pc, &pi);
    }
    if (lane == 0) {
      const double ic = pc + (double)tot, ii = pi + (double)itot;
      store_status(status + 2 * tile, status_word(ic, kStatusInclusive));
      store_status(status + 2 * tile + 1, status_word(ii, kStatusInclusive));
      s_off = pc;
      if (tile == ntiles - 1) {
        scalars[0] = (float)ic;
        scalars[1] = (float)ii;
      }
    }
  }
  __syncthreads();
  const double off = s_off;
#pragma unroll
  for (int j = 0; j < kCsVecs; ++j) {
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = (float)(off + (double)(woff + c[j][q]));
    store4<float4>(g, tile_base + local + 128 * j, e, vec, out);
  }
}

}  // namespace

extern "C" {

// Events per tile: the wrappers size their scratch with it.
int gapp_tile_size(void) { return kTile; }

// n[i] = count0 + sum(deltas[:i+1]); gcm[i] = gcm0 + sum(contrib[:i]) with
// contrib = dt / n where n > 0, else 0; idle = idle0 + sum(dt where n <= 0
// and dt > 0).  The carry (count0, gcm0, idle0) is float[3] on the device
// at carry_dev, or (c0, g0, i0) when carry_dev is null; scalars = (total_cm,
// idle, count) is float[3] on the device.  Scratch: iscratch int[2*ntiles],
// dscratch double[3*ntiles].  vec: every pointer is 16-byte aligned.
int gapp_fold(const float* dt, const int* deltas, long long e,
              const float* carry_dev, float c0, float g0, float i0, int* n,
              float* gcm, float* scalars, int* iscratch, double* dscratch,
              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Carry carry0 = {carry_dev, {c0, g0, i0}};
  const long long ntiles = (e + kTile - 1) / kTile;
  const unsigned grid = (unsigned)ntiles;
  int* tile_count = iscratch;
  int* tile_count_off = iscratch + ntiles;
  double* tile_cm = dscratch;
  double* tile_idle = dscratch + ntiles;
  double* tile_off = dscratch + 2 * ntiles;
  fold_count_tiles<<<grid, kThreads, 0, s>>>(deltas, e, vec, tile_count);
  GAPP_LAUNCH_CHECK();
  fold_scan_counts<<<1, kScanThreads, 0, s>>>(tile_count, ntiles, carry0,
                                              tile_count_off, scalars + 2);
  GAPP_LAUNCH_CHECK();
  fold_tile_n<<<grid, kThreads, 0, s>>>(dt, deltas, e, vec, tile_count_off, n,
                                        tile_cm, tile_idle);
  GAPP_LAUNCH_CHECK();
  scan_tile_sums<<<1, kScanThreads, 0, s>>>(tile_cm, tile_idle, ntiles,
                                            carry0, 1, 2, tile_off,
                                            scalars + 0, scalars + 1);
  GAPP_LAUNCH_CHECK();
  fold_tile_gcm<<<grid, kThreads, 0, s>>>(dt, n, e, vec, tile_off, gcm);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Events per carry_cumsum tile: the wrapper sizes its scratch with it.
int gapp_cumsum_tile_size(void) { return kCsTile; }

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
  const long long ntiles = (e + kCsTile - 1) / kCsTile;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(2 * ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  carry_cumsum_lookback<<<(unsigned)ntiles, kCsThreads, 0, s>>>(
      contrib, idle_contrib, e, vec, carry0, ntiles, status, g, scalars);
  GAPP_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
