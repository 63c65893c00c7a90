// CMetric interval fold and carry-seeded prefix, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package's kernels/cmetric_fold.py:
//   _fold_kernel   (wrapper fold)         -> gapp_fold
//   _cumsum_kernel (wrapper carry_cumsum) -> gapp_carry_cumsum
//
// The TPU kernels carry the running prefix from one grid step to the next
// in VMEM scratch, which relies on the TPU running its grid in order.  CUDA
// blocks run concurrently, so each scan here is a multi-pass tiled scan:
// per-tile aggregates, one single-block scan of the aggregates, then a
// per-tile pass that applies the tile's offset.  The fold's contributions
// depend on the active count coming into a tile, so its integer count scan
// completes before any contribution is formed.  The gcm prefix across tiles
// is carried in float64: its error is that of one tile's float32 scan plus
// the final rounding, not that of a 2^24-term float32 chain.
//
// Bound: memory.  fold must read dt (f32) and deltas (i32) and write n (i32)
// and gcm (f32), 16 bytes per event; this design moves 28 (deltas are read
// twice, n is written and read back).  carry_cumsum must move 12 bytes per
// event (contrib, idle_contrib, g); this design moves 16.  Loads and stores
// are 16 bytes per thread, neighbouring threads on neighbouring addresses.
//
// Plain C interface for ctypes.  Every launch goes on the caller's stream;
// each function returns the first launch error (cudaSuccess == 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane_id() >= o) v += u;
  }
  return v;
}

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

template <typename V, typename T>
__device__ __forceinline__ void load4(const T* p, int64_t base, int64_t e,
                                      int vec, T fill, T (&x)[kItems]) {
  if (vec && base + kItems <= e) {
    const V v = *reinterpret_cast<const V*>(p + base);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = base + j < e ? p[base + j] : fill;
  }
}

template <typename V, typename T>
__device__ __forceinline__ void store4(T* p, int64_t base, int64_t e, int vec,
                                       const T (&x)[kItems]) {
  if (vec && base + kItems <= e) {
    V v;
    v.x = x[0]; v.y = x[1]; v.z = x[2]; v.w = x[3];
    *reinterpret_cast<V*>(p + base) = v;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (base + j < e) p[base + j] = x[j];
  }
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

// ---- carry_cumsum pass 1: per-tile sums of contrib and idle_contrib -------
__global__ void __launch_bounds__(kThreads)
cumsum_tile_sums(const float* contrib, const float* idle, int64_t e, int vec,
                 double* tile_cm, double* tile_idle) {
  __shared__ float sf[33];
  const int64_t base = item_base();
  float c[kItems], w[kItems];
  load4<float4>(contrib, base, e, vec, 0.f, c);
  load4<float4>(idle, base, e, vec, 0.f, w);
  float s = 0.f, is = 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += c[j];
    is += w[j];
  }
  float ctot, itot;
  block_exclusive(s, sf, &ctot);
  block_exclusive(is, sf, &itot);
  if (threadIdx.x == 0) {
    tile_cm[blockIdx.x] = ctot;
    tile_idle[blockIdx.x] = itot;
  }
}

// ---- carry_cumsum pass 3: g, the inclusive prefix --------------------------
__global__ void __launch_bounds__(kThreads)
cumsum_tile_apply(const float* contrib, int64_t e, int vec,
                  const double* tile_off, float* g) {
  __shared__ float sf[33];
  const int64_t base = item_base();
  float c[kItems];
  load4<float4>(contrib, base, e, vec, 0.f, c);
  float incl[kItems];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += c[j];
    incl[j] = s;
  }
  float total;
  const float ex = block_exclusive(s, sf, &total);
  const double off = tile_off[blockIdx.x];
  float out[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) out[j] = (float)(off + (double)(ex + incl[j]));
  store4<float4>(g, base, e, vec, out);
}

}  // namespace

#define GAPP_LAUNCH_CHECK()                      \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

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

// g[i] = gcm0 + sum(contrib[:i+1]); scalars = (g[-1], idle0 +
// sum(idle_contrib)).  The carry (gcm0, idle0) is float[2] on the device at
// carry_dev, or (g0, i0) when carry_dev is null.  Scratch: dscratch
// double[3*ntiles].
int gapp_carry_cumsum(const float* contrib, const float* idle_contrib,
                      long long e, const float* carry_dev, float g0, float i0,
                      float* g, float* scalars, double* dscratch, int vec,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Carry carry0 = {carry_dev, {g0, i0, 0.f}};
  const long long ntiles = (e + kTile - 1) / kTile;
  const unsigned grid = (unsigned)ntiles;
  double* tile_cm = dscratch;
  double* tile_idle = dscratch + ntiles;
  double* tile_off = dscratch + 2 * ntiles;
  cumsum_tile_sums<<<grid, kThreads, 0, s>>>(contrib, idle_contrib, e, vec,
                                             tile_cm, tile_idle);
  GAPP_LAUNCH_CHECK();
  scan_tile_sums<<<1, kScanThreads, 0, s>>>(tile_cm, tile_idle, ntiles,
                                            carry0, 0, 1, tile_off,
                                            scalars + 0, scalars + 1);
  GAPP_LAUNCH_CHECK();
  cumsum_tile_apply<<<grid, kThreads, 0, s>>>(contrib, e, vec, tile_off, g);
  GAPP_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
