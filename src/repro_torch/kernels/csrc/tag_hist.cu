// Sample-tag histogram and weighted histogram, for Hopper (sm_90a).
//
// Replaces the TPU kernel _hist_kernel (wrapper hist) of the JAX package's
// kernels/tag_hist.py.  The TPU form compares a block of samples against a
// block of bins as a one-hot matrix and accumulates into an output block
// that stays resident across the TPU's sequential grid.  On Hopper the
// natural shape is a scatter with atomics, and the design is about keeping
// the atomics few and close:
//
// - Loads: each thread reads its samples as 16-byte vectors (int4 tags,
//   float4 weights), two of each in flight; the grid is sized by occupancy.
// - Warp aggregation: __match_any_sync groups the lanes of a warp that hold
//   the same key; one lane adds the group's count (__popc of the peers) and
//   its peer-reduced weight.  Skewed keys (the detector's) collapse to a
//   few atomics per warp.
// - Records: in global memory a bin is one 8-byte record (count, weighted
//   sum), so a sample touches one sector; a last kernel splits the records
//   into counts and wsum.  In shared memory the counts and the sums are
//   two arrays (see smem_add).  Without weights only the count is added
//   (4 bytes a bin in shared memory), and wsum[b] = (float)counts[b].
// - Three places for the bins, by K (bins_path):
//     shared:  the bins fit one block's budget (kSharedBytes).  Each
//              block keeps up to four private copies while they fit
//              kCopyBytes (warps take them in turn) so hot bins contend
//              less, and merges non-zero bins into the global records at
//              its end.
//     cluster: counts alone, spread over the distributed shared memory of
//              a cluster of two blocks (at most kSharedBytes each); a
//              sample's bin lives in block key / per_block of the cluster.
//              Each block merges its half at the end.
//     global:  otherwise, atomics straight into the global records (which
//              stay in the 50 MB L2 for K <= 2^20).
// - With weights, global records hold the count as a float when
//   S <= 2^24: every partial count is then an integer below 2^24, exact in
//   float32, and a sample is one float2 atomic (1.8x faster at K = 2^20
//   than an int count and a float sum, two atomics on the same record;
//   PERF.md).  Past 2^24 samples, and always for counts alone, the count
//   is an int.
//
// Counts are exact.  wsum is a sum of float atomics, whose order varies
// from run to run.  Tags that are negative or >= K are dropped.
//
// Bound: memory.  The function must read tags (i32) and weights (f32) and
// write counts (i32) and wsum (f32): 8 bytes per sample plus 8 per bin (4
// per sample without weights).
//
// Plain C interface for ctypes; launches go on the caller's stream and the
// function returns the first launch error (cudaSuccess == 0).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using gapp::kFullMask;
using gapp::lane_id;
using gapp::load4;
using gapp::smem_addr;

constexpr int kHistThreads = 512;
constexpr int kHistLoads = 2;  // int4 tag vectors in flight per thread
constexpr int kChunk = kHistThreads * 4 * kHistLoads;  // samples a block
                                                        // takes per step
constexpr int kAggregateMin = 8;  // equal-neighbour lanes that turn on
                                  // warp aggregation
constexpr int kMaxCopies = 4;
// Per-block shared-memory budgets for the bins, chosen on the H100 (see
// PERF.md): private copies while they fit kCopyBytes (two blocks of an
// SM), one copy, or one half of a cluster's bins, up to kSharedBytes.
constexpr long long kCopyBytes = 113 * 1024;
constexpr long long kSharedBytes = 200 * 1024;
constexpr int kCluster = 2;
constexpr long long kExactFloatCount = 1LL << 24;

// Where the bins live, as gapp_tag_hist_path names them.
constexpr int kPathGlobal = 0, kPathShared = 1, kPathCluster = 2;

// Sum of x over the lanes of `peers`, left at the lowest of them (Elmar
// Westphal's log-step reduction over an arbitrary peer mask).  All 32
// lanes call it.
__device__ __forceinline__ float reduce_peers(unsigned peers, float x) {
  const int lane = lane_id();
  int rel = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;
  while (__any_sync(kFullMask, peers)) {
    const int next = __ffs(peers);
    const float t = __shfl_sync(kFullMask, x, (next - 1) & 31);
    if (next) x += t;
    peers &= ~__ballot_sync(kFullMask, rel & 1);
    rel >>= 1;
  }
  return x;
}

// Every lane's sample (key, x) goes into add(key, count, sum).  All 32
// lanes call it; key < 0 adds nothing.  Lanes hold samples four apart in
// the stream, so neighbours with equal keys mean runs or a hot bin: when
// at least kAggregateMin lanes match the lane before them, the warp groups
// equal keys with __match_any_sync and adds once per distinct key;
// otherwise (distinct keys, where the match costs more than it saves)
// every lane adds its own sample.
template <bool kWeighted, typename Add>
__device__ __forceinline__ void warp_add(int key, float x, Add add) {
  const int before = __shfl_up_sync(kFullMask, key, 1);
  const unsigned same =
      __ballot_sync(kFullMask, lane_id() > 0 && key >= 0 && key == before);
  if (__popc(same) < kAggregateMin) {
    if (key >= 0) add(key, 1, x);
    return;
  }
  const unsigned peers = __match_any_sync(kFullMask, key);
  const float sum = kWeighted ? reduce_peers(peers, x) : 0.f;
  if (key >= 0 && lane_id() == __ffs(peers) - 1) add(key, __popc(peers), sum);
}

// The block's share of the samples, kChunk at a time, through warp_add.
// Loop bounds depend on the block only, so warps stay converged.
template <bool kWeighted, typename Add>
__device__ __forceinline__ void scan_samples(const int* tags, const float* w,
                                             long long s, int k, int vec,
                                             Add add) {
  for (long long base = (long long)blockIdx.x * kChunk; base < s;
       base += (long long)gridDim.x * kChunk) {
    int t[kHistLoads][4];
    float x[kHistLoads][4];
#pragma unroll
    for (int l = 0; l < kHistLoads; ++l) {
      const long long i = base + ((long long)l * kHistThreads + threadIdx.x) * 4;
      load4<int4>(tags, i, s, vec, -1, t[l]);
      if (kWeighted) load4<float4>(w, i, s, vec, 0.f, x[l]);
    }
#pragma unroll
    for (int l = 0; l < kHistLoads; ++l)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = (unsigned)t[l][q] < (unsigned)k ? t[l][q] : -1;
        warp_add<kWeighted>(key, kWeighted ? x[l][q] : 1.f, add);
      }
  }
}

// Add (c, sum) to a global record: a float count and the sum in one
// atomic (kF, weighted only), or an int count (and the sum).
template <bool kWeighted, bool kF>
__device__ __forceinline__ void rec_add(float2* r, int c, float sum) {
  static_assert(kWeighted || !kF, "a float count only with weights");
  if (kF) {
    atomicAdd(r, make_float2((float)c, sum));
  } else {
    atomicAdd(reinterpret_cast<int*>(&r->x), c);
    if (kWeighted) atomicAdd(&r->y, sum);
  }
}

// Bins in shared memory are two arrays, not records: n int counts, then
// (with weights) n float sums.  A warp's adds then spread over all 32
// banks, where records put a bin's count and sum in neighbouring banks
// (measured slower on the H100).  Float adds to shared memory are
// compare-and-swap loops on this card, integer adds are not.
template <bool kWeighted>
constexpr long long bin_bytes() {
  return kWeighted ? 2 * sizeof(int) : sizeof(int);
}

// Add (c, sum) to bin i of the n-bin arrays at `counts`, in this block.
template <bool kWeighted>
__device__ __forceinline__ void smem_add(int* counts, int n, int i, int c,
                                         float sum) {
  const uint32_t a = smem_addr(counts + i);
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a), "r"(c) : "memory");
  if (kWeighted)
    asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(a + 4 * n), "f"(sum)
                 : "memory");
}

template <bool kWeighted, bool kF>
__global__ void __launch_bounds__(kHistThreads)
hist_shared(const int* tags, const float* w, long long s, int k, int copies,
            int vec, float2* rec) {
  extern __shared__ int sbin[];
  const int n = copies * k;
  for (int i = threadIdx.x; i < (kWeighted ? 2 * n : n); i += blockDim.x)
    sbin[i] = 0;
  __syncthreads();
  int* mine = sbin + ((threadIdx.x >> 5) % copies) * k;
  scan_samples<kWeighted>(tags, w, s, k, vec, [&](int key, int c, float sum) {
    smem_add<kWeighted>(mine, n, key, c, sum);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    int c = 0;
    float sum = 0.f;
    for (int r = 0; r < copies; ++r) {
      c += sbin[r * k + i];
      if (kWeighted) sum += __int_as_float(sbin[n + r * k + i]);
    }
    if (c) rec_add<kWeighted, kF>(rec + i, c, sum);
  }
}

// Counts alone (a float add to another block's shared memory is a
// compare-and-swap loop across the cluster, slower than global atomics).
__global__ void __launch_bounds__(kHistThreads)
hist_cluster(const int* tags, long long s, int k, int per_block, int vec,
             float2* rec) {
  extern __shared__ int sbin[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < per_block; i += blockDim.x) sbin[i] = 0;
  cluster.sync();
  scan_samples<false>(tags, nullptr, s, k, vec, [&](int key, int c, float) {
    const int rank = key / per_block;
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a)
                 : "r"(smem_addr(sbin + key - rank * per_block)), "r"(rank));
    asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(a), "r"(c)
                 : "memory");
  });
  // Every remote add has landed; no block reads another's bins after this.
  cluster.sync();
  const int lo = (int)cluster.block_rank() * per_block;
  for (int i = threadIdx.x; i < per_block && lo + i < k; i += blockDim.x)
    if (sbin[i]) rec_add<false, false>(rec + lo + i, sbin[i], 0.f);
}

template <bool kWeighted, bool kF>
__global__ void __launch_bounds__(kHistThreads)
hist_global(const int* tags, const float* w, long long s, int k, int vec,
            float2* rec) {
  scan_samples<kWeighted>(tags, w, s, k, vec, [&](int key, int c, float sum) {
    rec_add<kWeighted, kF>(rec + key, c, sum);
  });
}

template <bool kWeighted, bool kF>
__global__ void __launch_bounds__(kHistThreads)
hist_split(const float2* rec, int k, int* counts, float* wsum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) {
    const float2 v = rec[i];
    const int c = kF ? (int)v.x : __float_as_int(v.x);
    counts[i] = c;
    wsum[i] = kWeighted ? v.y : (float)c;
  }
}

// Bins a block of the cluster holds.
long long cluster_block_bins(int k) {
  return ((long long)k + kCluster - 1) / kCluster;
}

// The path chosen by K, from the measurements in PERF.md (S = 2^24 on the
// H100): one block's shared memory while the bins fit it; then, for
// counts alone, a cluster of two (about half the global path's time;
// larger clusters and weighted clusters lose to global atomics); past
// that, global.
int bins_path(int k, bool weighted) {
  const long long bin = weighted ? bin_bytes<true>() : bin_bytes<false>();
  if (k * bin <= kSharedBytes) return kPathShared;
  if (!weighted && cluster_block_bins(k) * bin <= kSharedBytes)
    return kPathCluster;
  return kPathGlobal;
}

// The blocks (or clusters) of one kernel that fill the current device at
// `smem` bytes of dynamic shared memory, from an occupancy query.  The
// detector calls the histogram at one K again and again, and the query
// (with the attribute call before it) costs the host more than a launch,
// so each launch site keeps its last answer, keyed by device and smem:
// racing threads at worst repeat the query.
class GridMemo {
 public:
  // query(dev, &n) asks the occupancy API for n blocks (or clusters).
  template <typename Kern, typename Query>
  cudaError_t get(Kern kern, long long smem, Query query, long long* grid) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long key = ((unsigned long long)dev << 24) | smem;
    const unsigned long long got = last_.load(std::memory_order_relaxed);
    if (got >> 32 == key) {
      *grid = (long long)(got & 0xffffffffu);
      return cudaSuccess;
    }
    if (smem > 0)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedBytes);
    int n = 0;
    if (err == cudaSuccess) err = query(dev, &n);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    *grid = n;
    last_.store(key << 32 | (unsigned)n, std::memory_order_relaxed);
    return cudaSuccess;
  }

 private:
  std::atomic<unsigned long long> last_{~0ull};  // key << 32 | grid
};

// Blocks of kern that fill the device: its occupancy times the SMs.
template <typename Kern>
cudaError_t block_grid(GridMemo& memo, Kern kern, long long smem,
                       long long* grid) {
  return memo.get(kern, smem, [&](int dev, int* n) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kHistThreads, smem);
    *n = per_sm * sms;
    return err;
  }, grid);
}

long long at_most(long long grid, long long needed) {
  return needed < 1 ? 1 : grid < needed ? grid : needed;
}

template <bool kW, bool kF>
cudaError_t launch_hist(const int* tags, const float* w, long long s, int k,
                        float2* rec, int vec, cudaStream_t st) {
  const long long needed = (s + kChunk - 1) / kChunk;
  long long grid = 0;
  cudaError_t err = cudaSuccess;
  switch (bins_path(k, kW)) {
    case kPathCluster: {
      const long long per_block = cluster_block_bins(k);
      const long long smem = per_block * bin_bytes<false>();
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kCluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kCluster);
      cfg.blockDim = dim3(kHistThreads);
      cfg.dynamicSmemBytes = (size_t)smem;
      cfg.stream = st;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      static GridMemo memo;
      err = memo.get(hist_cluster, smem, [&cfg](int, int* n) {
        return cudaOccupancyMaxActiveClusters(n, hist_cluster, &cfg);
      }, &grid);
      if (err != cudaSuccess) return err;
      const long long clusters = (needed + kCluster - 1) / kCluster;
      cfg.gridDim = dim3((unsigned)(at_most(grid, clusters) * kCluster));
      return cudaLaunchKernelEx(&cfg, hist_cluster, tags, s, k,
                                (int)per_block, vec, rec);
    }
    case kPathShared: {
      const long long bytes = (long long)k * bin_bytes<kW>();
      int copies = (int)(kCopyBytes / bytes);
      copies = copies < 1 ? 1 : copies > kMaxCopies ? kMaxCopies : copies;
      const long long smem = copies * bytes;
      static GridMemo memo;
      err = block_grid(memo, hist_shared<kW, kF>, smem, &grid);
      if (err != cudaSuccess) return err;
      hist_shared<kW, kF><<<(unsigned)at_most(grid, needed), kHistThreads,
                            (size_t)smem, st>>>(tags, w, s, k, copies, vec,
                                                rec);
      return cudaGetLastError();
    }
    default: {
      static GridMemo memo;
      err = block_grid(memo, hist_global<kW, kF>, 0, &grid);
      if (err != cudaSuccess) return err;
      hist_global<kW, kF><<<(unsigned)at_most(grid, needed), kHistThreads, 0,
                            st>>>(tags, w, s, k, vec, rec);
      return cudaGetLastError();
    }
  }
}

template <bool kW, bool kF>
cudaError_t run_hist(const int* tags, const float* w, long long s, int k,
                     int* counts, float* wsum, float2* rec, int vec,
                     cudaStream_t st) {
  if (s > 0) {
    const cudaError_t err = launch_hist<kW, kF>(tags, w, s, k, rec, vec, st);
    if (err != cudaSuccess) return err;
  }
  hist_split<kW, kF><<<(unsigned)((k + kHistThreads - 1) / kHistThreads),
                       kHistThreads, 0, st>>>(rec, k, counts, wsum);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// counts[b] = #{i : tags[i] == b}, wsum[b] = sum of w[i] over those i, for
// b in [0, k); w may be null (every weight 1: wsum[b] = (float)counts[b],
// equal to a float32 sum of ones while the bin holds fewer than 2^24
// samples).  rec is scratch of k 8-byte records, zeroed here on the stream.
// vec: tags and w are 16-byte aligned.  One memset and two kernel
// launches.
int gapp_tag_hist(const int* tags, const float* w, long long s, int k,
                  int* counts, float* wsum, void* rec, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* r = static_cast<float2*>(rec);
  const cudaError_t err =
      cudaMemsetAsync(r, 0, sizeof(float2) * (size_t)k, st);
  if (err != cudaSuccess) return (int)err;
  if (!w)
    return (int)run_hist<false, false>(tags, w, s, k, counts, wsum, r, vec, st);
  if (s <= kExactFloatCount)
    return (int)run_hist<true, true>(tags, w, s, k, counts, wsum, r, vec, st);
  return (int)run_hist<true, false>(tags, w, s, k, counts, wsum, r, vec, st);
}

// Where gapp_tag_hist keeps k bins: 0 global memory, 1 one block's shared
// memory, 2 a cluster's distributed shared memory.
int gapp_tag_hist_path(int k, int weighted) { return bins_path(k, weighted); }

}  // extern "C"
