// The paper-faithful streaming CMetric scan, for Hopper (sm_90a).
//
// Replaces the JAX package's _streaming_scan (core/cmetric.py), which is
// not a Pallas kernel but a lax.scan: one step is one run of the
// sched_switch probe, with the Table-1 eBPF-map state (global_cm, idle,
// thread_count, t_switch and the per-worker local_cm, slice start and
// cm_hash) as its carry.
//
// Only two float32 running sums have to be taken in event order: global_cm
// and idle.  The rest of the step follows from them in parallel: a
// switch-out's slice cm is global_cm after it less global_cm after its
// worker's last switch-in, its start is that switch-in's time, and a
// worker's CMetric is the float32 sum of its slices in event order, serial
// within that worker only.  So the scan is a pipeline of six launches:
//
//   prepass  (grid, one pass with a decoupled look-back over two int32
//            chains)  each event's active count before it and, for a
//            switch-out, its row k (the k-th switch-out is row k); its
//            share of global_cm (dt / count while count > 0) and of idle
//            (dt while count <= 0); each row's event and n_at_exit;
//   chain    (one block of three warps)  the two sums.  Each is walked by
//            one lane of its own warp, so on its own SM sub-partition,
//            over tiles that the third warp keeps in flight into a
//            shared-memory ring with 1-D bulk copies (TMA) and mbarriers;
//            global_cm is written once every 256 events (a checkpoint);
//   expand   (grid, one thread a checkpoint)  global_cm after every
//            event: the checkpoint plus the 256 shares after it, added in
//            the walk's order, so bit for bit the walk's values;
//   pair     (grid, on a second stream while the chain runs, after a
//            stable sort of the worker ids)  each switch-out's source, the
//            last switch-in of its worker at or before it: an inclusive
//            max-scan, with a decoupled look-back, of the 62-bit key
//            worker << 31 | (switch-in ? event + 1 : 0) over the sorted
//            events, which needs no segment flags because each worker's
//            keys exceed every earlier worker's; and each row's place q in
//            the worker-major order of the rows, with each worker's range
//            [begin, end) of places;
//   rows     (grid, one thread a row)  slice cm and duration, the six
//            columns, and the slice cm again at its place q;
//   cm       (grid, one warp a worker)  the worker's slices in event
//            order, 128 at a time, added in order by every lane from
//            shuffles.
//
// Bound: the chain.  global_cm is E dependent float32 adds (~34 ms at 2^24
// with a 4-cycle FADD at 1.98 GHz); the bytes the function must move (12
// an event in, 24 a slice out, ~0.12 ms at 2^24) are two orders below it.
// The walk does nothing but the adds: per 16 events four 16-byte shared
// loads (issued a step ahead) and 16 adds; per 256 one 4-byte store, and
// per 4,096 one mbarrier wait.  The other launches are memory-bound
// and, but for the pairing, which runs beside the chain, add well under a
// millisecond at 2^24.
//
// Rounding: every float operation is an explicitly rounded intrinsic
// (__fadd_rn, __fsub_rn, __fdiv_rn) and every conditional a select, so
// nvcc's default -fmad=true cannot contract anything into an FMA; the
// shares, sums and slices are the reference's float32 values, in its
// order.  Where a sum is padded (the chain's last tile, a worker's last
// 128 slices) it adds +0.0, which leaves a float32 sum that started at
// +0.0 unchanged: x + (+0.0) is x for every x but -0.0, and such a sum is
// never -0.0.
//
// Plain C interface for ctypes.  Each function queues its launch on the
// stream it is given and returns the launch error (cudaSuccess == 0).
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
using gapp::MaxOp;
using gapp::smem_addr;
using gapp::status_word;
using gapp::store_status;
using gapp::take_tile;

// The grid passes' tile: 8,192 events, 16 warps of 512.  Lane l of a warp
// holds, for each of its four vectors j, the events warp_base + 128 j +
// 4 l + q (q < 4), so each load instruction of the warp reads 512
// contiguous bytes.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;
constexpr int kWarpSpan = 32 * 4 * kVecs;       // 512 events
constexpr int kTile = kWarps * kWarpSpan;       // 8,192 events

// The chain's ring: kStages stages of kStage shares and kStage idle terms
// (96 KB); a walker's step of kBlk float4s (16 events); a checkpoint of
// global_cm every kSeg events.
constexpr int kStage = 4096;
constexpr int kStages = 3;
constexpr int kBlk = 4;
constexpr int kSeg = 256;                       // events a checkpoint
constexpr int kChainThreads = 96;               // walker, idle, producer
constexpr int kChainSmem = 2 * kStages * kStage * (int)sizeof(float) +
                           2 * kStages * (int)sizeof(uint64_t);

constexpr int kRowThreads = 256;
constexpr int kCmWarps = 8;

struct Rows {
  int* worker;
  float* start;
  float* end;
  float* cm;
  float* threads_av;
  int* n_at_exit;
};

// Inclusive warp prefix of (a, b).
__device__ __forceinline__ int2 warp_inclusive2(int a, int b) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ua = __shfl_up_sync(kFullMask, a, o);
    const int ub = __shfl_up_sync(kFullMask, b, o);
    if (lane_id() >= o) {
      a += ua;
      b += ub;
    }
  }
  return make_int2(a, b);
}

// Inclusive warp prefix of (max of m, sum of c).
__device__ __forceinline__ void warp_inclusive_max_sum(unsigned long long& m,
                                                       int& c) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long um = __shfl_up_sync(kFullMask, m, o);
    const int uc = __shfl_up_sync(kFullMask, c, o);
    if (lane_id() >= o) {
      m = um > m ? um : m;
      c += uc;
    }
  }
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// ---- prepass ----------------------------------------------------------------
//
// status: ntiles (count, rows) word pairs, then the tile ticket.  share and
// idle are padded to whole tiles (16-byte aligned; 0 past e).
__global__ void __launch_bounds__(kThreads)
stream_prepass(const float* __restrict__ times, const int* __restrict__ deltas,
               int64_t e, int vec, int64_t ntiles, unsigned long long* status,
               float* __restrict__ share, float* __restrict__ idle,
               int* __restrict__ row_of, int* __restrict__ out_idx,
               int* __restrict__ n_at_exit) {
  __shared__ int2 s_warp[kWarps];
  __shared__ int2 s_base;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int64_t tile = take_tile(status + 2 * ntiles);
  const int64_t at = tile * kTile + warp * kWarpSpan + lane * 4;

  // the lane's events (bit 4 j + q), and for each vector its exclusive
  // prefix within the warp of the count steps and of the switch-outs
  unsigned valid = 0, in = 0;
  int ex_c[kVecs], ex_k[kVecs];
  int run_c = 0, run_k = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int d[4];
    load4<int4>(deltas, at + 128 * j, e, vec, 0, d);
    int sc = 0, sk = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool v = at + 128 * j + q < e;
      const bool v_in = v && d[q] > 0;
      valid |= (unsigned)v << (4 * j + q);
      in |= (unsigned)v_in << (4 * j + q);
      sc += v ? (v_in ? 1 : -1) : 0;
      sk += v && !v_in ? 1 : 0;
    }
    const int2 incl = warp_inclusive2(sc, sk);
    ex_c[j] = run_c + incl.x - sc;
    ex_k[j] = run_k + incl.y - sk;
    run_c += __shfl_sync(kFullMask, incl.x, 31);
    run_k += __shfl_sync(kFullMask, incl.y, 31);
  }
  if (lane == 0) s_warp[warp] = make_int2(run_c, run_k);
  __syncthreads();
  int2 off = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int2 t = s_warp[v];
    if (v == warp) off = tot;
    tot.x += t.x;
    tot.y += t.y;
  }
  if (warp == 0) {
    unsigned pre[2] = {0u, 0u};
    if (tile > 0) {
      if (lane == 0) {
        store_status(status + 2 * tile,
                     status_word((unsigned)tot.x, kStatusAggregate));
        store_status(status + 2 * tile + 1,
                     status_word((unsigned)tot.y, kStatusAggregate));
      }
      look_back(tile, status, pre);
    }
    if (lane == 0) {
      store_status(status + 2 * tile,
                   status_word(pre[0] + (unsigned)tot.x, kStatusInclusive));
      store_status(status + 2 * tile + 1,
                   status_word(pre[1] + (unsigned)tot.y, kStatusInclusive));
      s_base = make_int2((int)pre[0], (int)pre[1]);
    }
  }
  __syncthreads();
  const int2 base = s_base;

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i0 = at + 128 * j;
    float t[4];
    load4<float4>(times, i0, e, vec, 0.f, t);
    // the time before the lane's first event: the previous lane's last,
    // or for lane 0 read from memory; the first event's dt is 0
    float before = __shfl_up_sync(kFullMask, t[3], 1);
    if (lane == 0) before = i0 > 0 && i0 < e ? times[i0 - 1] : t[0];
    int c = base.x + off.x + ex_c[j];   // the count before event i0
    int k = base.y + off.y + ex_k[j];   // its row, if a switch-out
    float sh[4], id[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bit = 4 * j + q;
      const bool v = (valid >> bit) & 1u;
      const bool v_in = (in >> bit) & 1u;
      const float dt = __fsub_rn(t[q], q == 0 ? before : t[q - 1]);
      const float s = __fdiv_rn(dt, (float)max(c, 1));
      sh[q] = v && c > 0 ? s : 0.f;
      id[q] = v && c <= 0 ? dt : 0.f;
      if (v && !v_in) {
        out_idx[k] = (int)(i0 + q);
        row_of[i0 + q] = k;
        n_at_exit[k] = c;
        ++k;
      }
      c += v ? (v_in ? 1 : -1) : 0;
    }
    *reinterpret_cast<float4*>(share + i0) =
        make_float4(sh[0], sh[1], sh[2], sh[3]);
    *reinterpret_cast<float4*>(idle + i0) =
        make_float4(id[0], id[1], id[2], id[3]);
  }
}

// ---- chain --------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A 1-D bulk copy (TMA) of `bytes` from global to shared memory that
// completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One ring stage of the walk: its kStage values added to sum in order, in
// steps of 16 (each step's shared loads issued a step ahead, so no add
// waits on them); with kOut, sum after every kSeg events goes to
// ckpt[segment].  A store stalls the one thread's in-order issue behind
// the add it stores (stream_variants.py times a store of every sum and a
// checkpoint every 32 events); the expand launch recomputes the sums
// between checkpoints in parallel.
template <bool kOut>
__device__ __forceinline__ void walk_stage(const float4* ring, float* ckpt,
                                           float& sum) {
  constexpr int kSteps = kSeg / (4 * kBlk);
  float4 cur[kBlk];
#pragma unroll
  for (int b = 0; b < kBlk; ++b) cur[b] = ring[b];
#pragma unroll 1
  for (int g = 0; g < kStage / kSeg; ++g) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int j = (g * kSteps + u) * kBlk;
      const int jn = j + kBlk < kStage / 4 ? j + kBlk : j;
      float4 nxt[kBlk];
#pragma unroll
      for (int b = 0; b < kBlk; ++b) nxt[b] = ring[jn + b];
#pragma unroll
      for (int b = 0; b < kBlk; ++b) {
        sum = __fadd_rn(sum, cur[b].x);
        sum = __fadd_rn(sum, cur[b].y);
        sum = __fadd_rn(sum, cur[b].z);
        sum = __fadd_rn(sum, cur[b].w);
      }
#pragma unroll
      for (int b = 0; b < kBlk; ++b) cur[b] = nxt[b];
    }
    if (kOut) ckpt[g] = sum;
  }
}

// Warp 0's lane 0 walks global_cm, warp 1's lane 0 idle, and warp 2's lane
// 0 keeps the ring full.  Each ring stage has a `full` barrier (the
// producer's arrival and the copies' bytes) and an `empty` one (both
// walkers' arrivals).  share and idle hold nstages * kStage floats,
// 16-byte aligned; ckpt[t] receives global_cm before event kSeg * t, for
// t <= nstages * kStage / kSeg.
__global__ void __launch_bounds__(kChainThreads, 1)
stream_chain(const float* __restrict__ share, const float* __restrict__ idle,
             int64_t nstages, float* __restrict__ ckpt,
             float* __restrict__ scalars) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring_share = reinterpret_cast<float*>(smem);
  float* ring_idle = ring_share + kStages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_idle + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    ckpt[0] = 0.f;
  }
  __syncthreads();
  if (lane_id() != 0) return;
  if (warp == 2) {
    for (int64_t s = 0; s < nstages; ++s) {
      const int slot = (int)(s % kStages);
      const int64_t round = s / kStages;
      if (round > 0) mbar_wait(empty + slot, (unsigned)((round - 1) & 1));
      mbar_expect_tx(full + slot, 2u * kStage * sizeof(float));
      bulk_load(ring_share + slot * kStage, share + s * kStage,
                kStage * sizeof(float), full + slot);
      bulk_load(ring_idle + slot * kStage, idle + s * kStage,
                kStage * sizeof(float), full + slot);
    }
    return;
  }
  const bool walks_gcm = warp == 0;
  const float* ring = walks_gcm ? ring_share : ring_idle;
  float sum = 0.f;
  for (int64_t s = 0; s < nstages; ++s) {
    const int slot = (int)(s % kStages);
    mbar_wait(full + slot, (unsigned)((s / kStages) & 1));
    const float4* r = reinterpret_cast<const float4*>(ring + slot * kStage);
    if (walks_gcm)
      walk_stage<true>(r, ckpt + 1 + s * (kStage / kSeg), sum);
    else
      walk_stage<false>(r, nullptr, sum);
    mbar_arrive(empty + slot);
  }
  scalars[walks_gcm ? 1 : 0] = sum;
}

// ---- expand -------------------------------------------------------------------

// gcm[i] for every event: thread t takes the kSeg events from kSeg * t on
// and adds their shares to ckpt[t] in order, as the walk did.  Every
// pointer 16-byte aligned; share and gcm padded to whole segments.
__global__ void __launch_bounds__(kRowThreads)
stream_expand(const float* __restrict__ share, const float* __restrict__ ckpt,
              int64_t nseg, float* __restrict__ gcm) {
  const int64_t t = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= nseg) return;
  const float4* in = reinterpret_cast<const float4*>(share + kSeg * t);
  float4* out = reinterpret_cast<float4*>(gcm + kSeg * t);
  float sum = ckpt[t];
#pragma unroll 8
  for (int b = 0; b < kSeg / 4; ++b) {
    const float4 a = in[b];
    float4 o;
    sum = __fadd_rn(sum, a.x);
    o.x = sum;
    sum = __fadd_rn(sum, a.y);
    o.y = sum;
    sum = __fadd_rn(sum, a.z);
    o.z = sum;
    sum = __fadd_rn(sum, a.w);
    o.w = sum;
    out[b] = o;
  }
}

// ---- pair -------------------------------------------------------------------

__device__ __forceinline__ unsigned long long pair_key(int w, long long i,
                                                       bool is_in) {
  return ((unsigned long long)(unsigned)w << 31) |
         (is_in ? (unsigned long long)(i + 1) : 0ull);
}

// Over the events in stable worker order (sorted_w, order): pair[k] =
// (source event or -1, place q) for row k = row_of[event]; wrange[w] =
// (first place, end place) of worker w's rows, left as it was (0, 0) for a
// worker with no events.  status: ntiles max-key words, ntiles
// switch-out-count words, then the tile ticket.
__global__ void __launch_bounds__(kThreads)
stream_pair(const int* __restrict__ sorted_w,
            const long long* __restrict__ order,
            const int* __restrict__ deltas, const int* __restrict__ row_of,
            int64_t e, int64_t ntiles, unsigned long long* status,
            int2* __restrict__ pair, int* __restrict__ wrange) {
  __shared__ unsigned long long s_wm[kWarps];
  __shared__ int s_wc[kWarps];
  __shared__ unsigned long long s_m;
  __shared__ int s_c;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int64_t tile = take_tile(status + 2 * ntiles);
  const int64_t at = tile * kTile + warp * kWarpSpan + lane * 4;
  unsigned long long* max_words = status;
  unsigned long long* count_words = status + ntiles;

  unsigned long long ex_m[kVecs], run_m = 0;
  int ex_c[kVecs], run_c = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    unsigned long long lm = 0;
    int lc = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t p = at + 128 * j + q;
      if (p < e) {
        const long long i = order[p];
        const bool is_in = deltas[i] > 0;
        lm = max_u64(lm, pair_key(sorted_w[p], i, is_in));
        lc += is_in ? 0 : 1;
      }
    }
    unsigned long long im = lm;
    int ic = lc;
    warp_inclusive_max_sum(im, ic);
    unsigned long long xm = __shfl_up_sync(kFullMask, im, 1);
    int xc = __shfl_up_sync(kFullMask, ic, 1);
    if (lane == 0) {
      xm = 0;
      xc = 0;
    }
    ex_m[j] = max_u64(run_m, xm);
    ex_c[j] = run_c + xc;
    run_m = max_u64(run_m, __shfl_sync(kFullMask, im, 31));
    run_c += __shfl_sync(kFullMask, ic, 31);
  }
  if (lane == 0) {
    s_wm[warp] = run_m;
    s_wc[warp] = run_c;
  }
  __syncthreads();
  unsigned long long off_m = 0, tot_m = 0;
  int off_c = 0, tot_c = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v == warp) {
      off_m = tot_m;
      off_c = tot_c;
    }
    tot_m = max_u64(tot_m, s_wm[v]);
    tot_c += s_wc[v];
  }
  if (warp == 0) {
    unsigned long long pm[1] = {0};
    unsigned pc[1] = {0u};
    if (tile > 0) {
      if (lane == 0) {
        store_status(max_words + tile, status_word(tot_m, kStatusAggregate));
        store_status(count_words + tile,
                     status_word((unsigned)tot_c, kStatusAggregate));
      }
      look_back<unsigned long long, 1, MaxOp>(tile, max_words, pm);
    }
    if (lane == 0)
      store_status(max_words + tile,
                   status_word(max_u64(pm[0], tot_m), kStatusInclusive));
    if (tile > 0) look_back(tile, count_words, pc);
    if (lane == 0) {
      store_status(count_words + tile,
                   status_word(pc[0] + (unsigned)tot_c, kStatusInclusive));
      s_m = pm[0];
      s_c = (int)pc[0];
    }
  }
  __syncthreads();
  const unsigned long long base_m = max_u64(s_m, off_m);
  const int base_c = s_c + off_c;

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    unsigned long long m = max_u64(base_m, ex_m[j]);
    int c = base_c + ex_c[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t p = at + 128 * j + q;
      if (p < e) {
        const long long i = order[p];
        const int w = sorted_w[p];
        const bool is_in = deltas[i] > 0;
        m = max_u64(m, pair_key(w, i, is_in));
        if (!is_in)   // the low 31 bits: the last switch-in's event + 1
          pair[row_of[i]] = make_int2((int)(m & 0x7fffffffull) - 1, c);
        if (p == 0 || sorted_w[p - 1] != w) wrange[2 * (int64_t)w] = c;
        c += is_in ? 0 : 1;
        if (p + 1 == e || sorted_w[p + 1] != w)
          wrange[2 * (int64_t)w + 1] = c;
      }
    }
  }
}

// ---- rows -------------------------------------------------------------------

// Row k: its event out_idx[k], its source and place pair[k], its
// n_at_exit (written by the prepass); global_cm after each event in gcm.
__global__ void __launch_bounds__(kRowThreads)
stream_rows(const float* __restrict__ times, const int* __restrict__ workers,
            const float* __restrict__ gcm, const int* __restrict__ out_idx,
            const int2* __restrict__ pair, int64_t s, Rows rows,
            float* __restrict__ scm_sorted) {
  const int64_t k = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (k >= s) return;
  const int i = out_idx[k];
  const int2 sq = pair[k];
  const float t = times[i];
  const float local = sq.x >= 0 ? gcm[sq.x] : 0.f;
  const float start = sq.x >= 0 ? times[sq.x] : 0.f;
  const float slice = __fsub_rn(gcm[i], local);
  const float dur = __fsub_rn(t, start);
  const int n = rows.n_at_exit[k];
  rows.worker[k] = workers[i];
  rows.start[k] = __fsub_rn(t, dur);    // the reference's t - dur
  rows.end[k] = t;
  rows.cm[k] = slice;
  rows.threads_av[k] = slice > 0.f ? __fdiv_rn(dur, fmaxf(slice, 1e-30f))
                                   : (float)max(n, 1);
  scm_sorted[sq.y] = slice;
}

// ---- cm ---------------------------------------------------------------------

// cm[w]: the sum of scm_sorted[begin:end) in order, wrange[w] = (begin,
// end).  Lane l holds the slices base + 32 r + l (r < 4) of each 128, the
// next 128 loaded before these are added; every lane adds all 128, in
// order, from shuffles, so the warp never diverges.
__global__ void __launch_bounds__(kCmWarps * 32)
stream_cm(const float* __restrict__ scm_sorted, const int* __restrict__ wrange,
          int num_workers, float* __restrict__ cm) {
  const int w = blockIdx.x * kCmWarps + (threadIdx.x >> 5);
  const int lane = lane_id();
  if (w >= num_workers) return;
  const int64_t begin = wrange[2 * (int64_t)w];
  const int64_t end = wrange[2 * (int64_t)w + 1];
  const auto load = [&](int64_t base, float (&v)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t q = base + 32 * r + lane;
      v[r] = q < end ? scm_sorted[q] : 0.f;
    }
  };
  float acc = 0.f, cur[4];
  load(begin, cur);
  for (int64_t base = begin; base < end; base += 128) {
    float nxt[4];
    load(base + 128, nxt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int l = 0; l < 32; ++l)
        acc = __fadd_rn(acc, __shfl_sync(kFullMask, cur[r], l));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) cur[r] = nxt[r];
  }
  if (lane == 0) cm[w] = acc;
}

// The chain's ring takes more than the default 48 KB of dynamic shared
// memory: raise its limit once per device (racing threads at worst repeat
// the call).
cudaError_t allow_chain_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      stream_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, kChainSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Event indices, rows and places are int32, and pair_key's event + 1
// takes 31 bits.
constexpr long long kMaxEvents = (1ll << 31) - 1;

}  // namespace

extern "C" {

// Events per tile of the grid passes: share, idle and gcm hold a whole
// number of tiles, and each grid pass's status a pair of words a tile.
int gapp_stream_tile(void) { return kTile; }

// Events between two of the walk's checkpoints: ckpt holds e rounded up to
// whole tiles over this, plus one, floats.
int gapp_stream_segment(void) { return kSeg; }

// Stage 1.  Over e events (times f32, deltas i32: > 0 switch-in, else
// switch-out): share and idle f32[ntiles * kTile] (each event's share of
// global_cm and of idle, 0 past e; 16-byte aligned); for the k-th
// switch-out, event i: out_idx[k] = i, row_of[i] = k (row_of is left
// unwritten at switch-ins) and n_at_exit[k] = the active count before it.
// Scratch: status uint64[2 * ntiles + 1], zeroed here on the stream.  vec:
// times and deltas are 16-byte aligned.  One memset and one launch.
int gapp_stream_prepass(const float* times, const int* deltas, long long e,
                        float* share, float* idle, int* row_of, int* out_idx,
                        int* n_at_exit, unsigned long long* status, int vec,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (!aligned16(share) || !aligned16(idle))
    return (int)cudaErrorMisalignedAddress;
  const long long ntiles = (e + kTile - 1) / kTile;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(2 * ntiles + 1), st);
  if (err != cudaSuccess) return (int)err;
  stream_prepass<<<(unsigned)ntiles, kThreads, 0, st>>>(
      times, deltas, e, vec, ntiles, status, share, idle, row_of, out_idx,
      n_at_exit);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Stage 2, the walk.  scalars = (idle total, global_cm total), each a
// float32 sum in order, and ckpt[t] = global_cm before event
// gapp_stream_segment() * t (ckpt[0] = 0), over the first e events rounded
// up to whole ring stages of 4,096 (the prepass's padding adds +0.0).
// share and idle 16-byte aligned.  One launch of one block.
int gapp_stream_chain(const float* share, const float* idle, long long e,
                      float* ckpt, float* scalars, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (!aligned16(share) || !aligned16(idle))
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = allow_chain_smem();
  if (err != cudaSuccess) return (int)err;
  const long long nstages = (e + kStage - 1) / kStage;
  stream_chain<<<1, kChainThreads, kChainSmem, st>>>(share, idle, nstages,
                                                     ckpt, scalars);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Stage 2, the expansion.  gcm[i] = global_cm after event i, for the first
// e events rounded up to whole segments, from the walk's ckpt and the
// shares, each segment's adds in the walk's order.  share and gcm
// 16-byte aligned.  One launch.
int gapp_stream_expand(const float* share, const float* ckpt, long long e,
                       float* gcm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (!aligned16(share) || !aligned16(gcm))
    return (int)cudaErrorMisalignedAddress;
  const long long nseg = (e + kSeg - 1) / kSeg;
  stream_expand<<<(unsigned)((nseg + kRowThreads - 1) / kRowThreads),
                  kRowThreads, 0, st>>>(share, ckpt, nseg, gcm);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Stage 3.  Over the e events in stable worker order (sorted_w i32, the
// event indices order i64), with deltas and row_of as the prepass left
// them: pair i32[2 S] = (source event or -1, place) per row; wrange
// i32[2 W] = (begin, end) places per worker, zeroed here first.  Scratch:
// status uint64[2 * ntiles + 1], zeroed here.  Two memsets and one launch.
int gapp_stream_pair(const int* sorted_w, const long long* order,
                     const int* deltas, const int* row_of, long long e,
                     int num_workers, int* pair, int* wrange,
                     unsigned long long* status, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e < 1 || e > kMaxEvents || num_workers < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(pair) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long ntiles = (e + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(2 * ntiles + 1), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(wrange, 0, sizeof(int) * 2 * (size_t)num_workers,
                          st);
  if (err != cudaSuccess) return (int)err;
  stream_pair<<<(unsigned)ntiles, kThreads, 0, st>>>(
      sorted_w, order, deltas, row_of, e, ntiles, status,
      reinterpret_cast<int2*>(pair), wrange);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Stage 4.  The s rows' six columns (n_at_exit is read: the prepass wrote
// it) and scm_sorted[place] = the row's slice cm, from times, workers, the
// chain's gcm, the prepass's out_idx and the pairing's pair.  One launch
// (none when s is 0).
int gapp_stream_rows(const float* times, const int* workers, const float* gcm,
                     const int* out_idx, const int* pair, long long s,
                     int* row_worker, float* row_start, float* row_end,
                     float* row_cm, float* row_threads_av, int* row_n_at_exit,
                     float* scm_sorted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 0 || s > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const Rows rows = {row_worker, row_start, row_end,
                     row_cm, row_threads_av, row_n_at_exit};
  stream_rows<<<(unsigned)((s + kRowThreads - 1) / kRowThreads), kRowThreads,
                0, st>>>(times, workers, gcm, out_idx,
                         reinterpret_cast<const int2*>(pair), s, rows,
                         scm_sorted);
  GAPP_LAUNCH_CHECK();
  return 0;
}

// Stage 5.  cm f32[W]: each worker's places wrange[w] of scm_sorted,
// summed in order from +0.0.  One launch.
int gapp_stream_cm(const float* scm_sorted, const int* wrange,
                   int num_workers, float* cm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_workers < 1) return (int)cudaErrorInvalidValue;
  stream_cm<<<(unsigned)((num_workers + kCmWarps - 1) / kCmWarps),
              kCmWarps * 32, 0, st>>>(scm_sorted, wrange, num_workers, cm);
  GAPP_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
