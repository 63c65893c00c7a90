// The paper-faithful streaming CMetric scan, for Hopper (sm_90a).
//
// Replaces the JAX package's _streaming_scan (core/cmetric.py), which is
// not a Pallas kernel but a lax.scan: one step is one run of the
// sched_switch probe, with the Table-1 eBPF-map state (global_cm, idle,
// thread_count, t_switch and the per-worker local_cm, slice start and
// cm_hash) as its carry.  A launch per event would be 2^24 launches for a
// 2^24-event log; here one launch of one block walks the whole log.
//
// What has to stay sequential is only the float32 chain: global_cm and
// idle are running float32 sums in event order, and each worker's state is
// read and written in event order.  Everything else about an event is
// known without the chain.  So the block takes the log in tiles of 4,096
// events staged in shared memory, and each tile goes through three phases:
//
//   A (all 512 threads)  a scan of the deltas gives each event the active
//                        count before it and, for a switch-out, its output
//                        row; each event's share of global_cm (dt / count
//                        while count > 0) and of idle (dt while count == 0)
//                        is computed in parallel;
//   B (thread 0)         the walk: global_cm and idle each take one add per
//                        event, a switch-in stores (global_cm, t) for its
//                        worker, a switch-out reads them, adds its slice to
//                        the worker's CMetric and leaves its slice cm and
//                        duration in the tile;
//   C (all threads)      each switch-out's row: threads_av (a division) and
//                        the six columns, written to row k (the k-th
//                        switch-out), so the slice table comes out compact.
//
// A tile event is one 16-byte record (share, idle, t, worker << 1 | in) and
// a worker's state one 16-byte record (local_cm, start, cm, unused), so the
// walk reads an event and a worker's state with one load each and writes
// the state with one store.  The state lives in shared memory while it fits
// (kSmemWorkers workers), in a global scratch array the wrapper passes
// otherwise.  In phases A and C lane l of warp v takes the events
// 256 v + 32 j + l (j < 8): neighbouring lanes, neighbouring records.
//
// Bound: the dependent chain, not the bytes.  The function must move 12
// bytes an event in and 24 bytes a slice out (~24 B/event with one slice
// per two events), 0.12 ms at 2^24 on 3.35 TB/s; but global_cm is a chain
// of E float32 adds in series (~34 ms at 2^24 with a 4-cycle FADD at
// 1.98 GHz).  The walk is one thread issuing ~30 instructions an event (the
// loads, stores and selects around the two adds), so it runs well above
// that chain; phases A and C do not overlap it (the block waits at a
// barrier around the walk).
//
// Rounding: every float operation is an explicitly rounded intrinsic
// (__fadd_rn, __fsub_rn, __fdiv_rn) and every conditional a select, so
// nvcc's default -fmad=true cannot contract anything into an FMA; the
// shares, sums and slices are the reference's float32 values, in its
// order.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream;
// the function returns the launch error (cudaSuccess == 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using gapp::kFullMask;
using gapp::lane_id;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                                   // events a thread
constexpr int kTile = kThreads * kPer;                    // 4,096 events
constexpr int kWarpSpan = kTile / kWarps;                 // 256 events
constexpr int kTileBytes = kTile * 16;                    // 64 KB
constexpr int kSmemWorkers = 10240;                       // 160 KB of state
constexpr int kMaxSmem = kTileBytes + kSmemWorkers * 16;  // 224 KB

struct Rows {
  int* worker;
  float* start;
  float* end;
  float* cm;
  float* threads_av;
  int* n_at_exit;
  long long capacity;
};

__device__ __forceinline__ int worker_of(float bits) {
  return __float_as_int(bits) >> 1;
}

__device__ __forceinline__ bool is_in(float bits) {
  return __float_as_int(bits) & 1;
}

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

// Phase B: the sequential walk of one tile, software-pipelined so that no
// load waits on the chain: while event i is folded, the record of event
// i + 3 and the worker state of event i + 2 are being loaded.  A state
// load is issued before the stores of the two events ahead of it, so
// where either of them belongs to the same worker, the value it wrote is
// forwarded from registers instead (the later one first).  The loop has no
// branch (a branch in the one active thread costs the warp a reconvergence
// barrier per event).  Nothing is reassociated: global_cm and idle take
// the same adds in the same order, and each worker's state goes through
// the same values.
__device__ __forceinline__ void walk(float4* ev, float4* state, int n,
                                     float& gcm, float& idle) {
  const auto at = [&](int i) { return ev[min(i, n - 1)]; };
  float4 cur = at(0), e1 = at(1), e2 = at(2);
  float4 s = state[worker_of(cur.w)];   // event 0's, complete
  float4 l1 = state[worker_of(e1.w)];   // event 1's as loaded, before 0
  int w_prev = -1;                      // event i - 1's worker, state after
  float4 after_prev = s;
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float4 e3 = at(i + 3);        // past the end: harmless re-reads
    const float4 l2 = state[worker_of(e2.w)];  // before i and i + 1 store
    const int wi = worker_of(cur.w);
    const bool in = is_in(cur.w);
    gcm = __fadd_rn(gcm, cur.x);
    idle = __fadd_rn(idle, cur.y);
    const float slice_cm = __fsub_rn(gcm, s.x);
    const float dur = __fsub_rn(cur.z, s.y);
    const float c_out = __fadd_rn(s.z, slice_cm);
    const float4 after = make_float4(in ? gcm : s.x, in ? cur.z : s.y,
                                     in ? s.z : c_out, 0.f);
    state[wi] = after;
    // a switch-out's slice cm and duration, handed to phase C
    *reinterpret_cast<float2*>(&ev[i]) = make_float2(slice_cm, dur);
    // event i + 1's state: written by event i, by event i - 1, or loaded
    const int w1 = worker_of(e1.w);
    const float4 s1 = w1 == wi ? after : w1 == w_prev ? after_prev : l1;
    w_prev = wi;
    after_prev = after;
    cur = e1;
    s = s1;
    e1 = e2;
    l1 = l2;
    e2 = e3;
  }
}

// kShared: the worker state in shared memory (derived from the block's
// shared array, so the compiler emits shared loads and stores for it);
// else in gstate.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
stream_walk(const float* __restrict__ times, const int* __restrict__ workers,
            const int* __restrict__ deltas, long long e, int num_workers,
            float4* gstate, float* cm_out, float* scalars, Rows rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ev = reinterpret_cast<float4*>(smem);
  float4* state = kShared ? ev + kTile : gstate;
  __shared__ int2 warp_tot[kWarps];
  __shared__ int count_in;          // the active count entering the tile
  __shared__ long long row_base;    // the switch-outs before the tile
  __shared__ float t_last;          // the last time before the tile
  const int w = num_workers;
  for (int i = threadIdx.x; i < w; i += kThreads)
    state[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    count_in = 0;
    row_base = 0;
    t_last = times[0];              // the first dt is 0
  }
  float gcm = 0.f, idle = 0.f;      // the walk's carry, in thread 0
  const int warp = threadIdx.x / 32;
  const int first = warp * kWarpSpan + lane_id();   // + 32 j
  for (long long base = 0; base < e; base += kTile) {
    const int n = (int)min((long long)kTile, e - base);
    __syncthreads();                // the previous tile is done
    for (int i = threadIdx.x; i < n; i += kThreads) {
      ev[i] = make_float4(0.f, 0.f, times[base + i],
                          __int_as_float(workers[base + i] << 1 |
                                         (deltas[base + i] > 0)));
    }
    __syncthreads();

    // -- phase A: counts, row numbers and shares, in parallel
    int step[kPer], outs[kPer];     // exclusive prefixes within the warp
    int run_step = 0, run_outs = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = first + 32 * j;
      const bool in = i < n && is_in(ev[i].w);
      const int a = i < n ? (in ? 1 : -1) : 0;
      const int b = i < n && !in ? 1 : 0;
      const int2 incl = warp_inclusive2(a, b);
      step[j] = run_step + incl.x - a;
      outs[j] = run_outs + incl.y - b;
      run_step += __shfl_sync(kFullMask, incl.x, 31);
      run_outs += __shfl_sync(kFullMask, incl.y, 31);
    }
    if (lane_id() == 0) warp_tot[warp] = make_int2(run_step, run_outs);
    __syncthreads();
    int2 before = make_int2(count_in, 0);
    int2 total = make_int2(0, 0);
    for (int v = 0; v < kWarps; ++v) {
      const int2 t = warp_tot[v];
      if (v < warp) {
        before.x += t.x;
        before.y += t.y;
      }
      total.x += t.x;
      total.y += t.y;
    }
    const long long rows0 = row_base + before.y;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = first + 32 * j;
      const int count = before.x + step[j];   // the count before event i
      step[j] = count;
      if (i < n) {
        const float t = ev[i].z;
        const float dt = __fsub_rn(t, i > 0 ? ev[i - 1].z : t_last);
        const float q = __fdiv_rn(dt, (float)max(count, 1));
        ev[i].x = count > 0 ? q : 0.f;
        ev[i].y = count > 0 ? 0.f : dt;
      }
    }
    __syncthreads();

    // -- phase B: the walk
    if (threadIdx.x == 0) walk(ev, state, n, gcm, idle);
    __syncthreads();

    // -- phase C: the switch-outs' rows, in parallel
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = first + 32 * j;
      const long long k = rows0 + outs[j];
      if (i < n && !is_in(ev[i].w) && k < rows.capacity) {
        const float4 r = ev[i];   // (slice cm, duration, t, worker bits)
        rows.worker[k] = worker_of(r.w);
        rows.start[k] = __fsub_rn(r.z, r.y);    // the reference's t - dur
        rows.end[k] = r.z;
        rows.cm[k] = r.x;
        rows.threads_av[k] = r.x > 0.f
                                 ? __fdiv_rn(r.y, fmaxf(r.x, 1e-30f))
                                 : (float)max(step[j], 1);
        rows.n_at_exit[k] = step[j];
      }
    }
    if (threadIdx.x == 0) {         // read again only in the next tile's A
      count_in += total.x;
      row_base += total.y;
      t_last = ev[n - 1].z;
    }
  }
  __syncthreads();                  // thread 0's state writes are visible
  for (int i = threadIdx.x; i < w; i += kThreads) cm_out[i] = state[i].z;
  if (threadIdx.x == 0) {
    scalars[0] = idle;
    scalars[1] = gcm;
  }
}

// The tile and the state take more than the default 48 KB of dynamic
// shared memory: raise both kernels' limit once per device.
cudaError_t allow_stream_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(stream_walk<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_walk<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

// Most workers whose state the walk keeps in shared memory; above it the
// caller passes gstate.
int gapp_stream_smem_workers(void) { return kSmemWorkers; }

// Walk e > 0 events (times f32, workers i32 in [0, num_workers), which
// the caller checks; deltas i32: > 0 switch-in, else switch-out) in order.  Writes cm_out f32[W]
// (per-worker CMetric), scalars f32[2] = (idle, global_cm) and the first
// `capacity` slice rows (one a switch-out, in event order).  gstate is
// f32[4 W] scratch, 16-byte aligned, when W > gapp_stream_smem_workers(),
// else null.  One launch.
int gapp_stream_scan(const float* times, const int* workers,
                     const int* deltas, long long e, int num_workers,
                     float* gstate, float* cm_out, float* scalars,
                     int* row_worker, float* row_start, float* row_end,
                     float* row_cm, float* row_threads_av,
                     int* row_n_at_exit, long long capacity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows = {row_worker, row_start, row_end, row_cm,
                     row_threads_av, row_n_at_exit, capacity};
  const bool in_smem = gstate == nullptr;
  if (in_smem && num_workers > kSmemWorkers) return (int)cudaErrorInvalidValue;
  if (!in_smem && reinterpret_cast<uintptr_t>(gstate) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = kTileBytes + (in_smem ? (size_t)num_workers * 16 : 0);
  const cudaError_t err = allow_stream_smem();
  if (err != cudaSuccess) return (int)err;
  if (in_smem)
    stream_walk<true><<<1, kThreads, smem, s>>>(
        times, workers, deltas, e, num_workers, nullptr, cm_out, scalars,
        rows);
  else
    stream_walk<false><<<1, kThreads, smem, s>>>(
        times, workers, deltas, e, num_workers,
        reinterpret_cast<float4*>(gstate), cm_out, scalars, rows);
  GAPP_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
