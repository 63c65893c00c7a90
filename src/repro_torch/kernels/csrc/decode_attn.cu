// Decode attention over a KV cache, split over the cache's rows, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves decode attention to XLA.
// The port's plain form (models/attention.py::_sdpa_math over a validity
// mask of the whole cache) cast the whole cache to float32, made permuted
// copies of k and v for the score products, and ran the mask, softmax and
// two batched GEMVs over every slot: ~9x the bytes of one pass over the
// cache, most of them over rows the mask zeroes.
//
// The function: for each slot b and query head h (kv head h / g, g = H /
// KV), softmax(softcap(q_h . k_r) for r in [lo, hi]) weighted over v_r,
// where [lo, hi] = [max(0, pos - window + 1), min(L - 1, pos)] is the
// slot's written interval of cache rows.  Every other row's score is the
// mask's -2.38e38 in the plain form, whose weight exp(s - m) is exactly 0
// in float32, so it is skipped here.  An empty interval (pos past the end
// of a ring by a window, or pos < 0) leaves every score masked, which the
// plain softmax weighs uniformly: the mean of v over all L rows; here every
// row's score is 0 then ("flat").
//
// Arithmetic: q scaled by 1/sqrt(hd) in its own dtype; q . k as float32
// products of the stored values, summed in float32; softcap and softmax in
// float32 (exp2f of log2(e)-scaled scores); the weights against v in
// float32 (the plain form rounds them to the dtype), the weighted sum in
// float32, rounded to the cache's dtype once.
//
// Bound: memory.  A step must read each slot's written K and V rows once:
// 2 x rows x KV x hd x 2 bytes in bf16 (q, the partials and the output
// are ~1% beside that at the cells' shape).  The design:
//
// - Phase 1 (decode_attn_split): a grid over (kv head x head chunk, split
//   of the cache rows, slot).  A block intersects its split with the slot's
//   interval and exits at once if that is empty; pos is read on the device.
//   The kv head is the fastest grid index, so blocks that run together read
//   neighbouring heads of the same rows.  Lanes of a warp share a row
//   (hd / 8 lanes in bf16, 16-byte loads, at most 32), so a warp takes
//   32 x 8 / hd rows at a time; each lane keeps a running max, sum and
//   weighted V sum (float32) for each query head of its chunk (up to 8), and
//   keeps kUnroll rows' K and V loads in flight before using them.  Lane
//   groups and warps are merged at the block's end (shuffles, then shared
//   memory) into one (m, l, o[hd]) partial per query head and split.
// - Phase 2 (decode_attn_combine): a warp per (slot, query head) combines
//   the splits that intersect the interval by flash-decode's two-pass rule
//   (models/attention.py::flash_combine's arithmetic, with no collectives):
//   M = max m_s, out = sum(o_s 2^(m_s - M)) / sum(l_s 2^(m_s - M)).
//
// The split length, the head chunk and the grid are chosen by the wrapper
// from the shapes (kernels/decode_attn.py::plan).
//
// Plain C interface for ctypes.  Both launches go on the caller's stream;
// the function returns the first launch error (cudaSuccess == 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gapp::kFullMask;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// The slot's written interval of cache rows [lo, hi]; flat when it is
// empty, and then every row, each weighing the same.
struct Interval {
  int64_t lo, hi;
  bool flat;
};

__device__ __forceinline__ Interval written(int pos, int length, int window) {
  const int64_t p = pos, last = (int64_t)length - 1;
  const int64_t lo = window > 0 && p - window + 1 > 0 ? p - window + 1 : 0;
  const int64_t hi = p < last ? p : last;
  if (lo > hi) return {0, last, true};
  return {lo, hi, false};
}

// exp2(m - top), 0 for an empty part (m = -inf, whatever top is).
__device__ __forceinline__ float rescale(float m, float top) {
  return m == -INFINITY ? 0.f : exp2f(m - top);
}

// 16 bytes at p, as one load when vec is set (every pointer 16-byte
// aligned), else as 2-byte loads (both dtypes are 2-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint4 r;
  r.x = s[0] | ((unsigned)s[1] << 16);
  r.y = s[2] | ((unsigned)s[3] << 16);
  r.z = s[4] | ((unsigned)s[5] << 16);
  r.w = s[6] | ((unsigned)s[7] << 16);
  return r;
}

template <typename T>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;  // elements in 16 bytes
  static __device__ __forceinline__ void unpack(uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // x rounded to the dtype, as a float
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

// How a warp covers rows of head dim HD: kLanes lanes a row, each with
// kLoads 16-byte loads (kElems elements), kRows rows at a time.  Lane li
// of a row holds elements (j * kLanes + li) * kVec + t, t < kVec.
template <typename T, int HD>
struct Rows {
  static constexpr int kVec = Elt<T>::kVec;
  static constexpr int kLanes = HD / kVec < 32 ? HD / kVec : 32;
  static constexpr int kLoads = HD / (kLanes * kVec);
  static constexpr int kElems = kLoads * kVec;
  static constexpr int kRows = 32 / kLanes;
  static_assert(kLoads * kLanes * kVec == HD, "head dim");
};

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads) decode_attn_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, float2* __restrict__ part_ml,
    float* __restrict__ part_o, int length, int kv_heads, int heads,
    int nchunk, int window, float softcap, float scale, int split,
    int nsplit, int vec) {
  using R = Rows<T, HD>;
  constexpr int kUnroll = GC >= 4 ? 2 : 4;
  constexpr int kStep = kWarps * R::kRows * kUnroll;  // rows an iteration
  const int kh = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int s = blockIdx.y, b = blockIdx.z;
  const Interval iv = written(pos[b], length, window);
  const int64_t s_lo = (int64_t)s * split, s_hi = s_lo + split - 1;
  const int64_t r_lo = iv.lo > s_lo ? iv.lo : s_lo;
  const int64_t r_hi = iv.hi < s_hi ? iv.hi : s_hi;
  if (r_lo > r_hi) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / R::kLanes, li = lane % R::kLanes;
  const int g = heads / kv_heads;

  // this lane's elements of each query head of the chunk, scaled in the
  // dtype (heads past the group's are zeros and are not written)
  float qf[GC][R::kElems];
#pragma unroll
  for (int c = 0; c < GC; ++c) {
    const int hin = chunk * GC + c;
#pragma unroll
    for (int j = 0; j < R::kLoads; ++j) {
      float x[R::kVec];
      if (hin < g) {
        const T* qp = q + ((int64_t)b * heads + (int64_t)kh * g + hin) * HD +
                      (j * R::kLanes + li) * R::kVec;
        Elt<T>::unpack(load16(qp, vec), x);
      }
#pragma unroll
      for (int t = 0; t < R::kVec; ++t)
        qf[c][j * R::kVec + t] = hin < g ? Elt<T>::round(x[t] * scale) : 0.f;
    }
  }

  float m[GC], l[GC], o[GC][R::kElems];
#pragma unroll
  for (int c = 0; c < GC; ++c) {
    m[c] = -INFINITY;
    l[c] = 0.f;
#pragma unroll
    for (int e = 0; e < R::kElems; ++e) o[c][e] = 0.f;
  }

  const int64_t row_stride = (int64_t)kv_heads * HD;
  const int64_t base = ((int64_t)b * length * kv_heads + kh) * HD +
                       li * R::kVec;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int64_t r0 = r_lo; r0 <= r_hi; r0 += kStep) {
    uint4 kr[kUnroll][R::kLoads], vr[kUnroll][R::kLoads];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r0 + (u * kWarps + warp) * R::kRows + rg;
      ok[u] = row <= r_hi;
      const int64_t off = (ok[u] ? row : r_hi) * row_stride;
#pragma unroll
      for (int j = 0; j < R::kLoads; ++j) {
        kr[u][j] = load16(kb + off + j * R::kLanes * R::kVec, vec);
        vr[u][j] = load16(vb + off + j * R::kLanes * R::kVec, vec);
      }
    }
    float sc[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[R::kElems];
#pragma unroll
      for (int j = 0; j < R::kLoads; ++j)
        Elt<T>::unpack(kr[u][j], kf + j * R::kVec);
#pragma unroll
      for (int c = 0; c < GC; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < R::kElems; ++e) acc = fmaf(qf[c][e], kf[e], acc);
#pragma unroll
        for (int off = R::kLanes / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFullMask, acc, off);
        if (softcap > 0.f) acc = tanhf(acc / softcap) * softcap;
        acc = iv.flat ? 0.f : acc * kLog2e;
        sc[u][c] = ok[u] ? acc : -INFINITY;
      }
    }
#pragma unroll
    for (int c = 0; c < GC; ++c) {
      float top = m[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) top = fmaxf(top, sc[u][c]);
      const float a = rescale(m[c], top);
      l[c] *= a;
#pragma unroll
      for (int e = 0; e < R::kElems; ++e) o[c][e] *= a;
      m[c] = top;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[R::kElems];
#pragma unroll
      for (int j = 0; j < R::kLoads; ++j)
        Elt<T>::unpack(vr[u][j], vf + j * R::kVec);
#pragma unroll
      for (int c = 0; c < GC; ++c) {
        const float p = ok[u] ? exp2f(sc[u][c] - m[c]) : 0.f;
        l[c] += p;
#pragma unroll
        for (int e = 0; e < R::kElems; ++e) o[c][e] = fmaf(p, vf[e], o[c][e]);
      }
    }
  }

  // merge the warp's row groups (lanes li of each group hold the same
  // elements), then the warps
#pragma unroll
  for (int off = R::kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < GC; ++c) {
      const float mo = __shfl_xor_sync(kFullMask, m[c], off);
      const float lo = __shfl_xor_sync(kFullMask, l[c], off);
      const float top = fmaxf(m[c], mo);
      const float a = rescale(m[c], top), bo = rescale(mo, top);
      l[c] = l[c] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < R::kElems; ++e)
        o[c][e] = o[c][e] * a + __shfl_xor_sync(kFullMask, o[c][e], off) * bo;
      m[c] = top;
    }
  }
  __shared__ float sm_m[kWarps][GC], sm_l[kWarps][GC];
  __shared__ float sm_o[kWarps][GC][HD];
  if (rg == 0) {
#pragma unroll
    for (int c = 0; c < GC; ++c) {
      if (li == 0) {
        sm_m[warp][c] = m[c];
        sm_l[warp][c] = l[c];
      }
#pragma unroll
      for (int j = 0; j < R::kLoads; ++j)
#pragma unroll
        for (int t = 0; t < R::kVec; ++t)
          sm_o[warp][c][(j * R::kLanes + li) * R::kVec + t] =
              o[c][j * R::kVec + t];
    }
  }
  __syncthreads();
  // warp 0's first row group covered row r_lo, so top is finite
  for (int i = threadIdx.x; i < GC * HD; i += kThreads) {
    const int c = i / HD, e = i % HD, hin = chunk * GC + c;
    if (hin >= g) continue;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) top = fmaxf(top, sm_m[w][c]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = rescale(sm_m[w][c], top);
      sum += sm_l[w][c] * a;
      acc += sm_o[w][c][e] * a;
    }
    const int64_t at =
        ((int64_t)b * heads + (int64_t)kh * g + hin) * nsplit + s;
    part_o[at * HD + e] = acc;
    if (e == 0) part_ml[at] = make_float2(top, sum);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attn_combine(
    const int* __restrict__ pos, const float2* __restrict__ part_ml,
    const float* __restrict__ part_o, T* __restrict__ out, int batch,
    int length, int heads, int window, int split, int nsplit) {
  constexpr int kPer = (HD + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t bh = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bh >= (int64_t)batch * heads) return;
  const Interval iv = written(pos[bh / heads], length, window);
  const int s0 = (int)(iv.lo / split), s1 = (int)(iv.hi / split);
  const float2* ml = part_ml + bh * nsplit;
  const float* po = part_o + bh * nsplit * HD;
  float top = -INFINITY;
  for (int s = s0 + lane; s <= s1; s += 32) top = fmaxf(top, ml[s].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(kFullMask, top, off));
  float sum = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = s0; s <= s1; ++s) {
    const float2 x = ml[s];
    const float a = exp2f(x.x - top);
    sum += x.y * a;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < HD) acc[i] += po[(int64_t)s * HD + e] * a;
    }
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    if (e < HD) out[bh * HD + e] = Elt<T>::store(acc[i] * inv);
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  float2* part_ml;
  float* part_o;
  void* out;
  int batch, length, kv_heads, heads, head_dim, window;
  float softcap, scale;
  int split, nsplit, gc, vec;
  cudaStream_t stream;
};

template <typename T, int HD, int GC>
int launch(const Args& a) {
  const int nchunk = (a.heads / a.kv_heads + GC - 1) / GC;
  const dim3 grid(a.kv_heads * nchunk, a.nsplit, a.batch);
  decode_attn_split<T, HD, GC><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pos, a.part_ml, a.part_o, a.length,
      a.kv_heads, a.heads, nchunk, a.window, a.softcap, a.scale, a.split,
      a.nsplit, a.vec);
  GAPP_LAUNCH_CHECK();
  const int64_t pairs = (int64_t)a.batch * a.heads;
  decode_attn_combine<T, HD><<<(unsigned)((pairs + kWarps - 1) / kWarps),
                               kThreads, 0, a.stream>>>(
      a.pos, a.part_ml, a.part_o, static_cast<T*>(a.out), a.batch, a.length,
      a.heads, a.window, a.split, a.nsplit);
  GAPP_LAUNCH_CHECK();
  return 0;
}

template <typename T, int HD>
int by_chunk(const Args& a) {
  switch (a.gc) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_head_dim(const Args& a) {
  switch (a.head_dim) {
    case 16: return by_chunk<T, 16>(a);
    case 64: return by_chunk<T, 64>(a);
    case 128: return by_chunk<T, 128>(a);
    case 256: return by_chunk<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out[b, 0, h] = softmax over the written rows of slot b of q[b, 0, h]'s
// scores against k, weighted over v (see the top of this file).  q, out:
// (B, 1, H, hd); k, v: (B, L, KV, hd), all contiguous in one dtype (is_f32:
// float32, else bfloat16); pos: int32[B]; window <= 0: none; softcap <= 0:
// none; scale: 1/sqrt(hd).  part_ml (float2[B, H, nsplit]) and part_o
// (float[B, H, nsplit, hd]) are scratch, split * nsplit >= L; gc: query
// heads a block takes (1, 2, 4 or 8); vec: q, k and v 16-byte aligned.
// Two kernel launches.
int gapp_decode_attn(const void* q, const void* k, const void* v,
                     const void* pos, void* part_ml, void* part_o, void* out,
                     int batch, int length, int kv_heads, int heads,
                     int head_dim, int is_f32, int window, float softcap,
                     float scale, int split, int nsplit, int gc, int vec,
                     void* stream) {
  const Args a{q, k, v, static_cast<const int*>(pos),
               static_cast<float2*>(part_ml), static_cast<float*>(part_o),
               out, batch, length, kv_heads, heads, head_dim, window,
               softcap, scale, split, nsplit, gc, vec,
               static_cast<cudaStream_t>(stream)};
  return is_f32 ? by_head_dim<float>(a) : by_head_dim<__nv_bfloat16>(a);
}

}  // extern "C"
