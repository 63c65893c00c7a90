// Sample-tag histogram and weighted histogram, for Hopper (sm_90a).
//
// Replaces the TPU kernel _hist_kernel (wrapper hist) of the JAX package's
// kernels/tag_hist.py.  The TPU form compares a block of samples against a
// block of bins as a one-hot matrix and accumulates into an output block
// that stays resident across the TPU's sequential grid.  On Hopper the
// natural shape is a scatter: one thread per sample, atomics into the bins.
// When the bins fit in shared memory (K <= kSmemBins, int count + float sum
// per bin) each block keeps a private copy there and merges its non-zero
// bins into the output with global atomics at the end; otherwise the
// threads add straight into the output (which for K <= 2^20 is 8 MB and
// stays in the 50 MB L2).
//
// Counts are exact.  wsum is a sum of float atomics, whose order varies
// from run to run.  Tags that are negative or >= K are dropped.
//
// Bound: memory.  The function must read tags (i32) and weights (f32) and
// write counts (i32) and wsum (f32): 8 bytes per sample plus 8 per bin.
//
// Plain C interface for ctypes; launches go on the caller's stream and the
// function returns the first launch error (cudaSuccess == 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kSmemBins = 6144;  // 8 bytes a bin: 48 KB of shared memory

__global__ void __launch_bounds__(kHistThreads)
hist_shared(const int* tags, const float* w, long long s, int k, int* counts,
            float* wsum) {
  extern __shared__ unsigned char raw[];
  int* sc = reinterpret_cast<int*>(raw);
  float* sw = reinterpret_cast<float*>(raw + sizeof(int) * k);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    sc[i] = 0;
    sw[i] = 0.f;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < s;
       i += stride) {
    const int t = tags[i];
    if (t >= 0 && t < k) {
      atomicAdd(&sc[t], 1);
      atomicAdd(&sw[t], w ? w[i] : 1.f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int c = sc[i];
    if (c) {
      atomicAdd(&counts[i], c);
      atomicAdd(&wsum[i], sw[i]);
    }
  }
}

__global__ void __launch_bounds__(kHistThreads)
hist_global(const int* tags, const float* w, long long s, int k, int* counts,
            float* wsum) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < s;
       i += stride) {
    const int t = tags[i];
    if (t >= 0 && t < k) {
      atomicAdd(&counts[t], 1);
      atomicAdd(&wsum[t], w ? w[i] : 1.f);
    }
  }
}

}  // namespace

extern "C" {

// counts[b] = #{i : tags[i] == b}, wsum[b] = sum of w[i] over those i, for
// b in [0, k); w may be null (every weight 1).  num_sms sizes the grid.
int gapp_tag_hist(const int* tags, const float* w, long long s, int k,
                  int* counts, float* wsum, int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)k, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(wsum, 0, sizeof(float) * (size_t)k, st);
  if (err != cudaSuccess || s == 0) return (int)err;
  const long long needed = (s + kHistThreads - 1) / kHistThreads;
  if (k <= kSmemBins) {
    const long long cap = 8LL * num_sms;
    const unsigned grid = (unsigned)(needed < cap ? needed : cap);
    hist_shared<<<grid, kHistThreads, (size_t)k * 8, st>>>(tags, w, s, k,
                                                          counts, wsum);
  } else {
    const long long cap = 32LL * num_sms;
    const unsigned grid = (unsigned)(needed < cap ? needed : cap);
    hist_global<<<grid, kHistThreads, 0, st>>>(tags, w, s, k, counts, wsum);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
