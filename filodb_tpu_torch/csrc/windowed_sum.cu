// Windowed sum over (t-w, t] for every series and step (B4).
//
// Replaces: filodb_tpu/query/engine/pallas_kernels.py::windowed_sum_pallas
// (_windowed_sum_kernel).
//
// Computes out[p, k] = sum of vals[p, i] over lanes with
// steps[k] - window < ts[p, i] <= steps[k]; an empty window gives 0.0, not
// NaN (callers apply the NaN mask). Masking is by timestamp only: padded
// lanes carry TS_PAD (int32 max), past every step.
//
// Bound on this card: bytes. Each series reads 8 bytes a sample and writes
// 4 bytes a step; a step's sum touches only its window's samples.
//
// Design: one CTA per series with its timestamps and values staged in
// shared memory. The TPU kernel reduces over all S lanes for each step; here
// each step finds its window by binary search, over a key that is the
// running max of the non-padded timestamps (so padded lanes inside the row
// inherit the previous timestamp and the key is sorted while the real
// timestamps are non-decreasing, which assemble guarantees), then one
// thread adds the window's samples whose own timestamp passes the mask.
//
// Order of summation: each window's samples are added one at a time in
// sample order, in float32, starting from 0.0. The plain version
// (cuda_kernels.windowed_sum_plain) adds in the same order, so the two agree
// bit for bit; against the TPU kernel's lane reduction they agree to
// float32 rounding (rtol 1e-5 in the tests).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using filodb::block_scan;
using filodb::MaxOp;
using filodb::upper_bound;

constexpr int kThreads = 256;
constexpr int32_t kTsPad = 2147483647;
constexpr int32_t kKeyMin = -2147483647 - 1;

__global__ void __launch_bounds__(kThreads)
windowed_sum_kernel(const int32_t* __restrict__ ts,
                    const float* __restrict__ vals,
                    const int32_t* __restrict__ steps, int K, int32_t window,
                    int S, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* key = reinterpret_cast<int32_t*>(smem);
  int32_t* sts = key + S;
  float* sv = reinterpret_cast<float*>(sts + S);
  __shared__ int32_t warp_i[32];

  const long long p = blockIdx.x;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int32_t t = ts[p * S + i];
    sts[i] = t;
    key[i] = t == kTsPad ? kKeyMin : t;
    sv[i] = vals[p * S + i];
  }
  __syncthreads();
  block_scan(key, S, kKeyMin, MaxOp(), warp_i);

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int32_t t = steps[k];
    const int32_t t0 = t - window;
    const int lo = upper_bound(key, S, t0);
    const int hi = upper_bound(key, S, t);
    float acc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      if (sts[i] > t0 && sts[i] <= t) acc = acc + sv[i];
    }
    out[p * K + k] = acc;
  }
}

}  // namespace

extern "C" {

// ts i32 [P, S], vals f32 [P, S], steps i32 [K] -> out f32 [P, K]
int windowed_sum(const void* ts, const void* vals, const void* steps,
                 long long K, long long window, long long P, long long S,
                 void* out, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>(S) * 12;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        windowed_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  windowed_sum_kernel<<<static_cast<unsigned>(P), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const float*>(vals),
      static_cast<const int32_t*>(steps), static_cast<int>(K),
      static_cast<int32_t>(window), static_cast<int>(S),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
