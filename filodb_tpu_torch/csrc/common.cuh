// Pieces shared by the page-decoding kernels: the width-w field unpack,
// a CTA-wide inclusive scan over shared memory, and a binary search.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace filodb {

constexpr int kBlock = 128;  // lanes (and words) of one page block

// Width-w field of lane `lane` from a block's 128-word row: bits
// [lane*w, lane*w + w). __funnelshift_r is defined for a shift of 0, where
// the reference's `hi << (32 - off)` is not; w = 0 and w = 32 are guarded
// as the JAX code guards them with `where`.
__device__ __forceinline__ uint32_t unpack_field(const uint32_t* row,
                                                 int lane, uint32_t w) {
  if (w == 0) return 0u;
  uint32_t bit0 = static_cast<uint32_t>(lane) * w;
  uint32_t wi = bit0 >> 5;
  uint32_t off = bit0 & 31u;
  uint32_t lo = row[wi];
  uint32_t hi = row[wi + 1 < kBlock ? wi + 1 : kBlock - 1];
  uint32_t v = __funnelshift_r(lo, hi, off);
  uint32_t mask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  return v & mask;
}

struct MaxOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

struct SumOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Inclusive scan of a[0, n) in shared memory by the whole CTA (blockDim.x
// a multiple of 32). Each thread scans a contiguous run, the warps combine
// run totals with shuffles, and warp 0 scans the warp totals. `warp_tot`
// is 32 entries of shared scratch. Every thread of the CTA must call it.
template <typename T, typename Op>
__device__ void block_scan(T* a, int n, T identity, Op op, T* warp_tot) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int seg = (n + nt - 1) / nt;
  const int b = tid * seg;
  const int e = min(b + seg, n);
  T acc = identity;
  for (int i = b; i < e; ++i) {
    acc = op(acc, a[i]);
    a[i] = acc;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T x = acc;
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  T excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nt / 32 ? warp_tot[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(y, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const T off = warp > 0 ? op(warp_tot[warp - 1], excl) : excl;
  if (tid > 0) {
    for (int i = b; i < e; ++i) a[i] = op(off, a[i]);
  }
  __syncthreads();
}

// First index in key[0, n) whose value is > x (key non-decreasing).
__device__ __forceinline__ int upper_bound(const int32_t* key, int n,
                                           int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace filodb

extern "C" const char* filodb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
