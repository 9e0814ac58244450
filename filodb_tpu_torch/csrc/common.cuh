// Pieces shared by the page-decoding kernels: the width-w field unpack,
// 16-byte asynchronous copies into shared memory, a warp-wide inclusive
// scan, and a binary search over 128 keys.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace filodb {

constexpr int kBlock = 128;  // lanes (and words) of one page block
constexpr unsigned kFullMask = 0xffffffffu;

// Width-w field of lane `lane` from a block's 128-word row: bits
// [lane*w, lane*w + w). __funnelshift_r is defined for a shift of 0, where
// the reference's `hi << (32 - off)` is not; w = 0 and w = 32 are guarded
// as the JAX code guards them with `where`. A field that starts in the
// row's last needed word (4*w - 1) ends at that word's end, so the bits of
// the following word are masked off whatever it holds.
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

// 16 bytes from device memory into shared memory, asynchronously (both
// addresses 16-byte aligned). Completes at cp_async_wait.
__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct MaxOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

struct SumOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Inclusive scan of one value a lane across the full warp (shuffles only).
template <typename T, typename Op>
__device__ __forceinline__ T warp_inclusive_scan(T x, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x = op(y, x);
  }
  return x;
}

// 128 sorted keys kept in breadth-first (Eytzinger) order for the binary
// search below: the keys a search step can probe sit side by side, so the
// lanes of a warp searching for different x read distinct banks, where the
// sorted order puts every probe of a step in one bank. Slot of sorted index
// i: the search probes index (2m+1)*2^(6-L) - 1 at level L, kept at slot
// 2^L - 1 + m; index 127, never probed, keeps slot 127.
__device__ __forceinline__ int eytzinger_slot(int i) {
  const int v = i + 1;
  const int tz = __ffs(v) - 1;
  return tz >= 7 ? 127 : (1 << (6 - tz)) - 1 + (v >> (tz + 1));
}

// Number of keys <= x among 128 non-decreasing keys of which the last is
// > x: seven fixed steps of binary lifting, no loop to branch on.
__device__ __forceinline__ int count_le_128(const int32_t* key, int32_t x) {
  int pos = 0;
#pragma unroll
  for (int s = 64; s > 0; s >>= 1) pos += key[pos + s - 1] <= x ? s : 0;
  return pos;
}

// count_le_128 over keys kept in eytzinger_slot order.
__device__ __forceinline__ int count_le_eytzinger_128(const int32_t* eyt,
                                                      int32_t x) {
  int m = 0;
#pragma unroll
  for (int level = 0; level < 7; ++level)
    m = 2 * m + (eyt[(1 << level) - 1 + m] <= x ? 1 : 0);
  return m;
}

}  // namespace filodb

extern "C" const char* filodb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
