// Pieces shared by the page-decoding kernels: the width-w field unpack (one
// field, or four neighbouring ones), 16-byte asynchronous copies into
// shared memory, a warp-wide inclusive scan, and a binary search over 128
// keys.
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

// The four width-w fields 4j..4j+3 of a block's word row (w <= 32; the row
// readable up to word 4j*w/32 + 4, so a 128-word row needs one pad word).
// Their 4*w <= 128 bits start at bit 4j*w and span at most five words,
// each read once: shifted right by the start's offset, the five give a
// 128-bit value y0..y3 whose bits [k*w, k*w + w) are field k.
// __funnelshift_rc clamps its shift at 32, so w = 32 takes whole words.
// `mask` is the width mask (0 at w = 0, all ones at w = 32); it drops every
// bit past a field, and since field 127 ends at bit 128*w, the words of the
// row from 4*w on never show in a result, whatever they hold.
__device__ __forceinline__ void unpack_four(const uint32_t* row, int j,
                                            uint32_t w, uint32_t mask,
                                            uint32_t f[4]) {
  const uint32_t bit0 = 4u * static_cast<uint32_t>(j) * w;
  const uint32_t* at = row + (bit0 >> 5);
  const uint32_t off = bit0 & 31u;
  const uint32_t x0 = at[0], x1 = at[1], x2 = at[2], x3 = at[3], x4 = at[4];
  const uint32_t y0 = __funnelshift_r(x0, x1, off);
  const uint32_t y1 = __funnelshift_r(x1, x2, off);
  const uint32_t y2 = __funnelshift_r(x2, x3, off);
  const uint32_t y3 = __funnelshift_r(x3, x4, off);
  // field 1 starts at bit w <= 32, field 2 at 2w <= 64, field 3 at 3w <= 96
  const uint32_t s2 = 2u * w, s3 = 3u * w;
  f[0] = y0 & mask;
  f[1] = __funnelshift_rc(y0, y1, w) & mask;
  f[2] = (s2 >= 32u ? __funnelshift_rc(y1, y2, s2 - 32u)
                    : __funnelshift_rc(y0, y1, s2)) & mask;
  f[3] = (s3 >= 64u   ? __funnelshift_rc(y2, y3, s3 - 64u)
          : s3 >= 32u ? __funnelshift_rc(y1, y2, s3 - 32u)
                      : __funnelshift_rc(y0, y1, s3)) & mask;
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
