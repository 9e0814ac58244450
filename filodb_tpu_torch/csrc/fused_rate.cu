// Fused decode -> counter correction -> windowed rate/increase/delta (B3).
//
// Replaces: filodb_tpu/query/engine/pallas_kernels.py::fused_decode_rate_pallas
// (_fused_rate_kernel, _decode_series, _carry_forward, _scan_sum).
//
// Computes, per series, from its packed device pages: decode every block
// (timestamps relative to the batch base, float32 values; lanes past a
// block's count are gaps), Prometheus counter-reset correction (a drop
// below the previous valid value adds that value to every later sample),
// then for every step t the window (t-w, t]: sample count n, first and last
// valid samples, and extrapolatedRate for rate / increase / delta. Output
// f32 [P, K], NaN where n < 2. Durations are differenced in integer ms
// and then divided by 1000 in float32; the TPU kernel divides each time by
// 1000 first, which costs an ulp of the absolute time (a quarter ms at 40
// minutes) in every duration, and cross-series sums of deltas magnify that
// past the reference's tolerance.
//
// Bound on this card: bytes, narrowly. A series reads the 4*w words a
// block's widths need (unpack_field touches no others) plus seven scalars a
// block and writes K floats; the decode, four scans and K pairs of binary
// searches are about 60 operations a valid sample and 150 a step, which at
// the float32 rate take nearly as long as those bytes take to arrive from
// device memory (chip_smoke.py computes both).
//
// Design: one CTA per series, decoded samples kept in shared memory only
// (the decoded [P, S] tensors never reach device memory, as on the TPU).
// The TPU kernel does an O(S) masked reduction for every step; here each
// step is a binary search over the series' timestamps, made sorted by a
// running max (gaps take the previous real timestamp, as assemble does).
// Counter correction and the count prefix are block-wide scans: each
// thread scans a contiguous run of samples, warps combine run totals with
// shuffles. Shared memory is 20 bytes a sample; the wrapper raises when a
// series holds more samples than one CTA's shared memory can take.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using filodb::block_scan;
using filodb::kBlock;
using filodb::MaxOp;
using filodb::SumOp;
using filodb::unpack_field;
using filodb::upper_bound;

constexpr int kThreads = 256;
constexpr int32_t kGap = -2147483646;  // -(2**31) + 2

// kind: 0 = rate, 1 = increase, 2 = delta
__global__ void __launch_bounds__(kThreads)
fused_rate_kernel(const int32_t* __restrict__ rel_bases,
                  const int32_t* __restrict__ ts_slopes,
                  const int32_t* __restrict__ ts_widths,
                  const uint32_t* __restrict__ ts_words,
                  const uint32_t* __restrict__ v_firsts,
                  const int32_t* __restrict__ v_shifts,
                  const int32_t* __restrict__ v_widths,
                  const uint32_t* __restrict__ v_words,
                  const int32_t* __restrict__ blk_counts,
                  const int32_t* __restrict__ steps, int K, int32_t window,
                  int NB, int kind, int counter, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = NB * kBlock;
  int32_t* key = reinterpret_cast<int32_t*>(smem);   // running-max ts
  int32_t* pidx = key + S;                           // last valid index <= i
  int32_t* vcnt = pidx + S;                          // valid count, inclusive
  float* v = reinterpret_cast<float*>(vcnt + S);     // raw values (0 in gaps)
  float* cv = v + S;                                 // corrected values
  __shared__ int32_t warp_i[32];
  __shared__ float warp_f[32];

  const long long p = blockIdx.x;
  const long long row = p * NB;

  // 1. decode every sample of the series
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int b = i / kBlock;
    const int lane = i % kBlock;
    const long long blk = row + b;
    const bool valid = lane < blk_counts[blk];
    uint32_t zz = unpack_field(ts_words + blk * kBlock, lane,
                               static_cast<uint32_t>(ts_widths[blk]));
    uint32_t resid = (zz >> 1) ^ (0u - (zz & 1u));
    uint32_t t = static_cast<uint32_t>(rel_bases[blk]) +
                 static_cast<uint32_t>(ts_slopes[blk]) *
                     static_cast<uint32_t>(lane) + resid;
    uint32_t x = unpack_field(v_words + blk * kBlock, lane,
                              static_cast<uint32_t>(v_widths[blk]));
    uint32_t tz = static_cast<uint32_t>(v_shifts[blk]);
    uint32_t bits = (tz >= 32 ? 0u : (x << tz)) ^ v_firsts[blk];
    key[i] = valid ? static_cast<int32_t>(t) : kGap;
    pidx[i] = valid ? i : -1;
    vcnt[i] = valid ? 1 : 0;
    v[i] = valid ? __uint_as_float(bits) : 0.0f;
  }
  __syncthreads();
  block_scan(key, S, static_cast<int32_t>(kGap), MaxOp(), warp_i);
  block_scan(pidx, S, -1, MaxOp(), warp_i);
  block_scan(vcnt, S, 0, SumOp(), warp_i);

  // 2. counter correction: cumulative sum of every dropped previous value
  if (counter) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      float d = 0.0f;
      if (pidx[i] == i && i > 0 && pidx[i - 1] >= 0) {
        const float prev = v[pidx[i - 1]];
        if (v[i] < prev) d = prev;
      }
      cv[i] = d;
    }
    __syncthreads();
    block_scan(cv, S, 0.0f, SumOp(), warp_f);
    for (int i = threadIdx.x; i < S; i += blockDim.x) cv[i] = v[i] + cv[i];
  } else {
    for (int i = threadIdx.x; i < S; i += blockDim.x) cv[i] = v[i];
  }
  __syncthreads();

  // 3. one window per step
  const float win_s = static_cast<float>(window) / 1000.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int32_t t = steps[k];
    const int32_t t0 = t - window;
    const int lo = upper_bound(key, S, t0);
    const int hi = upper_bound(key, S, t);
    const int n_i = (hi > 0 ? vcnt[hi - 1] : 0) - (lo > 0 ? vcnt[lo - 1] : 0);
    float result = __int_as_float(0x7fc00000);  // NaN
    if (n_i >= 2) {
      // the sample at lo is valid (a gap would repeat a key <= t0); the
      // last valid sample is the last valid index at or before hi-1
      const int fi = lo;
      const int li = pidx[hi - 1];
      const float n = static_cast<float>(n_i);
      const float v_first = cv[fi];
      const float v_last = cv[li];
      const float raw_first = v[fi];
      // durations differenced in integer ms, then divided once
      result = v_last - v_first;
      const float sampled = static_cast<float>(key[li] - key[fi]) / 1000.0f;
      const float avg_dur = sampled / fmaxf(n - 1.0f, 1.0f);
      float dur_start = static_cast<float>(key[fi] - t0) / 1000.0f;
      const float dur_end = static_cast<float>(t - key[li]) / 1000.0f;
      if (kind != 2) {
        const float dur_to_zero = result > 0.0f
            ? sampled * raw_first / fmaxf(result, 1e-30f)
            : __int_as_float(0x7f800000);  // +inf
        dur_start = fminf(dur_start, dur_to_zero);
      }
      const float threshold = avg_dur * 1.1f;
      float extend = sampled;
      extend = extend + (dur_start < threshold ? dur_start : avg_dur / 2.0f);
      extend = extend + (dur_end < threshold ? dur_end : avg_dur / 2.0f);
      const float factor = extend / fmaxf(sampled, 1e-10f);
      result = result * factor;
      if (kind == 0) result = result / win_s;
    }
    out[p * K + k] = result;
  }
}

}  // namespace

extern "C" {

// packed page arrays [P, NB] and [P, NB, 128]; steps i32 [K] -> out f32 [P, K]
int fused_decode_rate(const void* rel_bases, const void* ts_slopes,
                      const void* ts_widths, const void* ts_words,
                      const void* v_firsts, const void* v_shifts,
                      const void* v_widths, const void* v_words,
                      const void* blk_counts, const void* steps, long long K,
                      long long window, long long P, long long NB,
                      long long kind, long long counter, void* out,
                      void* stream) {
  if (P <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>(NB) * kBlock * 20;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_rate_kernel<<<static_cast<unsigned>(P), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rel_bases),
      static_cast<const int32_t*>(ts_slopes),
      static_cast<const int32_t*>(ts_widths),
      static_cast<const uint32_t*>(ts_words),
      static_cast<const uint32_t*>(v_firsts),
      static_cast<const int32_t*>(v_shifts),
      static_cast<const int32_t*>(v_widths),
      static_cast<const uint32_t*>(v_words),
      static_cast<const int32_t*>(blk_counts),
      static_cast<const int32_t*>(steps), static_cast<int>(K),
      static_cast<int32_t>(window), static_cast<int>(NB),
      static_cast<int>(kind), static_cast<int>(counter),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
