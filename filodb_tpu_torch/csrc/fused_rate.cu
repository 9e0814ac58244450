// Fused decode -> counter correction -> windowed rate/increase/delta (B3).
//
// Replaces: filodb_tpu/query/engine/pallas_kernels.py::fused_decode_rate_pallas
// (_fused_rate_kernel, _decode_series, _carry_forward, _scan_sum).
//
// Computes, per series, from its packed device pages: decode every block
// (timestamps relative to the batch base, float32 values; lanes past a
// block's count and NaN values are gaps), Prometheus counter-reset
// correction (a drop below the previous valid value adds that value to
// every later sample), then for every step t the window (t-w, t]: sample
// count n, first and last valid samples, and extrapolatedRate for rate /
// increase / delta. Output f32 [P, K], NaN where n < 2. Durations are differenced in integer ms
// and then divided by 1000 in float32; the TPU kernel divides each time by
// 1000 first, which costs an ulp of the absolute time (a quarter ms at 40
// minutes) in every duration, and cross-series sums of deltas magnify that
// past the reference's tolerance.
//
// Bound on this card: bytes, narrowly. A series reads the 4*w words a
// block's widths need (field() touches no others) plus seven scalars a
// block and writes K floats; the decode and the two binary searches a step
// take about as long at the float32 rate as those bytes take to arrive
// (chip_smoke.py computes both). What holds it back in practice is
// instruction issue: every block costs a warp a fixed prologue, two scans
// and a round of steps that is about half full at a 60 s step over 10 s
// samples (PERF.md).
//
// Design: one warp per series, several series a CTA, and nothing of a
// series' length in shared memory. The blocks stream through in time
// order: a per-warp ring of kStages block slots is filled with 16-byte
// cp.async copies of only the 4*w words each width needs, so the next
// blocks' words are in flight while the current one is evaluated. The
// seven per-block scalars come 32 blocks at a time, one block a lane with
// coalesced loads, and are shuffled out. A lane decodes four neighbouring
// samples from padded word rows without branches. A NaN value (a
// Prometheus staleness marker) is not a sample: the reference's host
// decode drops it, and the plain version masks it out. A block that holds
// one (one __any_sync tells) moves its other samples to the front in
// order, through shared memory, so in every block the samples are the
// lanes below a count; the valid ordinal and the previous valid sample
// then follow from the counts. A block of NaN only carries nothing. The
// running-max key (gaps take the previous timestamp, as assemble does) and
// the counter correction are one warp-shuffle scan each (the correction's
// only where the block holds a drop), carried from block to block with the
// last valid sample.
//
// Steps: both ends of a window move forward with k. Step k opens when the
// stream passes t_k - w: the first valid sample after it (its key, raw and
// corrected value and ordinal) is found by a binary search over the
// block's 128 keys. Step k closes when the stream passes t_k: the last
// valid sample at or before t_k is then in the current block (or is the
// carried one), and the result is written. A window that stays open past
// its block keeps its first sample in a per-warp ring of steps in flight.
// Lanes take 32 steps at a time. The ring holds R slots, at least the most
// steps whose t falls in any interval [x, x + w), which the wrapper
// computes from the steps; that is the kernel's only limit.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using filodb::cp_async_16;
using filodb::cp_async_commit;
using filodb::cp_async_wait;
using filodb::kBlock;
using filodb::kFullMask;
using filodb::count_le_128;
using filodb::MaxOp;
using filodb::SumOp;
using filodb::warp_inclusive_scan;

constexpr int kStages = 3;      // block slots of the per-warp ring
constexpr int kMaxWarps = 8;    // series a CTA
constexpr int32_t kGap = -2147483646;  // -(2**31) + 2
// a word row in shared memory: the block's 128 words and a pad word, so
// that the word after a field's first is always in the row (16-byte rows)
constexpr int kRow = kBlock + 4;
// shared memory of one warp: the ring of kStages (ts, value) word rows and
// the evaluated block's key, corrected and raw values; then 16 bytes a step
// in flight (first key, corrected, raw, ordinal)
constexpr size_t kWarpBytes = (kStages * 2 * kRow + 3 * kBlock) * 4;
constexpr size_t kStepBytes = 16;
constexpr size_t kSmemMax = 232448;  // 227 KB a CTA on Hopper

struct Pages {
  const int32_t* rel_bases;
  const int32_t* ts_slopes;
  const int32_t* ts_widths;
  const uint32_t* ts_words;
  const uint32_t* v_firsts;
  const int32_t* v_shifts;
  const int32_t* v_widths;
  const uint32_t* v_words;
  const int32_t* blk_counts;
};

// per-block scalars; lane l of a warp holds those of block 32*g + l
struct Scalars {
  int32_t base, slope, tw, shift, vw, cnt;
  uint32_t first;
};

__device__ __forceinline__ void load_group(Scalars& s, const Pages& pg,
                                           long long row, int NB, int g) {
  const int b = g * 32 + (threadIdx.x & 31);
  if (b < NB) {
    const long long i = row + b;
    s.base = __ldg(pg.rel_bases + i);
    s.slope = __ldg(pg.ts_slopes + i);
    s.tw = __ldg(pg.ts_widths + i);
    s.first = __ldg(pg.v_firsts + i);
    s.shift = __ldg(pg.v_shifts + i);
    s.vw = __ldg(pg.v_widths + i);
    s.cnt = __ldg(pg.blk_counts + i);
  } else {
    s = Scalars{0, 0, 0, 0, 0, 0, 0u};
  }
}

// Issues the copies of block b's needed words into ring slot b % kStages
// (one 16-byte piece a lane: 4*w words are w pieces) and commits a group,
// empty where there is nothing to copy.
__device__ __forceinline__ void issue_block(uint32_t* ring,
                                            const uint32_t* ts_row,
                                            const uint32_t* v_row, int b,
                                            int NB, int g, const Scalars& ga,
                                            const Scalars& gb) {
  if (b < NB) {
    const bool in_a = (b >> 5) == g;
    const int src = b & 31;
    const int tw = __shfl_sync(kFullMask, in_a ? ga.tw : gb.tw, src);
    const int vw = __shfl_sync(kFullMask, in_a ? ga.vw : gb.vw, src);
    const int cnt = __shfl_sync(kFullMask, in_a ? ga.cnt : gb.cnt, src);
    const int lane = threadIdx.x & 31;
    uint32_t* slot = ring + (b % kStages) * 2 * kRow;
    const int at = b * kBlock + 4 * lane;
    if (cnt > 0) {
      if (lane < tw) cp_async_16(slot + 4 * lane, ts_row + at);
      if (lane < vw) cp_async_16(slot + kRow + 4 * lane, v_row + at);
    }
  }
  cp_async_commit();
}

// Width-w field of lane i from a padded word row (common.cuh unpack_field
// without its branches): `mask` is 0 for w = 0 and all ones for w = 32, and
// the row's pad word stands in for the clamp of the word after the last.
__device__ __forceinline__ uint32_t field(const uint32_t* row, int i,
                                          uint32_t w, uint32_t mask) {
  const uint32_t bit0 = static_cast<uint32_t>(i) * w;
  const uint32_t* at = row + (bit0 >> 5);
  return __funnelshift_r(at[0], at[1], bit0 & 31u) & mask;
}

__device__ __forceinline__ uint32_t width_mask(uint32_t w) {
  return w == 0 ? 0u : (w >= 32 ? 0xFFFFFFFFu : (1u << w) - 1u);
}

// x / 1000 rounded to float32 as the division rounds it, for an
// integer-valued float x (a duration in ms): the double product is within
// 3e-16 (relative) of x / 1000, which lies at least 3e-11 from any point
// where float32 rounding changes, so both round to the same float. Four
// of these a window cost as much as a tenth of the kernel as divisions.
__device__ __forceinline__ float ms_to_s(float x) {
  return __double2float_rn(static_cast<double>(x) * 0.001);
}

// extrapolatedRate of one window from its first and last valid samples
// (key, corrected value, ordinal); NaN where it holds < 2 samples.
__device__ __forceinline__ float window_result(int kind, int32_t t,
                                               int32_t window, float win_s,
                                               int32_t fk, float fcv,
                                               float fraw, int ford,
                                               int32_t lk, float lcv,
                                               int lord) {
  const int n_i = lord - ford + 1;
  if (n_i < 2) return __int_as_float(0x7fc00000);  // NaN
  const int32_t t0 = t - window;
  const float n = static_cast<float>(n_i);
  // durations differenced in integer ms, then divided once
  float result = lcv - fcv;
  const float sampled = ms_to_s(static_cast<float>(lk - fk));
  const float avg_dur = sampled / fmaxf(n - 1.0f, 1.0f);
  float dur_start = ms_to_s(static_cast<float>(fk - t0));
  const float dur_end = ms_to_s(static_cast<float>(t - lk));
  if (kind != 2) {
    const float dur_to_zero = result > 0.0f
        ? sampled * fraw / fmaxf(result, 1e-30f)
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
  return result;
}

// kind: 0 = rate, 1 = increase, 2 = delta
__global__ void __launch_bounds__(kMaxWarps * 32)
fused_rate_kernel(Pages pg, const int32_t* __restrict__ steps, int K,
                  int32_t window, long long P, int NB, int kind, int counter,
                  int R, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
      + warp;
  if (p >= P) return;
  unsigned char* mine = smem + warp * (kWarpBytes + kStepBytes * R);
  uint32_t* ring = reinterpret_cast<uint32_t*>(mine);
  int32_t* key_s = reinterpret_cast<int32_t*>(ring + kStages * 2 * kRow);
  float* cv_s = reinterpret_cast<float*>(key_s + kBlock);
  float* raw_s = cv_s + kBlock;
  int32_t* r_key = reinterpret_cast<int32_t*>(raw_s + kBlock);
  float* r_cv = reinterpret_cast<float*>(r_key + R);
  float* r_raw = r_cv + R;
  int32_t* r_ord = reinterpret_cast<int32_t*>(r_raw + R);

  const long long row = p * NB;
  // the series' word rows, [NB, 128] each
  const uint32_t* ts_row = pg.ts_words + row * kBlock;
  const uint32_t* v_row = pg.v_words + row * kBlock;
  float* out_p = out + p * K;
  const float win_s = static_cast<float>(window) / 1000.0f;

  Scalars ga, gb;
  int g = 0;
  load_group(ga, pg, row, NB, 0);
  load_group(gb, pg, row, NB, 1);
  for (int b = 0; b < kStages - 1; ++b)
    issue_block(ring, ts_row, v_row, b, NB, g, ga, gb);

  // carried across blocks: running-max key, last valid sample, valid
  // samples so far, correction total, next step to close / to open
  int32_t kcarry = kGap;
  int32_t last_key = kGap;
  float last_raw = 0.0f, last_cv = 0.0f, corr = 0.0f;
  int ord_base = 0;
  int kc = 0, ko = 0, kc_slot = 0;  // kc_slot = kc % R

  for (int b = 0; b < NB; ++b) {
    if ((b >> 5) != g) {
      ga = gb;
      ++g;
      load_group(gb, pg, row, NB, g + 1);
    }
    const int src = b & 31;
    int cnt = __shfl_sync(kFullMask, ga.cnt, src);
    const int32_t base = __shfl_sync(kFullMask, ga.base, src);
    const int32_t slope = __shfl_sync(kFullMask, ga.slope, src);
    // widths past 32 are not in the format; clamped, they stay in the row
    const uint32_t tw = min(static_cast<uint32_t>(
        __shfl_sync(kFullMask, ga.tw, src)), 32u);
    const uint32_t first = __shfl_sync(kFullMask, ga.first, src);
    const int shift = __shfl_sync(kFullMask, ga.shift, src);
    const uint32_t vw = min(static_cast<uint32_t>(
        __shfl_sync(kFullMask, ga.vw, src)), 32u);
    issue_block(ring, ts_row, v_row, b + kStages - 1, NB, g, ga, gb);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    int32_t tt[4];
    float vv[4];
    if (cnt > 0) {
      // 1. decode lanes 4*lane .. 4*lane+3 of block b
      const uint32_t* rts = ring + (b % kStages) * 2 * kRow;
      const uint32_t* rv = rts + kRow;
      const uint32_t tmask = width_mask(tw), vmask = width_mask(vw);
      bool nan_lane = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * lane + c;
        const uint32_t zz = field(rts, i, tw, tmask);
        const uint32_t resid = (zz >> 1) ^ (0u - (zz & 1u));
        tt[c] = static_cast<int32_t>(static_cast<uint32_t>(base) +
            static_cast<uint32_t>(slope) * static_cast<uint32_t>(i) + resid);
        const uint32_t x = field(rv, i, vw, vmask);
        const uint32_t tz = static_cast<uint32_t>(shift);
        vv[c] = __uint_as_float((tz >= 32 ? 0u : (x << tz)) ^ first);
        nan_lane = nan_lane || (i < cnt && isnan(vv[c]));
      }
      // NaN samples (staleness markers) are dropped: the block's other
      // samples move to the front, in order, through key_s / raw_s, so
      // that what follows sees a block of cnt samples with no gaps.
      // Blocks without a NaN (nearly all) skip this.
      if (__any_sync(kFullMask, nan_lane)) {
        int keep[4], nk = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          keep[c] = 4 * lane + c < cnt && !isnan(vv[c]);
          nk += keep[c];
        }
        const int incl = warp_inclusive_scan(nk, SumOp());
        int at = incl - nk;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (keep[c]) {
            key_s[at] = tt[c];
            raw_s[at] = vv[c];
            ++at;
          }
        }
        cnt = __shfl_sync(kFullMask, incl, 31);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          tt[c] = key_s[4 * lane + c];
          vv[c] = raw_s[4 * lane + c];
        }
        __syncwarp();
      }
    }
    if (cnt > 0) {  // the block's samples that are not NaN
      int32_t kk[4];
      int32_t m = kGap;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = 4 * lane + c < cnt;
        vv[c] = valid ? vv[c] : 0.0f;
        m = valid ? max(m, tt[c]) : m;
        kk[c] = m;
      }
      // running-max key: warp scan of the lanes' maxima, then the carry
      const int32_t kincl = warp_inclusive_scan(m, MaxOp());
      int32_t kexcl = __shfl_up_sync(kFullMask, kincl, 1);
      kexcl = max(lane == 0 ? kGap : kexcl, kcarry);
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = max(kk[c], kexcl);
      // 2. counter correction: each valid sample below the previous valid
      // one adds that previous value; the previous of lane 0 is carried
      float prev = __shfl_up_sync(kFullMask, vv[3], 1);
      if (lane == 0) prev = last_raw;
      const bool has_prev = lane > 0 || ord_base > 0;
      float dsum[4];
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * lane + c;
        const float pv = c == 0 ? prev : vv[c - 1];
        const bool hp = c == 0 ? has_prev : true;
        const float d =
            (counter && i < cnt && hp && vv[c] < pv) ? pv : 0.0f;
        s = s + d;
        dsum[c] = s;
      }
      // most blocks hold no reset: then the scan adds only zeros
      float sincl = 0.0f, sexcl = 0.0f;
      if (__any_sync(kFullMask, s != 0.0f)) {
        sincl = warp_inclusive_scan(s, SumOp());
        sexcl = __shfl_up_sync(kFullMask, sincl, 1);
        if (lane == 0) sexcl = 0.0f;
      }
      float cvv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cvv[c] = counter ? vv[c] + (corr + (sexcl + dsum[c])) : vv[c];
      reinterpret_cast<int4*>(key_s)[lane] =
          make_int4(kk[0], kk[1], kk[2], kk[3]);
      reinterpret_cast<float4*>(cv_s)[lane] =
          make_float4(cvv[0], cvv[1], cvv[2], cvv[3]);
      reinterpret_cast<float4*>(raw_s)[lane] =
          make_float4(vv[0], vv[1], vv[2], vv[3]);
      __syncwarp();
      // the key of the last valid sample: gaps raise no key
      const int32_t X = max(__shfl_sync(kFullMask, kincl, 31), kcarry);

      // 3. steps: open those whose t - w the block passes, close those
      // whose t it passes, 32 at a time from the oldest still open. Both
      // searches look for an x < X, and the lanes past the count hold X,
      // so they run over all 128 keys.
      int a = kc;
      int kc_new = kc;
      int a_slot = kc_slot;
      while (true) {
        const int k = a + lane;
        const bool in = k < K;
        const int32_t t = in ? __ldg(steps + k) : 0;
        const int32_t t0 = t - window;
        const bool openable = in && t0 < X;
        const bool closes = in && t < X;
        const int slot = a_slot + lane < R ? a_slot + lane : a_slot + lane - R;
        // a window's first sample: found now, or kept in the ring since an
        // earlier block; only windows left open go into the ring
        int32_t fk = 0;
        float fcv = 0.0f, fraw = 0.0f;
        int ford = 0;
        if (openable && k >= ko) {
          const int i = count_le_128(key_s, t0);
          fk = key_s[i];
          fcv = cv_s[i];
          fraw = raw_s[i];
          ford = ord_base + i;
          if (!closes) {
            r_key[slot] = fk;
            r_cv[slot] = fcv;
            r_raw[slot] = fraw;
            r_ord[slot] = ford;
          }
        } else if (closes) {
          fk = r_key[slot];
          fcv = r_cv[slot];
          fraw = r_raw[slot];
          ford = r_ord[slot];
        }
        if (closes) {
          const int j = count_le_128(key_s, t) - 1;
          const int32_t lk = j >= 0 ? key_s[j] : last_key;
          const float lcv = j >= 0 ? cv_s[j] : last_cv;
          out_p[k] = window_result(kind, t, window, win_s, fk, fcv, fraw,
                                   ford, lk, lcv, ord_base + j);
        }
        __syncwarp();
        const unsigned ob = __ballot_sync(kFullMask, openable);
        const int nclosed = __popc(__ballot_sync(kFullMask, closes));
        if (nclosed) {  // closes are a prefix from kc: the slot after them
          kc_new = a + nclosed;
          kc_slot = a_slot + nclosed < R ? a_slot + nclosed
                                         : a_slot + nclosed - R;
        }
        if (ob != kFullMask) {
          ko = max(ko, a + __popc(ob));
          break;
        }
        a += 32;
        a_slot = a_slot + 32 < R ? a_slot + 32 : a_slot + 32 - R;
      }
      kc = kc_new;
      // 4. carry the block's last valid sample
      last_key = X;
      last_cv = cv_s[cnt - 1];
      last_raw = raw_s[cnt - 1];
      kcarry = max(kcarry, X);
      corr = corr + __shfl_sync(kFullMask, sincl, 31);
      ord_base += cnt;
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // steps the stream never passed: their last valid sample is the last one
  for (int a = kc; a < K; a += 32) {
    const int k = a + lane;
    if (k >= K) break;
    float r = __int_as_float(0x7fc00000);
    if (k < ko) {
      const int slot = k % R;
      r = window_result(kind, __ldg(steps + k), window, win_s, r_key[slot],
                        r_cv[slot], r_raw[slot], r_ord[slot], last_key,
                        last_cv, ord_base - 1);
    }
    out_p[k] = r;
  }
}

size_t warp_bytes(long long R) {
  return kWarpBytes + kStepBytes * static_cast<size_t>(R);
}

}  // namespace

extern "C" {

// The most steps in flight one warp's shared memory can hold.
long long fused_decode_rate_max_in_flight() {
  return static_cast<long long>((kSmemMax - kWarpBytes) / kStepBytes);
}

// packed page arrays [P, NB] and [P, NB, 128] (word arrays 16-byte
// aligned); steps i32 [K], non-decreasing; R >= 32 slots, at least the
// steps in flight -> out f32 [P, K]
int fused_decode_rate(const void* rel_bases, const void* ts_slopes,
                      const void* ts_widths, const void* ts_words,
                      const void* v_firsts, const void* v_shifts,
                      const void* v_widths, const void* v_words,
                      const void* blk_counts, const void* steps, long long K,
                      long long window, long long P, long long NB,
                      long long kind, long long counter, long long R,
                      void* out, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (R < 32 || R > fused_decode_rate_max_in_flight())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = warp_bytes(R);
  int warps = static_cast<int>(kSmemMax / per_warp);
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Pages pg{static_cast<const int32_t*>(rel_bases),
           static_cast<const int32_t*>(ts_slopes),
           static_cast<const int32_t*>(ts_widths),
           static_cast<const uint32_t*>(ts_words),
           static_cast<const uint32_t*>(v_firsts),
           static_cast<const int32_t*>(v_shifts),
           static_cast<const int32_t*>(v_widths),
           static_cast<const uint32_t*>(v_words),
           static_cast<const int32_t*>(blk_counts)};
  const long long grid = (P + warps - 1) / warps;
  fused_rate_kernel<<<static_cast<unsigned>(grid), warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pg, static_cast<const int32_t*>(steps), static_cast<int>(K),
      static_cast<int32_t>(window), P, static_cast<int>(NB),
      static_cast<int>(kind), static_cast<int>(counter),
      static_cast<int>(R), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
