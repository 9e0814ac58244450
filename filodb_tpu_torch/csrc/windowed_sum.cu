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
// Design: one warp per series, several series a CTA, and nothing of the
// row's length in shared memory. The row streams through in chunks of 128
// samples: a per-warp ring of kStages chunk slots is filled with 16-byte
// cp.async copies (one piece of timestamps and one of values a lane), so
// the next chunks are in flight while the current one is summed. A window
// is found by binary search over a key that is the running max of the
// non-padded timestamps (so padded lanes inside the row inherit the
// previous timestamp and the key is sorted while the real timestamps are
// non-decreasing, which assemble guarantees): a warp-shuffle max-scan over
// the chunk, carried from chunk to chunk. Padded lanes fail every mask, so
// each chunk's real samples are first compacted in order (a warp-shuffle
// count scan); a chunk of padding only is skipped. Their keys go to shared
// memory in breadth-first order, so the lanes' searches read distinct
// banks; where every real timestamp equals its key (sorted rows) a window's
// samples pass the mask without a look at their timestamps. Lanes take 32
// steps at a time; a step whose window the chunk touches adds the chunk's
// samples of its window to its partial sum, which a per-warp ring of steps
// in flight carries to the next chunk until the stream passes the step's
// t. The ring holds R slots, at least the most steps whose t falls in any
// interval [x, x + w), which the wrapper computes from the steps. Shared
// memory traffic, not device memory, bounds it in practice: each window
// reads its samples from shared memory one at a time (PERF.md).
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

using filodb::cp_async_16;
using filodb::cp_async_commit;
using filodb::cp_async_wait;
using filodb::kBlock;
using filodb::kFullMask;
using filodb::count_le_eytzinger_128;
using filodb::eytzinger_slot;
using filodb::MaxOp;
using filodb::SumOp;
using filodb::warp_inclusive_scan;

constexpr int kStages = 3;    // chunk slots of the per-warp ring
constexpr int kMaxWarps = 8;  // series a CTA
constexpr int32_t kTsPad = 2147483647;
constexpr int32_t kKeyMin = -2147483647 - 1;
// shared memory of one warp: the ring of kStages (ts, value) chunks and
// the current chunk's non-padded samples (keys in eytzinger_slot order, ts,
// values); then 4 bytes (a partial sum) a step in flight
constexpr size_t kWarpBytes = (kStages * 2 * kBlock + 3 * kBlock) * 4;
constexpr size_t kStepBytes = 4;
constexpr size_t kSmemMax = 232448;  // 227 KB a CTA on Hopper

// Copies chunk c of the row into ring slot c % kStages and commits a group:
// 16-byte cp.async pieces where the row allows (vec), else plain loads.
__device__ __forceinline__ void issue_chunk(int32_t* ring,
                                            const int32_t* ts_p,
                                            const float* v_p, int c,
                                            int nchunks, int S, int vec) {
  if (c < nchunks) {
    const int lane = threadIdx.x & 31;
    const int base = c * kBlock;
    const int m = min(kBlock, S - base);
    int32_t* sts = ring + (c % kStages) * 2 * kBlock;
    float* sv = reinterpret_cast<float*>(sts + kBlock);
    if (vec) {
      if (4 * lane < m) {
        cp_async_16(sts + 4 * lane, ts_p + base + 4 * lane);
        cp_async_16(sv + 4 * lane, v_p + base + 4 * lane);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * lane + q;
        if (i < m) {
          sts[i] = ts_p[base + i];
          sv[i] = v_p[base + i];
        }
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kMaxWarps * 32)
windowed_sum_kernel(const int32_t* __restrict__ ts,
                    const float* __restrict__ vals,
                    const int32_t* __restrict__ steps, int K, int32_t window,
                    long long P, int S, int R, int vec,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
      + warp;
  if (p >= P) return;
  unsigned char* mine = smem + warp * (kWarpBytes + kStepBytes * R);
  int32_t* ring = reinterpret_cast<int32_t*>(mine);
  int32_t* key_s = ring + kStages * 2 * kBlock;
  int32_t* ts_s = key_s + kBlock;
  float* v_s = reinterpret_cast<float*>(ts_s + kBlock);
  float* acc_r = v_s + kBlock;

  const int32_t* ts_p = ts + p * S;
  const float* v_p = vals + p * S;
  float* out_p = out + p * K;
  const int nchunks = (S + kBlock - 1) / kBlock;
  for (int c = 0; c < kStages - 1; ++c)
    issue_chunk(ring, ts_p, v_p, c, nchunks, S, vec);

  int32_t kcarry = kKeyMin;
  int kc = 0, ko = 0;  // next step to close / to open
  int kc_slot = 0;     // kc % R
  for (int c = 0; c < nchunks; ++c) {
    issue_chunk(ring, ts_p, v_p, c + kStages - 1, nchunks, S, vec);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int m = min(kBlock, S - c * kBlock);
    const int32_t* sts = ring + (c % kStages) * 2 * kBlock;
    const float* sv = reinterpret_cast<const float*>(sts + kBlock);
    // the chunk's non-padded samples, kept in order with their running-max
    // key: padded lanes add nothing to any window (their timestamp fails
    // every mask), so sums skip them; runs of padding are common (the
    // lanes past a page block's count, the end of a row)
    int32_t kk[4], tt[4];
    float vv[4];
    int32_t mx = kKeyMin;
    int nreal = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * lane + q;
      tt[q] = i < m ? sts[i] : kTsPad;
      const bool real = tt[q] != kTsPad;
      vv[q] = real ? sv[i] : 0.0f;
      mx = real ? max(mx, tt[q]) : mx;
      kk[q] = mx;
      nreal += real ? 1 : 0;
    }
    const int32_t incl = warp_inclusive_scan(mx, MaxOp());
    int32_t excl = __shfl_up_sync(kFullMask, incl, 1);
    excl = max(lane == 0 ? kKeyMin : excl, kcarry);
    const int32_t X = max(__shfl_sync(kFullMask, incl, 31), kcarry);
    const int pincl = warp_inclusive_scan(nreal, SumOp());
    const int mreal = __shfl_sync(kFullMask, pincl, 31);
    int pos = pincl - nreal;
    bool unsorted = false;  // a real timestamp below its key
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (tt[q] != kTsPad) {
        const int32_t key = max(kk[q], excl);
        unsorted = unsorted || tt[q] != key;
        key_s[eytzinger_slot(pos)] = key;
        ts_s[pos] = tt[q];
        v_s[pos] = vv[q];
        ++pos;
      }
      // keys past the real samples hold X, for the search
      if (4 * lane + q >= mreal) key_s[eytzinger_slot(4 * lane + q)] = X;
    }
    // where every real timestamp is its own key (sorted rows, as assemble
    // leaves them), a sample in [lo, hi) passes the mask without a look
    const bool sorted = !__any_sync(kFullMask, unsorted);
    __syncwarp();
    if (mreal == 0) continue;  // all padding: nothing opens or closes

    // steps whose window the chunk touches, 32 at a time from the oldest
    // still open: add the chunk's part of the window in sample order. Every
    // search is for an x < X, which the keys past mreal hold, so it runs
    // over all 128 keys.
    int a = kc;
    int kc_new = kc;
    int a_slot = kc_slot;
    while (true) {
      const int k = a + lane;
      const bool in = k < K;
      const int32_t t = in ? __ldg(steps + k) : 0;
      const int32_t t0 = t - window;
      const bool touched = in && t0 < X;
      const bool closes = in && t < X;
      const int slot = a_slot + lane < R ? a_slot + lane : a_slot + lane - R;
      if (touched) {
        float acc = k >= ko ? 0.0f : acc_r[slot];
        const int lo = count_le_eytzinger_128(key_s, t0);
        const int hi = closes ? count_le_eytzinger_128(key_s, t) : mreal;
        if (sorted) {
#pragma unroll 4
          for (int i = lo; i < hi; ++i) acc = acc + v_s[i];
        } else {
#pragma unroll 4
          for (int i = lo; i < hi; ++i) {
            const int32_t ti = ts_s[i];
            if (ti > t0 && ti <= t) acc = acc + v_s[i];
          }
        }
        if (closes) out_p[k] = acc; else acc_r[slot] = acc;
      }
      __syncwarp();
      const unsigned tb = __ballot_sync(kFullMask, touched);
      const int nclosed = __popc(__ballot_sync(kFullMask, closes));
      if (nclosed) {  // closes are a prefix from kc: the slot after them
        kc_new = a + nclosed;
        kc_slot = a_slot + nclosed < R ? a_slot + nclosed
                                       : a_slot + nclosed - R;
      }
      if (tb != kFullMask) {
        ko = max(ko, a + __popc(tb));
        break;
      }
      a += 32;
      a_slot = a_slot + 32 < R ? a_slot + 32 : a_slot + 32 - R;
    }
    kc = kc_new;
    kcarry = X;
    __syncwarp();
  }
  cp_async_wait<0>();

  // steps the stream never passed
  for (int a = kc; a < K; a += 32) {
    const int k = a + lane;
    if (k >= K) break;
    out_p[k] = k < ko ? acc_r[k % R] : 0.0f;
  }
}

size_t warp_bytes(long long R) {
  return kWarpBytes + kStepBytes * static_cast<size_t>(R);
}

}  // namespace

extern "C" {

// The most steps in flight one warp's shared memory can hold.
long long windowed_sum_max_in_flight() {
  return static_cast<long long>((kSmemMax - kWarpBytes) / kStepBytes) / 4 * 4;
}

// ts i32 [P, S], vals f32 [P, S], steps i32 [K] non-decreasing; R >= 32
// slots, at least the steps in flight; vec: S % 4 == 0 and both arrays
// 16-byte aligned -> out f32 [P, K]
int windowed_sum(const void* ts, const void* vals, const void* steps,
                 long long K, long long window, long long P, long long S,
                 long long R, long long vec, void* out, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  R = (R + 3) / 4 * 4;  // keeps every warp's region 16-byte aligned
  if (R < 32 || R > windowed_sum_max_in_flight())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = warp_bytes(R);
  int warps = static_cast<int>(kSmemMax / per_warp);
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        windowed_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (P + warps - 1) / warps;
  windowed_sum_kernel<<<static_cast<unsigned>(grid), warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ts), static_cast<const float*>(vals),
      static_cast<const int32_t*>(steps), static_cast<int>(K),
      static_cast<int32_t>(window), P, static_cast<int>(S),
      static_cast<int>(R), static_cast<int>(vec), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
