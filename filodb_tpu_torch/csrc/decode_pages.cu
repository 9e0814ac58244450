// Device-page decode kernels B1 (timestamps) and B2 (float32 values).
//
// Replaces: filodb_tpu/memory/device_pages.py::decode_ts_page_pallas
// (_ts_kernel, _unpack_tile) and ::decode_f32_page_pallas (_f32_kernel).
//
// Computes, for every 128-lane page block b and lane i, the width-w field
// at bits [i*w, i*w+w) of the block's word row, then
//   B1: slope*i + unzigzag(field)            (int32 offset from the base)
//   B2: bitcast<f32>(((field << tz) ^ first)) with tz >= 32 giving 0.
//
// Bound on this card: bytes. A block needs its scalars and the 4*w words
// that hold its 128 width-w fields (of the 128 the page reserves), and
// writes 512 bytes, for about ten integer operations an output: far below
// what the SMs offer for those bytes, so device memory (3.35 TB/s) bounds
// it. What held the first port back was not the bytes but how few were in
// flight: one 4-byte load a thread, then a CTA-wide barrier between the
// loads and the stores.
//
// Design: one warp per page block, each warp walking a run of kRun
// consecutive blocks through a per-warp ring of kStages slots in shared
// memory, with __syncwarp and no __syncthreads. Lanes 0..w-1 fill a slot
// with one 16-byte cp.async each: exactly the 4*w words the width needs,
// nothing past them. The copies of the next kStages-1 blocks are in flight
// while the current block is unpacked. A run's per-block scalars come with
// one coalesced 4-byte load a lane (a run is at most 32 blocks) and are
// shuffled out. Lane j unpacks fields 4j..4j+3 from the five words they
// can span (common.cuh unpack_four) and writes them with one 16-byte
// store, so a warp writes a block's 512 bytes as four full 128-byte lines.
//
// Sizes, measured on an H100 at 1,048,576 blocks (PERF.md): short runs are
// fastest (4 blocks a warp 0.253 ms for B1, 8 0.257, 32 0.267, 64 0.272, a
// grid-stride warp over its share of the whole launch 0.287); the ring's
// depth and the warps a CTA move it by about 1 % once two blocks are in
// flight. A one-lane cp.async.bulk of the 16*w bytes into the slot with an
// mbarrier was 2 % slower than the lanes' 16-byte copies at 64 blocks a
// warp and tied with them at these sizes, so the copies, which need no
// mbarrier or proxy fence, stay.
//
// Words past 4*w: a slot keeps whatever an earlier block left there, or
// nothing. unpack_four may read up to word 4*w (the slot's pad word at
// w = 32), but every bit it keeps lies in the first 4*w words, and the
// width mask drops the rest: the kernel relies on the mask, as
// unpack_field does, so it matches the plain version whatever the words
// past 4*w hold. Widths past 32 are not in the format; they are clamped
// to 32, so no read leaves the slot.
//
// words and out must be 16-byte aligned (the wrapper checks).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using filodb::cp_async_16;
using filodb::cp_async_commit;
using filodb::cp_async_wait;
using filodb::kBlock;
using filodb::kFullMask;
using filodb::unpack_four;

constexpr int kWarps = 8;          // warps a CTA
constexpr int kStages = 3;         // ring slots a warp: kStages-1 in flight
constexpr int kRun = 4;            // consecutive blocks a warp
constexpr int kSlot = kBlock + 4;  // a slot: 128 words and a pad (16 bytes)
static_assert(kRun <= 32, "one scalar load a lane covers a run");
static_assert(kStages >= 2, "at least one block in flight");

// Issues the copies of block k of the run into ring slot k % kStages: one
// 16-byte piece for each lane below the block's width (4*w words; lane k
// holds the width), then commits a group, empty past the run or at w = 0.
__device__ __forceinline__ void issue(uint32_t (*ring)[kSlot],
                                      const uint32_t* src, int k, int n,
                                      uint32_t width) {
  if (k < n) {
    const int lane = threadIdx.x & 31;
    const uint32_t w = min(__shfl_sync(kFullMask, width, k), 32u);
    if (static_cast<uint32_t>(lane) < w)
      cp_async_16(&ring[k % kStages][4 * lane],
                  src + static_cast<long long>(k) * kBlock + 4 * lane);
  }
  cp_async_commit();
}

// B1 (kF32 false): a = slopes, out int32 bits; B2: a = firsts, shifts,
// out float32 bits. words [nb, 128], out [nb, 128].
template <bool kF32>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const uint32_t* __restrict__ a,
              const int32_t* __restrict__ shifts,
              const int32_t* __restrict__ widths,
              const uint32_t* __restrict__ words,
              uint32_t* __restrict__ out, long long nb) {
  __shared__ __align__(16) uint32_t smem[kWarps][kStages][kSlot];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kRun;
  if (b0 >= nb) return;
  const int n = static_cast<int>(min(static_cast<long long>(kRun), nb - b0));
  uint32_t (*ring)[kSlot] = smem[warp];
  const uint32_t* src = words + b0 * kBlock;
  uint4* dst = reinterpret_cast<uint4*>(out + b0 * kBlock) + lane;
  // lane l holds the scalars of the run's block l (zeros past its end);
  // sa is the slope (B1) or the first value's bits (B2)
  uint32_t width = 0u, sa = 0u, shift = 0u;
  if (lane < n) {
    width = static_cast<uint32_t>(__ldg(widths + b0 + lane));
    sa = __ldg(a + b0 + lane);
    if (kF32) shift = static_cast<uint32_t>(__ldg(shifts + b0 + lane));
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(ring, src, k, n, width);

  const uint32_t i0 = 4u * static_cast<uint32_t>(lane);  // first field
  for (int i = 0; i < n; ++i) {
    issue(ring, src, i + kStages - 1, n, width);
    cp_async_wait<kStages - 1>();  // this lane's copies of block i are in
    __syncwarp();                  // and so are the other lanes'
    const uint32_t w = min(__shfl_sync(kFullMask, width, i), 32u);
    const uint32_t av = __shfl_sync(kFullMask, sa, i);
    const uint32_t mask =
        w == 0 ? 0u : (w >= 32 ? 0xFFFFFFFFu : (1u << w) - 1u);
    uint32_t f[4];
    unpack_four(ring[i % kStages], lane, w, mask, f);
    uint32_t r[4];
    if (kF32) {
      const uint32_t tz = __shfl_sync(kFullMask, shift, i);
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = (tz >= 32 ? 0u : f[c] << tz) ^ av;
    } else {
      // unzigzag; int32 wrap-around of slope*i as in the reference
#pragma unroll
      for (int c = 0; c < 4; ++c)
        r[c] = av * (i0 + c) + ((f[c] >> 1) ^ (0u - (f[c] & 1u)));
    }
    dst[static_cast<long long>(i) * (kBlock / 4)] =
        make_uint4(r[0], r[1], r[2], r[3]);
    __syncwarp();  // every lane is done with the slot before it refills
  }
}

template <bool kF32>
int launch(const void* a, const void* shifts, const void* widths,
           const void* words, void* out, long long nb, void* stream) {
  if (nb <= 0) return 0;
  const long long per_cta = static_cast<long long>(kRun) * kWarps;
  const long long grid = (nb + per_cta - 1) / per_cta;
  decode_kernel<kF32><<<static_cast<unsigned>(grid), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const int32_t*>(shifts),
      static_cast<const int32_t*>(widths),
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks one warp decodes, and one CTA: the tests cut block counts there.
long long decode_pages_blocks_per_warp() { return kRun; }
long long decode_pages_blocks_per_cta() {
  return static_cast<long long>(kRun) * kWarps;
}

// slopes i32 [nb], widths i32 [nb], words u32 [nb,128] -> out i32 [nb,128]
int decode_ts_pages(const void* slopes, const void* widths, const void* words,
                    void* out, long long nb, void* stream) {
  return launch<false>(slopes, nullptr, widths, words, out, nb, stream);
}

// firsts u32 [nb], shifts i32 [nb], widths i32 [nb], words u32 [nb,128]
// -> out f32 [nb,128]
int decode_f32_pages(const void* firsts, const void* shifts,
                     const void* widths, const void* words, void* out,
                     long long nb, void* stream) {
  return launch<true>(firsts, shifts, widths, words, out, nb, stream);
}

}  // extern "C"
