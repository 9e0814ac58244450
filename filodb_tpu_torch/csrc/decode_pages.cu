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
// Bound on this card: bytes. The function needs the 4*w words that hold a
// block's 128 width-w fields (of the 128 the page reserves) and writes 128
// outputs, for about twenty integer operations a lane, far below the
// operations the SMs offer for those bytes, so it is bounded by device
// memory (3.35 TB/s). The kernel loads the whole row: a version that loaded
// only the 4*w words was no faster in a run on the card (PERF.md).
//
// Design: one 128-thread row per page block, ROWS blocks per CTA. The
// block's word row is staged in shared memory with one coalesced load, so
// the two reads a lane makes (word i*w/32 and the next) hit shared memory
// rather than device memory. The field straddling two words comes from
// __funnelshift_r (common.cuh); w = 0, w = 32 and tz >= 32 are guarded as
// the JAX code guards them with `where`.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using filodb::kBlock;
using filodb::unpack_field;

constexpr int kRows = 4;  // page blocks per CTA

__global__ void decode_ts_kernel(const int32_t* __restrict__ slopes,
                                 const int32_t* __restrict__ widths,
                                 const uint32_t* __restrict__ words,
                                 int32_t* __restrict__ out, long long nb) {
  __shared__ uint32_t srow[kRows][kBlock];
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  const long long b = static_cast<long long>(blockIdx.x) * kRows + r;
  if (b < nb) srow[r][lane] = words[b * kBlock + lane];
  __syncthreads();
  if (b >= nb) return;
  uint32_t zz = unpack_field(srow[r], lane, static_cast<uint32_t>(widths[b]));
  // unzigzag; int32 wrap-around of slope*lane as in the reference
  uint32_t resid = (zz >> 1) ^ (0u - (zz & 1u));
  uint32_t pred = static_cast<uint32_t>(slopes[b]) * static_cast<uint32_t>(lane);
  out[b * kBlock + lane] = static_cast<int32_t>(pred + resid);
}

__global__ void decode_f32_kernel(const uint32_t* __restrict__ firsts,
                                  const int32_t* __restrict__ shifts,
                                  const int32_t* __restrict__ widths,
                                  const uint32_t* __restrict__ words,
                                  float* __restrict__ out, long long nb) {
  __shared__ uint32_t srow[kRows][kBlock];
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  const long long b = static_cast<long long>(blockIdx.x) * kRows + r;
  if (b < nb) srow[r][lane] = words[b * kBlock + lane];
  __syncthreads();
  if (b >= nb) return;
  uint32_t x = unpack_field(srow[r], lane, static_cast<uint32_t>(widths[b]));
  uint32_t tz = static_cast<uint32_t>(shifts[b]);
  uint32_t xored = tz >= 32 ? 0u : (x << tz);
  out[b * kBlock + lane] = __uint_as_float(xored ^ firsts[b]);
}

}  // namespace

extern "C" {

// slopes i32 [nb], widths i32 [nb], words u32 [nb,128] -> out i32 [nb,128]
int decode_ts_pages(const void* slopes, const void* widths, const void* words,
                    void* out, long long nb, void* stream) {
  if (nb <= 0) return 0;
  dim3 block(kBlock, kRows);
  dim3 grid(static_cast<unsigned>((nb + kRows - 1) / kRows));
  decode_ts_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slopes), static_cast<const int32_t*>(widths),
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

// firsts u32 [nb], shifts i32 [nb], widths i32 [nb], words u32 [nb,128]
// -> out f32 [nb,128]
int decode_f32_pages(const void* firsts, const void* shifts,
                     const void* widths, const void* words, void* out,
                     long long nb, void* stream) {
  if (nb <= 0) return 0;
  dim3 block(kBlock, kRows);
  dim3 grid(static_cast<unsigned>((nb + kRows - 1) / kRows));
  decode_f32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(firsts), static_cast<const int32_t*>(shifts),
      static_cast<const int32_t*>(widths), static_cast<const uint32_t*>(words),
      static_cast<float*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
