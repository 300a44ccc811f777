// The roofline's three calibration microkernels, for Hopper (sm_90a).
//
// Replaces: tools/roofline.py::calibrate's prng_body (line 148),
// prng_gather_body (line 156) and vpu_body (line 169), reached through
// _microkernel's pl.pallas_call.  Each measures one primitive rate of the
// fused round kernels at the shape those kernels use, a uint32[R, 128] table
// (R = 2448 at N = 10M), read and written in place as the reference's
// aliased call does:
//  * prng:        out[i,j] = tin[i,j] | OR_{d<32} draw_d(w);
//  * prng_gather: out[i,j] = tin[i,j] | OR_{d<32} tin[i, draw_d(w) & 127];
//  * vpu:         acc = tin[i,j]; for k < 256: acc = (acc ^ (s+k)) | (acc>>1).
// draw_d(w) of word w = i*128 + j is the single-rumor round's stream
// (gossip_tpu_torch/ops/philox.py): Philox(ctr = (w, d >> 2, 0, 0))[d & 3]
// under the key (k0, k1) the wrapper passes; chained iteration i passes
// round_key(i, i) = (uint32(i) * 1000003, i), the reference's seed pair
// [i * 1000003, i], and vpu's s is that k0.  Injected bits rbits[d, i, j]
// replace the stream where given.
//
// What bounds them on this card: integer ALU work (8 Philox4x32-10 calls a
// word; 256 two-instruction steps a word) against 8 bytes of table traffic
// a word, so operations, as in the round kernels they calibrate.
//
// What the design does about it: nothing beyond the round kernels' own
// layout, on purpose: they measure the card's rates at the real kernels'
// shape, so one thread per word and one 128-thread block per row, no loop
// inside a launch, and Philox through philox.cuh's one form, the round
// kernels' own (its ten round keys computed on the host and read from the
// constant bank, each product one wide multiply).
// prng_gather stages its row in shared memory and syncs before any write,
// so it too runs in place.  The vpu chain is unrolled with k a
// compile-time constant.  The injected variants are separate
// instantiations, so the timed code is straight-line.
//
// C entry points: cal_prng_launch, cal_prng_gather_launch and
// cal_vpu_launch, plain C interface, bound with ctypes by
// gossip_tpu_torch/ops/_kernels.py; each returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;

constexpr int kLanes = 128;
constexpr int kDraws = 32;
constexpr int kVpuChain = 256;

template <bool INJECT>
__global__ void __launch_bounds__(kLanes)
cal_prng_kernel(uint32_t* t, const uint32_t* __restrict__ rbits,
                const PhiloxKeys keys, size_t draw_stride) {
  const uint32_t w = blockIdx.x * kLanes + threadIdx.x;
  uint32_t acc = t[w];
#pragma unroll
  for (int q = 0; q < kDraws / 4; ++q) {
    if (INJECT) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc |= rbits[(4 * q + u) * draw_stride + w];
    } else {
      const uint4 r = philox4x32_10(
          make_uint4(w, static_cast<uint32_t>(q), 0u, 0u), keys);
      acc |= r.x | r.y | r.z | r.w;
    }
  }
  t[w] = acc;
}

template <bool INJECT>
__global__ void __launch_bounds__(kLanes)
cal_prng_gather_kernel(uint32_t* t, const uint32_t* __restrict__ rbits,
                       const PhiloxKeys keys, size_t draw_stride) {
  __shared__ uint32_t row[kLanes];
  const uint32_t w = blockIdx.x * kLanes + threadIdx.x;
  uint32_t acc = t[w];
  row[threadIdx.x] = acc;
  __syncthreads();  // the whole pre-call row before any draw reads it
#pragma unroll
  for (int q = 0; q < kDraws / 4; ++q) {
    uint32_t rb[4];
    if (INJECT) {
#pragma unroll
      for (int u = 0; u < 4; ++u) rb[u] = rbits[(4 * q + u) * draw_stride + w];
    } else {
      const uint4 r = philox4x32_10(
          make_uint4(w, static_cast<uint32_t>(q), 0u, 0u), keys);
      rb[0] = r.x;
      rb[1] = r.y;
      rb[2] = r.z;
      rb[3] = r.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc |= row[rb[u] & (kLanes - 1)];
  }
  t[w] = acc;
}

__global__ void __launch_bounds__(kLanes)
cal_vpu_kernel(uint32_t* t, uint32_t s) {
  const uint32_t w = blockIdx.x * kLanes + threadIdx.x;
  uint32_t acc = t[w];
#pragma unroll
  for (uint32_t k = 0; k < kVpuChain; ++k) acc = (acc ^ (s + k)) | (acc >> 1);
  t[w] = acc;
}

}  // namespace

// t: uint32[rows, 128], updated in place; rbits: uint32[32, rows, 128] or
// null (then the Philox stream under (k0, k1)).  Launch on `stream`.
extern "C" int cal_prng_launch(void* t, const void* rbits, int rows,
                               unsigned int k0, unsigned int k1,
                               void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* a_t = static_cast<uint32_t*>(t);
  const auto* a_rbits = static_cast<const uint32_t*>(rbits);
  const size_t stride = static_cast<size_t>(rows) * kLanes;
  const PhiloxKeys keys = gossip::philox_keys(k0, k1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_rbits) {
    cal_prng_kernel<true><<<rows, kLanes, 0, st>>>(a_t, a_rbits, keys,
                                                   stride);
  } else {
    cal_prng_kernel<false><<<rows, kLanes, 0, st>>>(a_t, nullptr, keys,
                                                    stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cal_prng_gather_launch(void* t, const void* rbits, int rows,
                                      unsigned int k0, unsigned int k1,
                                      void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* a_t = static_cast<uint32_t*>(t);
  const auto* a_rbits = static_cast<const uint32_t*>(rbits);
  const size_t stride = static_cast<size_t>(rows) * kLanes;
  const PhiloxKeys keys = gossip::philox_keys(k0, k1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_rbits) {
    cal_prng_gather_kernel<true><<<rows, kLanes, 0, st>>>(a_t, a_rbits, keys,
                                                          stride);
  } else {
    cal_prng_gather_kernel<false><<<rows, kLanes, 0, st>>>(a_t, nullptr,
                                                           keys, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// s: the chain's seed word, uint32(int32(i) * 1000003) for iteration i.
extern "C" int cal_vpu_launch(void* t, int rows, unsigned int s,
                              void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cal_vpu_kernel<<<rows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(t), s);
  return static_cast<int>(cudaGetLastError());
}
