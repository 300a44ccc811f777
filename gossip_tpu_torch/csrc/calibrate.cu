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
// What bounds them on this card: integer work, 8 Philox4x32-10 calls a word
// (prng, prng_gather) or 256 two-instruction steps a word (vpu), against 8
// bytes of table traffic a word.  Measured on the card (NVIDIA H100 80GB
// HBM3, 700.00 W; python -m gossip_tpu_torch.tools.pipe_probe, PERF.md §6):
// the FMA pipe has 64 slots a clock an SM, a 32-bit IMAD takes one, and
// IMAD.HI and the wide product IMAD.WIDE.U32 take two (32 a clock an SM,
// half the datasheet's int32 rate); LOP3 issues at 64 on its own pipe.  So
// prng's 124 wide products and one IMAD, 249 FMA slots a word, bound it:
// 3.9 clocks an SM a word, where it takes 4.6 at N = 100M (85%).  At
// N = 10M a chained launch adds time of its own (an empty 2448-block grid
// about 3.3 us a launch, a one-block grid 0.85 us with programmatic
// dependent launch) and the last of 2.32 waves runs a third full.
//
// What the design does about it (prng and prng_gather):
//  * One Philox code path for both (word_prefix, word_call): a word's 8
//    calls, counters (w, q, 0, 0), share their first rounds, so its three
//    products of w are made once, and round 2's product of the uniform
//    word q ^ k0[0] is folded with the keys it meets on the host
//    (CalKeys::u, ::v, read from the constant bank like the ten round
//    keys): 3 + 8 * 15 = 123 wide products a word, the function's count
//    (tools/roofline.philox_pipe_ops), 124 with the global address, where
//    philox.cuh's generator called once a call compiles to 132.  The same
//    bits, bit for bit.
//  * One thread a word and one 128-thread block a row, grid = rows (no
//    tail); __launch_bounds__(128, 8) lets ptxas keep a word's 8 calls in
//    flight (61 registers, 8 blocks an SM, 2.32 waves at N = 10M).  Two or
//    four lanes a word, two words a thread, a word's calls split over
//    warps, a grid-stride wave sized from the occupancy, blocks of
//    256-1024 threads and __umulhi with a 32-bit product all measured
//    slower or no faster on the card (PERF.md §6).  A persistent grid that
//    draws all its rows before the wait is faster for prng at N = 10M but
//    slower for prng_gather, and both keep one geometry, so that the
//    prng_gather time less the prng time is the gathers' alone.
//  * Programmatic dependent launch: each step is launched with
//    cudaLaunchAttributeProgrammaticStreamSerialization, lets the next
//    launch start at once (griddepcontrol.launch_dependents) and draws
//    before griddepcontrol.wait, so one step's draws run under the last
//    one's tail and launch; every read and write of the table (and of
//    injected bits) comes after the wait, so a chained step reads the
//    table the step before it wrote, as in a plain launch.
//  * prng_gather keeps its 32 draws in registers, then stages its row in
//    shared memory and syncs before any write, so it runs in place.
//  * The injected variants are separate instantiations, so the timed code
//    is straight-line; vpu's chain is unrolled with k a compile-time
//    constant.
//
// C entry points: cal_prng_launch, cal_prng_gather_launch and
// cal_vpu_launch, plain C interface, bound with ctypes by
// gossip_tpu_torch/ops/_kernels.py; each returns cudaGetLastError().
// cal_geometry reports the drawing kernels' launch geometry.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using gossip::kPhiloxM0;
using gossip::kPhiloxM1;
using gossip::PhiloxKeys;

constexpr int kLanes = 128;
constexpr int kDraws = 32;
constexpr int kCalls = kDraws / 4;
constexpr int kVpuChain = 256;
constexpr int kMinBlocks = 8;  // resident blocks an SM ptxas budgets for

// A step's round keys and, per call q, round 2's product of the uniform
// word q ^ k0[0] folded with the keys it meets:
// u[q] = hi(M0 (q ^ k0[0])) ^ k1[1], v[q] = lo(M0 (q ^ k0[0])) ^ k1[2].
struct CalKeys {
  PhiloxKeys keys;
  uint32_t u[kCalls];
  uint32_t v[kCalls];
};

CalKeys cal_keys(uint32_t k0, uint32_t k1) {
  CalKeys k;
  k.keys = gossip::philox_keys(k0, k1);
  for (uint32_t q = 0; q < kCalls; ++q) {
    const uint64_t p = static_cast<uint64_t>(kPhiloxM0) * (q ^ k.keys.k0[0]);
    k.u[q] = static_cast<uint32_t>(p >> 32) ^ k.keys.k1[1];
    k.v[q] = static_cast<uint32_t>(p) ^ k.keys.k1[2];
  }
  return k;
}

__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t x, uint32_t& hi,
                                        uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(m) * x;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// What the calls (w, q, 0, 0) of word w share: round 1's product of w, round
// 2's product of its result and round 3's product of that (with the keys
// they meet folded in).
struct WordPrefix {
  uint32_t lo0, y2k, h3, w3;
};

__device__ __forceinline__ WordPrefix word_prefix(uint32_t w,
                                                  const CalKeys& k) {
  uint32_t h0, lo0, h1, lo1, h2, lo2;
  mulhilo(kPhiloxM0, w, h0, lo0);
  mulhilo(kPhiloxM1, h0 ^ k.keys.k1[0], h1, lo1);
  mulhilo(kPhiloxM0, h1 ^ k.keys.k0[1], h2, lo2);
  return {lo0, lo1 ^ k.keys.k0[2], h2, lo2};
}

// Philox4x32-10 of counter (w, q, 0, 0), from rounds 3 to 10: bit for bit
// philox.cuh's philox4x32_10(make_uint4(w, q, 0, 0), k.keys).
__device__ __forceinline__ uint4 word_call(const WordPrefix& s, int q,
                                           const CalKeys& k) {
  uint32_t hi, lo;
  mulhilo(kPhiloxM1, k.u[q] ^ s.lo0, hi, lo);
  uint4 c = make_uint4(hi ^ s.y2k, lo, s.h3 ^ k.v[q], s.w3);
#pragma unroll
  for (int r = 3; r < 10; ++r) {
    uint32_t h0, l0, h1, l1;
    mulhilo(kPhiloxM0, c.x, h0, l0);
    mulhilo(kPhiloxM1, c.z, h1, l1);
    c = make_uint4(h1 ^ c.y ^ k.keys.k0[r], l1, h0 ^ c.w ^ k.keys.k1[r], l0);
  }
  return c;
}

// Programmatic dependent launch: let the next launch in the stream start,
// and wait until the launch before this one has finished and its writes
// are visible.
__device__ __forceinline__ void launch_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool INJECT>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
cal_prng_kernel(uint32_t* t, const uint32_t* __restrict__ rbits,
                const CalKeys k, size_t draw_stride) {
  launch_next();
  const uint32_t w = blockIdx.x * kLanes + threadIdx.x;
  uint32_t acc = 0;
  if (INJECT) {
    wait_previous();
#pragma unroll
    for (int d = 0; d < kDraws; ++d) acc |= rbits[d * draw_stride + w];
  } else {
    const WordPrefix s = word_prefix(w, k);
#pragma unroll
    for (int q = 0; q < kCalls; ++q) {
      const uint4 r = word_call(s, q, k);
      acc |= r.x | r.y | r.z | r.w;
    }
    wait_previous();
  }
  t[w] |= acc;
}

template <bool INJECT>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
cal_prng_gather_kernel(uint32_t* t, const uint32_t* __restrict__ rbits,
                       const CalKeys k, size_t draw_stride) {
  __shared__ uint32_t row[kLanes];
  launch_next();
  const uint32_t w = blockIdx.x * kLanes + threadIdx.x;
  uint32_t rb[kDraws];
  if (INJECT) {
    wait_previous();
#pragma unroll
    for (int d = 0; d < kDraws; ++d) rb[d] = rbits[d * draw_stride + w];
  } else {
    const WordPrefix s = word_prefix(w, k);
#pragma unroll
    for (int q = 0; q < kCalls; ++q) {
      const uint4 r = word_call(s, q, k);
      rb[4 * q] = r.x;
      rb[4 * q + 1] = r.y;
      rb[4 * q + 2] = r.z;
      rb[4 * q + 3] = r.w;
    }
    wait_previous();
  }
  const uint32_t own = t[w];
  row[threadIdx.x] = own;
  __syncthreads();  // the whole pre-call row before any draw reads it
  uint32_t acc = own;
#pragma unroll
  for (int d = 0; d < kDraws; ++d) acc |= row[rb[d] & (kLanes - 1)];
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

template <bool INJECT>
using DrawKernel = void (*)(uint32_t*, const uint32_t*, const CalKeys,
                            size_t);

// One drawing step on t: uint32[rows, 128], in place, launched with
// programmatic stream serialization (the kernels wait before they touch
// memory).
template <bool INJECT>
int launch_draws(DrawKernel<INJECT> kernel, void* t, const void* rbits,
                 int rows, unsigned int k0, unsigned int k1, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(kLanes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<uint32_t*>(t),
      static_cast<const uint32_t*>(rbits), cal_keys(k0, k1),
      static_cast<size_t>(rows) * kLanes);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// t: uint32[rows, 128], updated in place; rbits: uint32[32, rows, 128] or
// null (then the Philox stream under (k0, k1)).  Launch on `stream`.
extern "C" int cal_prng_launch(void* t, const void* rbits, int rows,
                               unsigned int k0, unsigned int k1,
                               void* stream) {
  return rbits ? launch_draws<true>(cal_prng_kernel<true>, t, rbits, rows,
                                    k0, k1, stream)
               : launch_draws<false>(cal_prng_kernel<false>, t, rbits, rows,
                                     k0, k1, stream);
}

extern "C" int cal_prng_gather_launch(void* t, const void* rbits, int rows,
                                      unsigned int k0, unsigned int k1,
                                      void* stream) {
  return rbits ? launch_draws<true>(cal_prng_gather_kernel<true>, t, rbits,
                                    rows, k0, k1, stream)
               : launch_draws<false>(cal_prng_gather_kernel<false>, t, rbits,
                                     rows, k0, k1, stream);
}

// The launch geometry of the timed (stream) instantiation of prng
// (gather 0) or prng_gather (gather 1) on `rows` rows: out[0..3] = blocks,
// threads a block, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once a kernel),
// SMs of the current device.
extern "C" int cal_geometry(int gather, int rows, int* out) {
  static int per_sm[2] = {0, 0};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int g = gather ? 1 : 0;
  if (e == cudaSuccess && per_sm[g] == 0) {
    e = g ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[g], cal_prng_gather_kernel<false>, kLanes, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[g], cal_prng_kernel<false>, kLanes, 0);
  }
  out[0] = rows;
  out[1] = kLanes;
  out[2] = per_sm[g];
  out[3] = sms;
  return static_cast<int>(e);
}

// s: the chain's seed word, uint32(int32(i) * 1000003) for iteration i.
extern "C" int cal_vpu_launch(void* t, int rows, unsigned int s,
                              void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cal_vpu_kernel<<<rows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(t), s);
  return static_cast<int>(cudaGetLastError());
}
