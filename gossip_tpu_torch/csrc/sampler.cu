// Uniform complete-graph peer sampler, for Hopper (sm_90a).
//
// Replaces: gossip_tpu/ops/pallas_sampling.py::_sampler_kernel, reached
// through sample_targets_pallas's pl.pallas_call.  It computes, for every
// output element out[i, c] (i < n_rows, c < k) from one 32-bit draw u:
//   exclude_self and n_total > 1:  t = u % (n_total - 1);  t + (t >= i)
//   otherwise:                     u % n_total
// with i the global row id, exactly the TPU kernel's mapping.  What it does
// not copy: the TPU kernel reseeds its hardware generator per 4096-row grid
// block and pads the rows to that block; here there is no blocking and the
// output is the exact [n_rows, k].
//
// The stream (no GPU has the TPU's hardware generator; the port's stream
// is specified in gossip_tpu_torch/ops/philox.py and mirrored here):
//   key (k0, k1) = (uint32(seed scalar), 0x5A3);
//   element e = i*k + c draws Philox(ctr = (e >> 2, 0, 2, 0))[e & 3].
// Injected bits (uint32[n_rows, k]) replace the stream, so the kernel is
// bitwise-comparable with its plain version under any bits.
//
// What bounds it on this card: at N = 10M and k = 1 it writes 40 MB (0.012
// ms at 3.35 TB/s) and spends about 34 integer instructions a draw (a
// quarter of a 40-instruction Philox call, a 32-bit remainder by a runtime
// divisor, the self-exclusion compare and add): bound by operations.  The
// design: one thread per four consecutive elements, so one Philox call
// serves a thread and its four stores are one 16-byte vector when aligned;
// the row id is divided out once per thread and stepped after that.  The
// hardware remainder is kept (a magic-number division is later work).
//
// C entry point: sampler_launch, plain C interface, bound with ctypes by
// gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;
using gossip::philox_word;

constexpr uint32_t kSamplerSalt = 0x5A3u;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sampler_kernel(int32_t* __restrict__ out, const uint32_t* __restrict__ inject,
               unsigned long long total, uint32_t k, uint32_t n_total,
               int exclude_self, const PhiloxKeys keys) {
  const unsigned long long q =
      static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned long long e0 = q * 4ull;
  if (e0 >= total) return;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!inject)
    r = philox4x32_10(make_uint4(static_cast<uint32_t>(q), 0u, 2u, 0u), keys);
  // row id i and column c of element e0, stepped per element below
  unsigned long long i = e0 / k;
  uint32_t c = static_cast<uint32_t>(e0 - i * k);
  const bool shift = exclude_self && n_total > 1u;
  const uint32_t span = shift ? n_total - 1u : n_total;
  int32_t v[4];
  const int count = total - e0 < 4ull ? static_cast<int>(total - e0) : 4;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < count) {
      const uint32_t u = inject ? inject[e0 + t] : philox_word(r, t);
      const uint32_t m = u % span;
      v[t] = static_cast<int32_t>(
          shift ? m + (static_cast<unsigned long long>(m) >= i ? 1u : 0u)
                : m);
      if (++c == k) {
        c = 0u;
        ++i;
      }
    }
  }
  if (count == 4 && (reinterpret_cast<uintptr_t>(out + e0) & 15u) == 0u) {
    *reinterpret_cast<int4*>(out + e0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int t = 0; t < count; ++t) out[e0 + t] = v[t];
  }
}

}  // namespace

// out: int32[n_rows, k]; inject: uint32[n_rows, k] or null; total =
// n_rows * k < 2^34.  Launches on `stream`.
extern "C" int sampler_launch(void* out, const void* inject,
                              unsigned long long total, unsigned int k,
                              unsigned int n_total, int exclude_self,
                              unsigned int k0, void* stream) {
  if (k == 0u || n_total == 0u || total >= (1ull << 34))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0ull) return static_cast<int>(cudaSuccess);
  const unsigned long long threads = (total + 3ull) / 4ull;
  const unsigned long long blocks = (threads + kThreads - 1) / kThreads;
  sampler_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const uint32_t*>(inject),
      total, k, n_total, exclude_self, gossip::philox_keys(k0, kSamplerSalt));
  return static_cast<int>(cudaGetLastError());
}
