// Philox4x32-10 (Random123, Salmon et al., SC'11) for the port's kernels.
//
// The streams the kernels draw are specified in gossip_tpu_torch/ops/philox.py
// (the plain torch twin computes the same bits); this header is the one
// device-side implementation of the generator they share.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gossip {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// The ten rounds' keys of one (k0, k1), computed once on the host and
// passed as a kernel argument: each round's xor then reads its key from
// the constant bank, where a kernel that keeps many calls in flight
// would otherwise recompute the key schedule for every call.
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

inline PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
  for (int r = 0; r < 10; ++r) {
    keys.k0[r] = k0 + static_cast<uint32_t>(r) * kPhiloxW0;
    keys.k1[r] = k1 + static_cast<uint32_t>(r) * kPhiloxW1;
  }
  return keys;
}

// The generator on precomputed keys, each round's two products written
// as 32 x 32 -> 64-bit multiplies (one wide multiply-add each).  Every
// kernel of the port, the calibration microkernels included, draws
// through this one form, so the calibrated rate is that of the round
// kernels' own code.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c,
                                               const PhiloxKeys& keys) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ keys.k0[r],
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ keys.k1[r],
                   static_cast<uint32_t>(p0));
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(uint4 r, int t) {
  return t == 0 ? r.x : t == 1 ? r.y : t == 2 ? r.z : r.w;
}

}  // namespace gossip
