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

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(uint4 r, int t) {
  return t == 0 ? r.x : t == 1 ? r.y : t == 2 ? r.z : r.w;
}

}  // namespace gossip
