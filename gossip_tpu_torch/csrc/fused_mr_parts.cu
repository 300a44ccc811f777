// Measurement variants of kernel 2's operand path, timed by chip_smoke.py's
// mr_parts phase to break a launch's time down by part.  No run launches
// them; they replace no TPU kernel.
//
// Variant 0 is the generic instantiation fused_mr_round.cu had before its
// operand path (fused_mr_round_kernel<false>: any fanout, the operands and
// the injected bits read from the arguments, one staging buffer looped
// over the draws, the pulled words in a shared tile, one Philox call a
// word a draw), so one call can time it beside the operand path.  The
// other variants knock one part out at compile time, or flip one choice
// (their results are not the round's unless said):
//   1  variant 0 with the Philox call replaced by a multiply-xorshift of
//      the word index (the difference is what the draws cost);
//   2  variant 0 without the pulled tile: the earlier draws' words are
//      neither stored nor read back;
//   4  the operand path (fused_mr_ops.cuh) with its Philox call replaced
//      the same way;
//   5  the operand path without PREFETCH: the own table and alive words
//      read in the epilogue, three blocks an SM (the same function).
// Variants 4 and 5 take fanout 1 or 2 to 4 under alive and cut words.
//
// Entry points: fused_mr_parts_launch (fused_mr_round_launch's arguments
// after the variant) and fused_mr_parts_occupancy (the variant's dynamic
// shared memory and resident blocks per SM).  Both return a cudaError_t.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_mr_ops.cuh"
#include "philox.cuh"
#include "rumor_counts.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;
using gossip::philox_word;

constexpr int kLanes = 128;
constexpr int kRows = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneStep = kWarps / 2;
constexpr int kTile = kLanes * kRows;
constexpr int kCountBits = 5;

__device__ __forceinline__ void copy_async(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned int at =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void count_pair(uint32_t* slice, uint32_t a,
                                           uint32_t b) {
  uint32_t carry = (slice[0] & a) | (slice[0] & b) | (a & b);
  slice[0] ^= a ^ b;
#pragma unroll
  for (int k = 1; k < kCountBits; ++k) {
    const uint32_t next = slice[k] & carry;
    slice[k] ^= carry;
    carry = next;
  }
}

// The replaced generic instantiation; NO_PHILOX and NO_TILE as above.
template <bool NO_PHILOX, bool NO_TILE>
__global__ void __launch_bounds__(kThreads)
old_generic_kernel(const uint32_t* __restrict__ tin,
                   uint32_t* __restrict__ tout,
                   const uint32_t* __restrict__ alive,
                   const uint32_t* __restrict__ cut,
                   const uint32_t* __restrict__ sbits,
                   const uint32_t* __restrict__ rbits,
                   uint32_t* __restrict__ pop, uint32_t rows, int fanout,
                   const PhiloxKeys keys, uint32_t thr, uint32_t n,
                   int rumors) {
  const bool has_alive = alive != nullptr;
  const bool has_cut = cut != nullptr;
  const bool has_rbits = rbits != nullptr;
  const int draws = fanout;
  const uint32_t coin = thr;

  extern __shared__ uint32_t smem[];
  uint32_t* shift = smem;
  uint32_t* stage = shift + draws * kLanes;
  uint32_t* own = stage + kTile;
  uint32_t* stage_alive = own + kTile;
  uint32_t* stage_cut = stage_alive + (has_alive ? kTile : 0);
  uint32_t* pulled_s = stage_cut + (has_cut ? kTile : 0);
  __shared__ uint32_t block_counts[32];

  for (int t = threadIdx.x; t < draws * kLanes; t += kThreads) {
    const uint32_t f = t / kLanes;
    const uint32_t j = t % kLanes;
    const uint32_t word =
        sbits ? sbits[f * 8 * kLanes + j]
              : philox4x32_10(make_uint4(j, f, 1u, 0u), keys).x;
    shift[t] = word % rows;
  }
  if (threadIdx.x < 32) block_counts[threadIdx.x] = 0u;

  const uint32_t warp = threadIdx.x / 32;
  const uint32_t r = (warp & 1) * 32 + threadIdx.x % 32;
  const uint32_t j0 = warp >> 1;
  const uint32_t i0 = blockIdx.x * kRows;
  const uint32_t i = i0 + r;
  const bool in = i < rows;
  const bool full = i0 + kRows <= rows &&
                    static_cast<uint64_t>(i0 + kRows) * kLanes <= n;

  auto partner_of = [&](uint32_t j, int f) {
    const uint32_t at = j * rows + i;
    uint32_t rb = 0u;
    if (has_rbits) {
      if (in) rb = rbits[static_cast<size_t>(f) * kLanes * rows + at];
    } else if (NO_PHILOX) {
      uint32_t h = (i * kLanes + j) * 0x9E3779B9u + f * 0x85EBCA6Bu +
                   keys.k0[0];
      h ^= h >> 15;
      rb = h * 0x2C1B3C6Du;
    } else {
      rb = philox_word(philox4x32_10(make_uint4(i * kLanes + j,
                                                static_cast<uint32_t>(f >> 2),
                                                0u, 0u),
                                     keys),
                       f & 3);
    }
    const uint32_t from = (rb & (kLanes - 1)) * kRows + r;
    uint32_t partner = stage[from];
    if (has_alive) partner &= stage_alive[from];
    if (coin && (rb >> 12) < coin) partner = 0u;
    if (has_cut && in && stage_cut[from] != cut[at]) partner = 0u;
    return partner;
  };

  uint32_t slice[kCountBits] = {};
  for (int f = 0; f < draws; ++f) {
    __syncthreads();
    if (in) {
#pragma unroll 4
      for (uint32_t m = j0; m < kLanes; m += kLaneStep) {
        uint32_t row = i + rows - shift[f * kLanes + m];
        if (row >= rows) row -= rows;
        const uint32_t at = m * rows + row;
        const uint32_t slot = m * kRows + r;
        copy_async(stage + slot, tin + at);
        if (has_alive) copy_async(stage_alive + slot, alive + at);
        if (has_cut) copy_async(stage_cut + slot, cut + at);
        if (f == 0) copy_async(own + slot, tin + m * rows + i);
      }
    }
    copies_done();
    __syncthreads();

    if (f + 1 < draws) {
      if (!NO_TILE) {
        for (uint32_t j = j0; j < kLanes; j += kLaneStep) {
          const uint32_t slot = j * kRows + r;
          pulled_s[slot] = partner_of(j, f) | (f > 0 ? pulled_s[slot] : 0u);
        }
      }
      continue;
    }
    // The last draw: OR in, mask, store, count.  Every warp runs the same
    // lanes, as the count's warp transpose needs.
    auto finish = [&](uint32_t j, bool guard) {
      const uint32_t slot = j * kRows + r;
      const uint32_t at = j * rows + i;
      uint32_t pulled = partner_of(j, f);
      if (!NO_TILE && f > 0) pulled |= pulled_s[slot];
      uint32_t acc = 0u;
      if (!guard || (in && i * kLanes + j < n))
        acc = own[slot] | (has_alive ? pulled & alive[at] : pulled);
      if (!guard || in) tout[at] = acc;
      return acc;
    };
    if (full) {
#pragma unroll 2
      for (uint32_t j = j0; j < kLanes; j += 2 * kLaneStep)
        count_pair(slice, finish(j, false), finish(j + kLaneStep, false));
    } else {
      for (uint32_t j = j0; j < kLanes; j += 2 * kLaneStep)
        count_pair(slice, finish(j, true), finish(j + kLaneStep, true));
    }
  }
  if (pop) {
    uint32_t count = 0u;
#pragma unroll
    for (int k = 0; k < kCountBits; ++k)
      count += gossip::warp_bit_count(slice[k]) << k;
    gossip::add_rumor_counts(count, block_counts, pop, rumors);
  }
}

using Kernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, const uint32_t*,
                        uint32_t*, uint32_t, int, const PhiloxKeys, uint32_t,
                        uint32_t, int);

struct Plan {
  Kernel kernel;
  int threads;
  int rows_per_block;
  size_t smem_bytes;
};

Plan old_plan(int variant, int fanout, bool alive, bool cut) {
  static const Kernel kernels[3] = {old_generic_kernel<false, false>,
                                    old_generic_kernel<true, false>,
                                    old_generic_kernel<false, true>};
  const size_t tiles = 2 + (alive ? 1 : 0) + (cut ? 1 : 0) +
                       (fanout > 1 && variant != 2 ? 1 : 0);
  return {kernels[variant], kThreads, kRows,
          (static_cast<size_t>(fanout) * kLanes + tiles * kTile) *
              sizeof(uint32_t)};
}

bool plan_of(int variant, int fanout, bool alive, bool cut, bool rbits,
             Plan* plan) {
  using gossip::mr_ops::fused_mr_ops_kernel;
  if (variant >= 0 && variant < 3) {
    *plan = old_plan(variant, fanout, alive, cut);
    return true;
  }
  const int fc = gossip::fanout_class(fanout, rbits);
  if ((variant != 4 && variant != 5) || fc == 0 || !alive || !cut)
    return false;
  static const Kernel ops[2][2] = {
      {fused_mr_ops_kernel<1, 3, true, true>,
       fused_mr_ops_kernel<4, 3, true, true>},
      {fused_mr_ops_kernel<1, 3, false, false>,
       fused_mr_ops_kernel<4, 3, false, false>}};
  *plan = {ops[variant - 4][fc == 1 ? 0 : 1], gossip::mr_ops::kThreads,
           gossip::mr_ops::kRows, gossip::ops_smem_bytes(fanout, alive, cut)};
  return true;
}

}  // namespace

extern "C" int fused_mr_parts_launch(int variant, const void* tin, void* tout,
                                     const void* alive, const void* cut,
                                     const void* sbits, const void* rbits,
                                     void* pop, int rows, int fanout,
                                     unsigned int k0, unsigned int k1,
                                     unsigned int thr, unsigned int n,
                                     int rumors, void* stream) {
  if (rows <= 0 || fanout <= 0 || fanout > gossip::kOpsMaxFanout ||
      rumors <= 0 || rumors > 32 ||
      static_cast<unsigned long long>(rows) * kLanes > 0xFFFFFFFFull ||
      n > static_cast<unsigned int>(rows) * kLanes ||
      (sbits == nullptr) != (rbits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  if (!plan_of(variant, fanout, alive, cut, rbits, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + plan.rows_per_block - 1) / plan.rows_per_block);
  plan.kernel<<<grid, plan.threads, plan.smem_bytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tin), static_cast<uint32_t*>(tout),
      static_cast<const uint32_t*>(alive), static_cast<const uint32_t*>(cut),
      static_cast<const uint32_t*>(sbits),
      static_cast<const uint32_t*>(rbits), static_cast<uint32_t*>(pop),
      static_cast<uint32_t>(rows), fanout, gossip::philox_keys(k0, k1), thr,
      n, rumors);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_mr_parts_occupancy(int variant, int fanout, int alive,
                                        int cut, int rbits, int* smem_bytes,
                                        int* blocks_per_sm) {
  Plan plan;
  if (fanout <= 0 || fanout > gossip::kOpsMaxFanout ||
      !plan_of(variant, fanout, alive != 0, cut != 0, rbits != 0, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(plan.smem_bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, plan.kernel, plan.threads, plan.smem_bytes));
}
