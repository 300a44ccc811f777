// Kernel 2's operand path (csrc/fused_mr_round.cu): the multi-rumor round
// on the lane-major table under a drop threshold, alive and cut words, any
// fanout and injected bits, for Hopper (sm_90a).  fused_mr_round.cu
// launches it for every call its straight-line fast path does not take;
// fused_mr_parts.cu times a variant of it.
//
// It computes what fused_mr_round_lanes_plain computes (the function is
// stated at the top of fused_mr_round.cu).  What bounds it: bytes.  Under
// alive and cut the function reads the table, the alive words and the cut
// words once and writes the table once: at 10M x 32 rumors 160 MB, 0.0478
// ms at 3.35 TB/s (tools/roofline mr_round_work(alive=True, cut=True)).
// The staging below reads each draw's partner runs of all three arrays:
// 120 MB a draw, plus 160 MB of own words and the write, so 280 MB at
// fanout 1 and 400 MB at fanout 2; blocks staging the same lane's
// neighbouring runs meet in L2, but the three 40 MB arrays do not fit the
// 50 MB L2 together, so most partner runs come from device memory.  That
// staging, not the draws or the pulls, is what holds this path above its
// bound (chip_smoke.py's mr_parts phase times each part).
//
// The design (fused_mr_parts.cu keeps the generic instantiation it
// replaced; chip_smoke.py's mr_parts phase breaks both down by part):
//  * Instantiations by fanout class and operand set, known at compile
//    time: FC = 1 (one draw: the rumor planes under a fault program), FC
//    = 4 (two to four draws: one Philox call a word, churn-sweep --engine
//    fused's fanout 2), each with or without alive and cut words (OPS bit
//    0 and bit 1); FC = 0 reads the operands from the arguments and takes
//    any fanout, in groups of four draws a Philox call, and injected
//    bits.  The drop threshold is a compare a draw in every one.
//  * A block owns kRows = 32 destination rows with 512 threads; thread
//    (warp w, lane l) holds row l and lanes w + 16k, k < 8, so a warp's
//    copies, own loads and store are 128 coalesced bytes and its staged
//    reads stage[m][l] sit in bank l whatever m is.
//  * Shared memory holds only staging: per draw buffer one tile of 4096
//    partner words and one of their alive and one of their cut words
//    (16 KB each), and the draws' lane shifts.  Under both operands FC =
//    1 takes 49,664 B and FC = 4 at fanout 2, double-buffering the
//    draws, 99,328 B; with 64 registers a thread, two blocks (32 warps)
//    are resident an SM in either.
//  * A word's state lives in registers: one Philox call gives its four
//    draws, each packed into a byte (lane m in bits 0-6, the drop coin's
//    keep bit in bit 7); its own table, alive and cut words are loaded
//    once, before the first copies are waited for, and the pulls, masked
//    by the alive word, are ORed into the table word.  The draws and the
//    own loads run while the copies are in flight.
//  * Draw f + 2 is staged into the buffer draw f read, as soon as every
//    thread has read it (cp.async commit groups, wait_group 1 then 0), so
//    a draw's copies overlap the previous draw's pulls.
//
// The stream is the one fused_mr_round.cu states, bit for bit: draw f of
// word w is Philox(ctr = (w, f >> 2, 0, 0))[f & 3].

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "rumor_counts.cuh"

namespace gossip {

constexpr int kOpsMaxFanout = 64;   // shifts: fanout * 512 B of shared memory

namespace mr_ops {

constexpr int kLanes = 128;
constexpr int kRows = 32;                  // destination rows a block owns
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kLanes / kWarps;    // 8 words a thread
constexpr int kTile = kLanes * kRows;      // words of one staged tile
constexpr int kCountBits = 4;

static_assert(kRows == 32, "a warp holds 32 consecutive rows of a lane");
static_assert(kWords < (1 << kCountBits) && kWords % 2 == 0,
              "a thread counts its words in pairs in four slices");

__device__ __forceinline__ void copy_async(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned int at =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of the committed groups are in flight.
template <int pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
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

// A draw's byte: the partner's lane, and bit 7 set when the pull is kept
// (the coin field rb >> 12 at or above the threshold).
__device__ __forceinline__ uint32_t draw_byte(uint32_t rb, uint32_t thr) {
  return (rb & (kLanes - 1)) | ((rb >> 12) >= thr ? 0x80u : 0u);
}

// FC: 1, 4 or 0 (above); OPS: bit 0 alive words, bit 1 cut words (FC = 0
// reads them from the arguments); PREFETCH: the own table and alive words
// are loaded with the own cut words, before the copies are waited for,
// and the pulls are ORed into them; else (a measurement variant,
// fused_mr_parts.cu) they are loaded in the epilogue, and the register
// budget allows a third block an SM.  NO_PHILOX: a measurement variant
// whose draws are a multiply-xorshift of the word index.
template <int FC, int OPS, bool PREFETCH, bool NO_PHILOX>
__global__ void __launch_bounds__(kThreads, PREFETCH ? 2 : 3)
fused_mr_ops_kernel(const uint32_t* __restrict__ tin,
                    uint32_t* __restrict__ tout,
                    const uint32_t* __restrict__ alive,
                    const uint32_t* __restrict__ cut,
                    const uint32_t* __restrict__ sbits,
                    const uint32_t* __restrict__ rbits,
                    uint32_t* __restrict__ pop, uint32_t rows, int fanout,
                    const PhiloxKeys keys, uint32_t thr, uint32_t n,
                    int rumors) {
  constexpr bool kRuntime = FC == 0;
  const bool has_alive = kRuntime ? alive != nullptr : (OPS & 1) != 0;
  const bool has_cut = kRuntime ? cut != nullptr : (OPS & 2) != 0;
  const bool inject = kRuntime && rbits != nullptr;
  const int draws = FC == 1 ? 1 : FC == 4 ? min(fanout, 4) : fanout;
  const int tiles = 1 + (has_alive ? 1 : 0) + (has_cut ? 1 : 0);

  extern __shared__ uint32_t smem[];
  uint32_t* shift = smem;                        // [draws][128]
  uint32_t* bufs = shift + draws * kLanes;       // [2][tiles][kTile]
  __shared__ uint32_t block_counts[32];

  for (int t = threadIdx.x; t < draws * kLanes; t += kThreads) {
    const uint32_t f = t / kLanes;
    const uint32_t j = t % kLanes;
    const uint32_t word =
        inject ? sbits[f * 8 * kLanes + j]
               : philox4x32_10(make_uint4(j, f, 1u, 0u), keys).x;
    shift[t] = word % rows;
  }
  if (threadIdx.x < 32) block_counts[threadIdx.x] = 0u;
  __syncthreads();

  const uint32_t r = threadIdx.x % 32;
  const uint32_t j0 = threadIdx.x / 32;
  const uint32_t i = blockIdx.x * kRows + r;
  const bool in = i < rows;

  // tile t of draw f's buffer: 0 the partners' words, then their alive
  // words, then their cut words
  auto tile = [&](int f, int t) {
    return bufs + ((f & 1) * tiles + t) * kTile;
  };
  // Stage draw f: lane m's run [m][r] = T[m, (i0 + r - s_m) mod R], and
  // the same runs of the alive and cut words, as one commit group.
  auto stage = [&](int f) {
    if (in) {
      uint32_t* st = tile(f, 0);
      uint32_t* sa = tile(f, 1);
      uint32_t* sc = tile(f, has_alive ? 2 : 1);
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const uint32_t m = j0 + k * kWarps;
        uint32_t row = i + rows - shift[f * kLanes + m];
        if (row >= rows) row -= rows;
        const uint32_t at = m * rows + row;
        const uint32_t slot = m * kRows + r;
        copy_async(st + slot, tin + at);
        if (has_alive) copy_async(sa + slot, alive + at);
        if (has_cut) copy_async(sc + slot, cut + at);
      }
    }
    commit_copies();
  };

  uint32_t packed[kWords];     // the current group's four draws a word
  uint32_t cut_own[kWords];
  uint32_t alive_own[kWords];  // PREFETCH only
  uint32_t acc[kWords];        // PREFETCH: the own word and the masked
                               // pulls; else the pulls so far
  // draws 4g .. 4g + 3 of the thread's words, one Philox call a word
  auto draw_group = [&](int g) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t j = j0 + k * kWarps;
      const uint32_t w = i * kLanes + j;
      uint32_t rb[4];
      if (inject) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int f = 4 * g + q;
          rb[q] = in && f < draws
                      ? rbits[static_cast<size_t>(f) * kLanes * rows +
                              j * rows + i]
                      : 0u;
        }
      } else if (NO_PHILOX) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t h = w * 0x9E3779B9u + (4 * g + q) * 0x85EBCA6Bu +
                       keys.k0[0];
          h ^= h >> 15;
          rb[q] = h * 0x2C1B3C6Du;
        }
      } else {
        const uint4 v = philox4x32_10(
            make_uint4(w, static_cast<uint32_t>(g), 0u, 0u), keys);
        rb[0] = v.x;
        rb[1] = v.y;
        rb[2] = v.z;
        rb[3] = v.w;
      }
      uint32_t p = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) p |= draw_byte(rb[q], thr) << (8 * q);
      packed[k] = p;
    }
  };
  // the word draw f pulls into word k, masked by the own alive word when
  // that is in a register: 0 when dropped or cut off
  auto pull = [&](int k, int f) {
    const uint32_t b = packed[k] >> (8 * (f & 3));
    const uint32_t from = (b & (kLanes - 1)) * kRows + r;
    uint32_t p = tile(f, 0)[from];
    if (has_alive) p &= tile(f, 1)[from];
    if (PREFETCH && has_alive) p &= alive_own[k];
    if (has_cut && tile(f, has_alive ? 2 : 1)[from] != cut_own[k]) p = 0u;
    return (b & 0x80u) ? p : 0u;
  };

  stage(0);
  if (draws > 1) stage(1);
  // while the copies fly: the own words the pulls need, and the first
  // draws
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t at = (j0 + k * kWarps) * rows + i;
    if (has_cut) cut_own[k] = in ? cut[at] : 0u;
    if (PREFETCH && has_alive) alive_own[k] = in ? alive[at] : 0u;
    acc[k] = PREFETCH && in ? tin[at] : 0u;
  }
  draw_group(0);

  // every draw but the last: pull into the registers, then restage
  for (int f = 0; f + 1 < draws; ++f) {
    if (kRuntime && f > 0 && (f & 3) == 0) draw_group(f >> 2);
    wait_copies<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWords; ++k) acc[k] |= pull(k, f);
    if (f + 2 < draws) {
      __syncthreads();   // every thread has read the buffer draw f used
      stage(f + 2);
    }
  }
  const int f = draws - 1;
  if (kRuntime && f > 0 && (f & 3) == 0) draw_group(f >> 2);
  wait_copies<0>();
  __syncthreads();

  // The last draw: OR in, mask, store, count, only the words of rows in
  // the table and of real nodes.  Every warp runs the same lanes, as the
  // count's warp transpose needs.
  uint32_t slice[kCountBits] = {};
  auto finish = [&](int k) {
    const uint32_t j = j0 + k * kWarps;
    const uint32_t at = j * rows + i;
    const uint32_t pulled = acc[k] | pull(k, f);
    uint32_t out = 0u;
    if (in && i * kLanes + j < n)
      out = PREFETCH ? pulled
                     : tin[at] | (has_alive ? pulled & alive[at] : pulled);
    if (in) tout[at] = out;
    return out;
  };
#pragma unroll
  for (int k = 0; k < kWords; k += 2)
    count_pair(slice, finish(k), finish(k + 1));
  if (pop) {
    uint32_t count = 0u;
#pragma unroll
    for (int k = 0; k < kCountBits; ++k)
      count += warp_bit_count(slice[k]) << k;
    add_rumor_counts(count, block_counts, pop, rumors);
  }
}

}  // namespace mr_ops

using MrKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                          const uint32_t*, const uint32_t*, const uint32_t*,
                          uint32_t*, uint32_t, int, const PhiloxKeys,
                          uint32_t, uint32_t, int);

// The operand path's instantiation for a call, its block and its dynamic
// shared memory.
struct OpsPlan {
  MrKernel kernel;
  int threads;
  int rows_per_block;
  size_t smem_bytes;
  int fanout_class;
};

inline int fanout_class(int fanout, bool rbits) {
  return rbits || fanout > 4 ? 0 : fanout == 1 ? 1 : 4;
}

inline size_t ops_smem_bytes(int fanout, bool alive, bool cut) {
  const size_t tiles = 1 + (alive ? 1 : 0) + (cut ? 1 : 0);
  const size_t buffers = fanout > 1 ? 2 : 1;
  return (static_cast<size_t>(fanout) * mr_ops::kLanes +
          buffers * tiles * mr_ops::kTile) *
         sizeof(uint32_t);
}

// The shipped instantiations, all prefetching the own words.
inline OpsPlan ops_plan(int fanout, bool alive, bool cut, bool rbits) {
  using mr_ops::fused_mr_ops_kernel;
  static const MrKernel by_class[2][4] = {
      {fused_mr_ops_kernel<1, 0, true, false>,
       fused_mr_ops_kernel<1, 1, true, false>,
       fused_mr_ops_kernel<1, 2, true, false>,
       fused_mr_ops_kernel<1, 3, true, false>},
      {fused_mr_ops_kernel<4, 0, true, false>,
       fused_mr_ops_kernel<4, 1, true, false>,
       fused_mr_ops_kernel<4, 2, true, false>,
       fused_mr_ops_kernel<4, 3, true, false>}};
  const int fc = fanout_class(fanout, rbits);
  const int ops = (alive ? 1 : 0) | (cut ? 2 : 0);
  const MrKernel kernel = fc == 0 ? fused_mr_ops_kernel<0, 0, true, false>
                                  : by_class[fc == 1 ? 0 : 1][ops];
  return {kernel, mr_ops::kThreads, mr_ops::kRows,
          ops_smem_bytes(fanout, alive, cut), fc};
}

}  // namespace gossip
