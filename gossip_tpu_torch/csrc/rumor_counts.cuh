// Per-rumor counts of a one-word-per-node table, fused into the epilogue of
// the multi-rumor kernels (fused_mr_round.cu, mr_gather.cu).
//
// The run loop's stop test needs, per round, how many nodes hold each rumor
// (bit b of a node's word is rumor b), and then the minimum over rumors.
// Per word that is 32 separate bit counts, not one popcount.  A warp of 32
// threads, each holding one word, transposes its 32 x 32 bit matrix with
// five shuffle stages; afterwards lane b holds bit b of the warp's 32 words,
// and one __popc counts rumor b.  Lane b keeps that count in a register over
// all the words its warp stores (mr_gather.cu transposes every 32 words;
// fused_mr_round.cu first sums a thread's words in bit-sliced counters and
// transposes each slice once, weighted by its bit); at the end the block
// sums its warps in shared memory and issues one atomicAdd per rumor into
// the round's int32[32] counter slot.  Exact integers, so the order does
// not matter.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gossip {

// One stage of the warp's bit transpose: lanes l and l ^ s swap the s x s
// off-diagonal blocks (bit c of lane r <-> bit c ^ s of lane r ^ s, where
// bit s of r and of c differ).  `lo` holds the columns c with bit s clear.
__device__ __forceinline__ uint32_t transpose_stage(uint32_t x, int s,
                                                    uint32_t lo,
                                                    uint32_t lane) {
  const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, x, s);
  return (lane & s) ? ((x & ~lo) | ((other >> s) & lo))
                    : ((x & lo) | ((other << s) & ~lo));
}

// Called by all 32 lanes of a warp, each with one word: returns, on lane b,
// how many of the 32 words have bit b set.
__device__ __forceinline__ uint32_t warp_bit_count(uint32_t x) {
  const uint32_t lane = threadIdx.x & 31u;
  x = transpose_stage(x, 16, 0x0000FFFFu, lane);
  x = transpose_stage(x, 8, 0x00FF00FFu, lane);
  x = transpose_stage(x, 4, 0x0F0F0F0Fu, lane);
  x = transpose_stage(x, 2, 0x33333333u, lane);
  x = transpose_stage(x, 1, 0x55555555u, lane);
  return __popc(x);
}

// Block epilogue: every thread passes its lane's running count; the first
// `rumors` counts go to pop[0..rumors).  `block_counts` is a zeroed
// __shared__ uint32_t[32], zeroed before a __syncthreads that precedes this
// call.  Must be reached by every thread of the block.
__device__ __forceinline__ void add_rumor_counts(uint32_t count,
                                                 uint32_t* block_counts,
                                                 uint32_t* pop, int rumors) {
  if (count) atomicAdd(&block_counts[threadIdx.x & 31u], count);
  __syncthreads();
  if (threadIdx.x < static_cast<unsigned>(rumors) &&
      block_counts[threadIdx.x])
    atomicAdd(&pop[threadIdx.x], block_counts[threadIdx.x]);
}

}  // namespace gossip
