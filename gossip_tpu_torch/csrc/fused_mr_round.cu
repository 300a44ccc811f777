// Fused multi-rumor pull round on a lane-major one-word-per-node table, for
// Hopper (sm_90a): the value route, one launch per round.
//
// Replaces: gossip_tpu/ops/pallas_round.py::_fused_mr_kernel, reached through
// _fused_mr_round_jit and _fused_call's pl.pallas_call.  It computes what the
// reference's plain twin _fused_mr_round_ref computes: node i*128 + j holds
// its up-to-32-rumor word at (row i, lane j) of a uint32[R,128] table; for
// every fanout draw f, every node pulls the whole word of partner
// src[(i - s_m) mod R, m], m = rb & 127, from the pre-round src = table &
// alive, drops it when rb >> 12 < thr, keeps it only when the partner's cut
// word equals its own, ANDs it with its own alive word and ORs it in; words
// of node ids >= n are zeroed.  This kernel holds the table lane-major,
// T[j, i] = word (i, j), as uint32[128, R] (and alive, cut and injected draw
// words the same way); the run loops transpose once on entry and once on
// exit.
//
// What bounds it on this card: bytes.  At N = 10M x 32 rumors, fanout 1,
// the function reads and writes the 40 MB table once (80 MB, 0.0239 ms at
// 3.35 TB/s).  Beside that it makes one Philox4x32-10 call a word (18
// wide products and 19 xors: its counter is (w, 0, 0, 0)), one pull, the
// phantom mask and the per-rumor counts: some 34 ALU-pipe instructions a
// word by the function's count (tools/roofline mr_round_work), 0.0205 ms.
// This design moves about 125 MB a round (the own tile, the staged
// partner runs with their misaligned ends, the write), all of it in
// coalesced runs, and its compiled code issues more instructions than the
// count (addresses, the loop and the staging).
//
// What the design does about it:
//  * Partners are staged from contiguous runs.  Lane m's row shift s_m
//    depends on the lane and the draw, not on the row, so for the
//    destination rows [i0, i0 + kRows) a block owns, lane m's partners are
//    T[m, (i0 - s_m + r) mod R], r < kRows: one run of kRows words.  For
//    each draw the block copies the 128 runs (and the partners' alive and
//    cut runs) into shared memory, the wrap handled per element, and
//    every pull then reads stage[m][r].  No partner is read from device
//    memory at random.  The copies are cp.async (4 bytes each: a run
//    starts at any word, so TMA's 16-byte-aligned bulk copies do not
//    fit), so no register holds a word in flight and each thread keeps
//    all of its 32 copies (16 partner words, 16 own words) outstanding
//    behind one wait.
//  * Threads: a thread's destination row r is fixed and it walks the
//    lanes j0, j0 + 8, ..., so a warp holds 32 consecutive rows of one
//    lane: its copies, its own word T[j, i0 + r] and its store are 128
//    coalesced bytes, and its staged read stage[m][r] sits in bank
//    r mod 32 whatever m is: no bank conflicts.
//  * Few instructions a word:
//    - the main path (fanout 1, the Philox stream, no drop threshold,
//      alive or cut words) is its own instantiation,
//      fused_mr_round_kernel<true>, with no operand tests, and a block
//      whose rows and nodes are all real runs its words unguarded;
//    - the one Philox call a word takes its ten round keys from the
//      constant bank (philox.cuh, PhiloxKeys: the host computes them
//      once a launch), where the compiler recomputed the key schedule
//      for every call, and each product is one wide multiply-add, where
//      it split each in two;
//    - the per-rumor counts are added a pair of words at a time into five
//      bit-sliced counters (one carry-save step and a ripple, some five
//      instructions a word), and only the block's epilogue transposes
//      them (rumor_counts.cuh: a warp bit transpose of each slice, one
//      __popc per lane, one atomicAdd per block and rumor).
//  * The per-lane shifts of every draw are computed once per block (one
//    Philox call per lane and draw) into shared memory.
//  * Fanout above 1 (fused_mr_round_kernel<false>, which also takes the
//    operands and injected bits) loops over the draws with one staging
//    buffer; the pulled words wait in shared memory between draws, and
//    each draw recomputes its word's Philox call (fanout calls a word
//    where ceil(fanout / 4) would do: the main path's fanout is 1).
//  * Random bits are computed where they are used, never stored; the stream
//    (gossip_tpu_torch/ops/philox.py, multi-rumor section) is
//      key (k0, k1) = (uint32(seed) * 1000003, uint32(round) ^ 0x5D0);
//      shift word of lane j, draw f: Philox(ctr = (j, f, 1, 0))[0] % R;
//      draw f of word w = i*128 + j: Philox(ctr = (w, f >> 2, 0, 0))[f & 3].
//    Injected bits (sbits[f, 0, j], and rbits[f, j, i], the reference's
//    inject layout with each draw's words transposed as the table is)
//    replace the stream.
//  * The round writes a second buffer: other blocks still stage from the
//    pre-round table, so the run loop ping-pongs two.
//
// Changed from the first port (row-major table, one thread a word, the
// partner src[(i - s_m) mod R, m] read by address arithmetic): each of its
// 10M partner reads took a 32-byte sector of a random row, some 320 MB a
// round for a 40 MB table, and at 100M nodes every one went to device
// memory (2.2 ms a round).  Its per-rumor counts transposed every 32
// words.
//
// C entry point: fused_mr_round_launch, plain C interface, bound with ctypes
// by gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "rumor_counts.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;
using gossip::philox_word;

constexpr int kLanes = 128;
constexpr int kRows = 64;          // destination rows a block owns
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneStep = kWarps / 2;        // a thread's lanes j0 + 8k
constexpr int kTile = kLanes * kRows;        // words of one staged tile
constexpr int kCountBits = 5;      // a thread counts 128 / kLaneStep = 16
                                   // words in bit-sliced counters
constexpr int kMaxFanout = 64;     // shifts: fanout * 512 B of shared memory

static_assert(kLanes / kLaneStep < (1 << kCountBits), "counter too narrow");
static_assert((kLanes / kLaneStep) % 2 == 0, "words are counted in pairs");

// One 4-byte asynchronous copy from device to shared memory (cp.async:
// no register holds the word, so a thread keeps all its copies in flight).
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

// Adds words a and b to the bit-sliced counters: bit b of slice[k] is
// bit k of the thread's count of rumor b.  One carry-save step into
// slice 0 (a three-input xor and a majority, one LOP3 each), then the
// carry rippled up.
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

// FAST: the main path's fanout 1 with no drop threshold, alive or cut
// words and the Philox stream, operand tests compiled out.  Otherwise any
// fanout, operands and injected bits, read from the arguments.
//
// Dynamic shared memory, in words: shift[fanout][128], then tiles of
// [128][kRows]: stage (the partners' runs), own (the block's own words),
// stage_alive (the partners' alive runs) when alive is given, stage_cut
// when cut is given, pulled (the words pulled so far) when fanout > 1.
template <bool FAST>
__global__ void __launch_bounds__(kThreads)
fused_mr_round_kernel(const uint32_t* __restrict__ tin,
                      uint32_t* __restrict__ tout,
                      const uint32_t* __restrict__ alive,
                      const uint32_t* __restrict__ cut,
                      const uint32_t* __restrict__ sbits,
                      const uint32_t* __restrict__ rbits,
                      uint32_t* __restrict__ pop, uint32_t rows, int fanout,
                      const PhiloxKeys keys, uint32_t thr, uint32_t n,
                      int rumors) {
  const bool has_alive = !FAST && alive != nullptr;
  const bool has_cut = !FAST && cut != nullptr;
  const bool has_rbits = !FAST && rbits != nullptr;
  const int draws = FAST ? 1 : fanout;
  const uint32_t coin = FAST ? 0u : thr;

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
        (!FAST && sbits) ? sbits[f * 8 * kLanes + j]
                         : philox4x32_10(make_uint4(j, f, 1u, 0u), keys).x;
    shift[t] = word % rows;
  }
  if (threadIdx.x < 32) block_counts[threadIdx.x] = 0u;

  // A thread's destination row is fixed: r = 32 * (warp & 1) + lane of
  // the block's rows, at lanes j0, j0 + 8, ..., j0 + 120; a warp's 32
  // threads hold 32 consecutive rows of one lane.
  const uint32_t warp = threadIdx.x / 32;
  const uint32_t r = (warp & 1) * 32 + threadIdx.x % 32;
  const uint32_t j0 = warp >> 1;
  const uint32_t i0 = blockIdx.x * kRows;
  const uint32_t i = i0 + r;
  const bool in = i < rows;
  // every row of the block is in the table and every node real: no word
  // of the block needs a guard
  const bool full = i0 + kRows <= rows &&
                    static_cast<uint64_t>(i0 + kRows) * kLanes <= n;

  // the word draw f pulls into T[j, i]: 0 when dropped or cut off
  auto partner_of = [&](uint32_t j, int f) {
    const uint32_t at = j * rows + i;
    uint32_t rb = 0u;
    if (has_rbits) {
      if (in) rb = rbits[static_cast<size_t>(f) * kLanes * rows + at];
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
    __syncthreads();   // the shifts are in; the last draw's reads are done
    // Stage lane m's run stage[m][r] = T[m, (i0 + r - s_m) mod R] (and
    // the partners' alive and cut runs); with the first draw, the own tile
    // own[m][r] = T[m, i0 + r].  Each warp copies 32 consecutive words.
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
      for (uint32_t j = j0; j < kLanes; j += kLaneStep) {
        const uint32_t slot = j * kRows + r;
        pulled_s[slot] = partner_of(j, f) | (f > 0 ? pulled_s[slot] : 0u);
      }
      continue;
    }
    // The last draw: OR in, mask, store, count.  Every warp runs the same
    // lanes, as the count's warp transpose needs.
    // (guard: only the words of rows in the table, and of real nodes)
    auto finish = [&](uint32_t j, bool guard) {
      const uint32_t slot = j * kRows + r;
      const uint32_t at = j * rows + i;
      uint32_t pulled = partner_of(j, f);
      if (!FAST && f > 0) pulled |= pulled_s[slot];
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

}  // namespace

// tin, tout, alive, cut: uint32[128, rows], lane-major (alive, cut may be
// null; tout is not tin); sbits: uint32[fanout, 8, 128] and rbits:
// uint32[fanout, 128, rows], both null or both given; pop: uint32[32] or
// null, gets the count of each of the first `rumors` bits of the new table
// added.  Launches on `stream`.
extern "C" int fused_mr_round_launch(const void* tin, void* tout,
                                     const void* alive, const void* cut,
                                     const void* sbits, const void* rbits,
                                     void* pop, int rows, int fanout,
                                     unsigned int k0, unsigned int k1,
                                     unsigned int thr, unsigned int n,
                                     int rumors, void* stream) {
  if (rows <= 0 || fanout <= 0 || fanout > kMaxFanout ||
      rumors <= 0 || rumors > 32 ||
      static_cast<unsigned long long>(rows) * kLanes > 0xFFFFFFFFull ||
      n > static_cast<unsigned int>(rows) * kLanes ||
      (sbits == nullptr) != (rbits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fast = fanout == 1 && !alive && !cut && !rbits && thr == 0u;
  const auto kernel =
      fast ? fused_mr_round_kernel<true> : fused_mr_round_kernel<false>;
  const size_t tiles = 2 + (alive ? 1 : 0) + (cut ? 1 : 0) +
                       (fanout > 1 ? 1 : 0);
  const size_t smem_bytes =
      (static_cast<size_t>(fanout) * kLanes + tiles * kTile) *
      sizeof(uint32_t);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tin), static_cast<uint32_t*>(tout),
      static_cast<const uint32_t*>(alive), static_cast<const uint32_t*>(cut),
      static_cast<const uint32_t*>(sbits),
      static_cast<const uint32_t*>(rbits), static_cast<uint32_t*>(pop),
      static_cast<uint32_t>(rows), fanout, gossip::philox_keys(k0, k1), thr,
      n, rumors);
  return static_cast<int>(cudaGetLastError());
}
