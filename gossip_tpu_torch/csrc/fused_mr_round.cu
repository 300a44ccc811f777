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
//      alive or cut words) is its own kernel, fused_mr_fast_kernel,
//      with no operand tests, and a block whose rows and nodes are all
//      real runs its words unguarded;
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
//  * Every other call (fanout above 1, a drop threshold, alive or cut
//    words, injected bits) takes the operand path of fused_mr_ops.cuh,
//    instantiated by fanout class and operand set (its own note says how
//    it is laid out; it replaced one generic instantiation, which
//    fused_mr_parts.cu keeps as a measurement variant).
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
// C entry points: fused_mr_round_launch, and fused_mr_round_occupancy (the
// instantiation a call takes, its dynamic shared memory and its resident
// blocks per SM); plain C interface, bound with ctypes by
// gossip_tpu_torch/ops/_kernels.py; each returns a cudaError_t.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_mr_ops.cuh"
#include "philox.cuh"
#include "rumor_counts.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;

constexpr int kLanes = 128;
constexpr int kRows = 64;          // destination rows a block owns
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneStep = kWarps / 2;        // a thread's lanes j0 + 8k
constexpr int kTile = kLanes * kRows;        // words of one staged tile
constexpr int kCountBits = 5;      // a thread counts 128 / kLaneStep = 16
                                   // words in bit-sliced counters
// dynamic shared memory of the fast kernel: the shifts and two tiles
constexpr size_t kFastSmemBytes = (kLanes + 2 * kTile) * sizeof(uint32_t);

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

// The main path's fanout 1 with no drop threshold, alive or cut words and
// the Philox stream.  Dynamic shared memory, in words: shift[128], then
// tiles of [128][kRows]: stage (the partners' runs), own (the block's own
// words).
__global__ void __launch_bounds__(kThreads)
fused_mr_fast_kernel(const uint32_t* __restrict__ tin,
                     uint32_t* __restrict__ tout,
                     uint32_t* __restrict__ pop, uint32_t rows,
                     const PhiloxKeys keys, uint32_t n, int rumors) {
  extern __shared__ uint32_t smem[];
  uint32_t* shift = smem;
  uint32_t* stage = shift + kLanes;
  uint32_t* own = stage + kTile;
  __shared__ uint32_t block_counts[32];

  for (int t = threadIdx.x; t < kLanes; t += kThreads)
    shift[t] = philox4x32_10(make_uint4(t, 0u, 1u, 0u), keys).x % rows;
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

  __syncthreads();   // the shifts are in
  // Stage lane m's run stage[m][r] = T[m, (i0 + r - s_m) mod R] and the
  // own tile own[m][r] = T[m, i0 + r].  Each warp copies 32 consecutive
  // words.
  if (in) {
#pragma unroll 4
    for (uint32_t m = j0; m < kLanes; m += kLaneStep) {
      uint32_t row = i + rows - shift[m];
      if (row >= rows) row -= rows;
      const uint32_t slot = m * kRows + r;
      copy_async(stage + slot, tin + m * rows + row);
      copy_async(own + slot, tin + m * rows + i);
    }
  }
  copies_done();
  __syncthreads();

  // OR in, mask, store, count.  Every warp runs the same lanes, as the
  // count's warp transpose needs.
  // (guard: only the words of rows in the table, and of real nodes)
  uint32_t slice[kCountBits] = {};
  auto finish = [&](uint32_t j, bool guard) {
    const uint32_t slot = j * kRows + r;
    const uint32_t rb =
        philox4x32_10(make_uint4(i * kLanes + j, 0u, 0u, 0u), keys).x;
    const uint32_t pulled = stage[(rb & (kLanes - 1)) * kRows + r];
    uint32_t acc = 0u;
    if (!guard || (in && i * kLanes + j < n)) acc = own[slot] | pulled;
    if (!guard || in) tout[j * rows + i] = acc;
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
  if (pop) {
    uint32_t count = 0u;
#pragma unroll
    for (int k = 0; k < kCountBits; ++k)
      count += gossip::warp_bit_count(slice[k]) << k;
    gossip::add_rumor_counts(count, block_counts, pop, rumors);
  }
}

bool args_ok(int rows, int fanout, int rumors, unsigned int n,
             const void* sbits, const void* rbits) {
  return rows > 0 && fanout > 0 && fanout <= gossip::kOpsMaxFanout &&
         rumors > 0 && rumors <= 32 &&
         static_cast<unsigned long long>(rows) * kLanes <= 0xFFFFFFFFull &&
         n <= static_cast<unsigned int>(rows) * kLanes &&
         (sbits == nullptr) == (rbits == nullptr);
}

bool is_fast(int fanout, bool alive, bool cut, bool rbits,
             unsigned int thr) {
  return fanout == 1 && !alive && !cut && !rbits && thr == 0u;
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
  if (!args_ok(rows, fanout, rumors, n, sbits, rbits))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const PhiloxKeys keys = gossip::philox_keys(k0, k1);
  if (is_fast(fanout, alive, cut, rbits, thr)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mr_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kFastSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_mr_fast_kernel<<<(rows + kRows - 1) / kRows, kThreads,
                           kFastSmemBytes, st>>>(
        static_cast<const uint32_t*>(tin), static_cast<uint32_t*>(tout),
        static_cast<uint32_t*>(pop), static_cast<uint32_t>(rows), keys, n,
        rumors);
    return static_cast<int>(cudaGetLastError());
  }
  const gossip::OpsPlan plan = gossip::ops_plan(
      fanout, alive != nullptr, cut != nullptr, rbits != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  plan.kernel<<<(rows + plan.rows_per_block - 1) / plan.rows_per_block,
                plan.threads, plan.smem_bytes, st>>>(
      static_cast<const uint32_t*>(tin), static_cast<uint32_t*>(tout),
      static_cast<const uint32_t*>(alive), static_cast<const uint32_t*>(cut),
      static_cast<const uint32_t*>(sbits),
      static_cast<const uint32_t*>(rbits), static_cast<uint32_t*>(pop),
      static_cast<uint32_t>(rows), fanout, keys, thr, n, rumors);
  return static_cast<int>(cudaGetLastError());
}

// The kernel fused_mr_round_launch takes for these arguments (alive, cut,
// rbits: nonzero when given): `fanout_class` 0 for the fast kernel, else
// the operand path's class (1, 4, or -1 for its general instantiation),
// its dynamic shared memory and its resident blocks per SM.
extern "C" int fused_mr_round_occupancy(int fanout, int alive, int cut,
                                        int rbits, unsigned int thr,
                                        int* fanout_class, int* smem_bytes,
                                        int* blocks_per_sm) {
  if (fanout <= 0 || fanout > gossip::kOpsMaxFanout)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel;
  int threads;
  size_t smem;
  if (is_fast(fanout, alive, cut, rbits, thr)) {
    kernel = reinterpret_cast<const void*>(fused_mr_fast_kernel);
    threads = kThreads;
    smem = kFastSmemBytes;
    *fanout_class = 0;
  } else {
    const gossip::OpsPlan plan =
        gossip::ops_plan(fanout, alive, cut, rbits);
    kernel = reinterpret_cast<const void*>(plan.kernel);
    threads = plan.threads;
    smem = plan.smem_bytes;
    *fanout_class = plan.fanout_class == 0 ? -1 : plan.fanout_class;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, smem));
}
