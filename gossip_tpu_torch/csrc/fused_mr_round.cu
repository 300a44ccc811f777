// Fused multi-rumor pull round on the one-word-per-node table, for Hopper
// (sm_90a): the value route, one launch per round.
//
// Replaces: gossip_tpu/ops/pallas_round.py::_fused_mr_kernel, reached through
// _fused_mr_round_jit and _fused_call's pl.pallas_call.  It computes what the
// reference's plain twin _fused_mr_round_ref computes: node i*128 + j holds
// its up-to-32-rumor word at (row i, lane j) of a uint32[R,128] table; for
// every fanout draw f, every node pulls the whole word of partner
// src[(i - s_m) mod R, m], m = rb & 127, from the pre-round src = table &
// alive, drops it when rb >> 12 < thr, keeps it only when the partner's cut
// word equals its own, ANDs it with its own alive word and ORs it in; words
// of node ids >= n are zeroed.
//
// What bounds it on this card: at N = 10M x 32 rumors, fanout 1, a round
// reads and writes the 40 MB table once (80 MB, 0.024 ms at 3.35 TB/s) and
// makes 10M Philox4x32-10 calls, 10M pulls and 10M words of per-rumor
// counting: about 0.043 ms of int32 issue, the larger of the two.  The
// kernel runs at about 2.9x that (PERF.md).  Each partner read is 4 useful
// bytes of a 32-byte sector in a random row, one L2 request per word.
//
// What the design does about it:
//  * No rotation.  The TPU kernel rolls the table log2(R) times only because
//    Mosaic has no cross-row gather.  Here thread (i, j) reads its partner
//    word by address arithmetic, src[(i - s_m) mod R, m]: only the lanes
//    that are drawn are read.
//  * The per-lane shifts of every fanout draw are computed once per block
//    (one Philox call per lane and draw) into shared memory; a block covers
//    kRowsPerBlock rows, so that costs 1/kRowsPerBlock of a call per word.
//  * Random bits are computed where they are used, never stored; the stream
//    (gossip_tpu_torch/ops/philox.py, multi-rumor section) is
//      key (k0, k1) = (uint32(seed) * 1000003, uint32(round) ^ 0x5D0);
//      shift word of lane j, draw f: Philox(ctr = (j, f, 1, 0))[0] % R;
//      draw f of word w:             Philox(ctr = (w, f >> 2, 0, 0))[f & 3].
//    Injected bits (sbits[f, 0, j], rbits[f, i, j]) replace the stream in
//    the reference's inject layout.
//  * The round writes a second buffer: other blocks still read rows
//    (i - s_m) of the pre-round table, so the run loop ping-pongs two.
//  * The per-rumor counts the loop's stop test reads are fused into the
//    epilogue (rumor_counts.cuh): a warp bit transpose, one __popc per lane,
//    one atomicAdd per block and rumor.
//
// C entry point: fused_mr_round_launch, plain C interface, bound with ctypes
// by gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "rumor_counts.cuh"

namespace {

using gossip::philox4x32_10;
using gossip::philox_word;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxFanout = 64;   // shifts: fanout * 512 B of shared memory

__global__ void __launch_bounds__(kThreads)
fused_mr_round_kernel(const uint32_t* __restrict__ tin,
                      uint32_t* __restrict__ tout,
                      const uint32_t* __restrict__ alive,
                      const uint32_t* __restrict__ cut,
                      const uint32_t* __restrict__ sbits,
                      const uint32_t* __restrict__ rbits,
                      uint32_t* __restrict__ pop, uint32_t rows, int fanout,
                      uint32_t k0, uint32_t k1, uint32_t thr, uint32_t n,
                      int rumors) {
  extern __shared__ uint32_t shift[];   // [fanout][128]
  __shared__ uint32_t block_counts[32];

  // The per-lane row shift of every fanout draw.
  for (int t = threadIdx.x; t < fanout * kLanes; t += kThreads) {
    const uint32_t f = t / kLanes;
    const uint32_t j = t % kLanes;
    const uint32_t word =
        sbits ? sbits[f * 8 * kLanes + j]
              : philox4x32_10(make_uint4(j, f, 1u, 0u), k0, k1).x;
    shift[t] = word % rows;
  }
  if (threadIdx.x < 32) block_counts[threadIdx.x] = 0u;
  __syncthreads();

  const uint32_t words = rows * kLanes;
  const uint32_t first = blockIdx.x * kRowsPerBlock * kLanes;
  const uint32_t last = min(first + kRowsPerBlock * kLanes, words);
  uint32_t count = 0u;
  // last - first is a multiple of 128, so every warp runs whole iterations.
  for (uint32_t w = first + threadIdx.x; w < last; w += kThreads) {
    const uint32_t i = w / kLanes;
    const uint32_t alive_me = alive ? alive[w] : 0xFFFFFFFFu;
    const uint32_t cut_me = cut ? cut[w] : 0u;
    uint32_t acc = tin[w];
    for (int q = 0; q < fanout; q += 4) {
      uint4 r4 = make_uint4(0u, 0u, 0u, 0u);
      if (!rbits)
        r4 = philox4x32_10(make_uint4(w, static_cast<uint32_t>(q >> 2), 0u,
                                      0u),
                           k0, k1);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int f = q + t;
        if (f >= fanout) break;
        const uint32_t rb = rbits ? rbits[static_cast<size_t>(f) * words + w]
                                  : philox_word(r4, t);
        const uint32_t m = rb & (kLanes - 1);
        const uint32_t s = shift[f * kLanes + m];
        const uint32_t prow = i >= s ? i - s : i + rows - s;
        const uint32_t p = prow * kLanes + m;
        uint32_t partner = __ldg(tin + p);
        if (alive) partner &= __ldg(alive + p);
        if ((rb >> 12) < thr) partner = 0u;
        if (cut && __ldg(cut + p) != cut_me) partner = 0u;
        acc |= partner & alive_me;
      }
    }
    if (w >= n) acc = 0u;
    tout[w] = acc;
    if (pop) count += gossip::warp_bit_count(acc);
  }
  if (pop) gossip::add_rumor_counts(count, block_counts, pop, rumors);
}

}  // namespace

// tin, tout, alive, cut: uint32[rows, 128] (alive, cut may be null; tout is
// not tin); sbits: uint32[fanout, 8, 128] and rbits: uint32[fanout, rows,
// 128], both null or both given; pop: uint32[32] or null, gets the count of
// each of the first `rumors` bits of the new table added.  Launches on
// `stream`.
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
      n > static_cast<unsigned int>(rows) * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t shift_bytes = static_cast<size_t>(fanout) * kLanes * 4;
  fused_mr_round_kernel<<<grid, kThreads, shift_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tin), static_cast<uint32_t*>(tout),
      static_cast<const uint32_t*>(alive), static_cast<const uint32_t*>(cut),
      static_cast<const uint32_t*>(sbits),
      static_cast<const uint32_t*>(rbits), static_cast<uint32_t*>(pop),
      static_cast<uint32_t>(rows), fanout, k0, k1, thr, n, rumors);
  return static_cast<int>(cudaGetLastError());
}
