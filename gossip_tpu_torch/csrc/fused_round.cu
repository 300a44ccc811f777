// Fused single-rumor pull round on the node-packed table, for Hopper (sm_90a).
//
// Replaces: gossip_tpu/ops/pallas_round.py::_fused_round_kernel, reached
// through _fused_call's pl.pallas_call.  It computes what the reference's
// plain twin _fused_round_ref computes: node n is bit n&31 of word n>>5 of a
// uint32[R,128] table; every destination word (i, j) pulls, for each of its
// 32*fanout/sharing draws, bit c of partner word src[(i - s_m) mod R, m],
// with src = table & alive, a drop coin, a partition side compare and the
// destination's alive bit, ORed into its bit plane; phantom bits are zeroed.
//
// What bounds it on this card: at N=10M and fanout 1 a round makes about
// 10M Philox output words (2.5M Philox4x32-10 calls of ~40 integer
// operations each) and 10M shared-memory gathers, against about 2.5 MB of
// device-memory traffic (one read and one write of the 1.25 MB table).  So
// it is bound by integer ALU work, not by bytes.
//
// What the design does about it:
//  * No rotation stages.  The TPU kernel rolls the table log2(R) times only
//    because Mosaic has no cross-row gather.  Here one block owns one
//    destination row i; thread j loads rot[j] = src[(i - s_j) mod R, j] by
//    address arithmetic into shared memory (and the cut table's rot_cut),
//    and after one __syncthreads every draw of the row gathers from those
//    128 words.  Device memory sees one read of the table per round, plus
//    the alive and cut tables when given.
//  * Random bits are computed where they are used (Philox4x32-10, four
//    draws per call), never stored.  The stream is specified in
//    gossip_tpu_torch/ops/philox.py and mirrored here word for word:
//      key (k0, k1) = (uint32(seed) * 1000003, uint32(round) ^ salt);
//      draw d of word w = i*128 + j: Philox(ctr = (w, d >> 2, 0, 0))[d & 3];
//      shift word of lane j:         Philox(ctr = (j, 0, 1, 0))[0], % R.
//    Injected bits (sbits row 0, rbits[d, i, j]) replace the stream in the
//    reference's inject layout, so the kernel is bitwise-comparable to it.
//  * The round writes a second buffer: other blocks still read rows
//    (i - s_m) of the pre-round table, so the wrapper ping-pongs two.
//  * Coverage is fused into the epilogue: __popc per word, a warp
//    reduction, one atomicAdd per block into a device counter.  Integer
//    sums, so the count does not depend on the order.
//
// C entry point: fused_round_launch, plain C interface, bound with ctypes
// by gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using gossip::philox4x32_10;

constexpr int kLanes = 128;
constexpr int kBits = 32;

// One block per table row, one thread per word of the row.
template <int SHARING>
__global__ void __launch_bounds__(kLanes)
fused_round_kernel(const uint32_t* __restrict__ tin,
                   uint32_t* __restrict__ tout,
                   const uint32_t* __restrict__ alive,
                   const uint32_t* __restrict__ cut,
                   const uint32_t* __restrict__ sbits,
                   const uint32_t* __restrict__ rbits,
                   uint32_t* __restrict__ pop, uint32_t rows, int fanout,
                   uint32_t k0, uint32_t k1, uint32_t thr,
                   uint32_t n_valid_words, uint32_t tail_mask) {
  __shared__ uint32_t rot[kLanes];
  __shared__ uint32_t rot_cut[kLanes];
  __shared__ uint32_t warp_pop[kLanes / 32];

  const uint32_t i = blockIdx.x;
  const uint32_t j = threadIdx.x;
  const uint32_t w = i * kLanes + j;

  // Stage 1: this row's 128 reachable partner words.
  const uint32_t shift_word =
      sbits ? sbits[j] : philox4x32_10(make_uint4(j, 0u, 1u, 0u), k0, k1).x;
  const uint32_t s = shift_word % rows;
  const uint32_t src = ((i + rows - s) % rows) * kLanes + j;
  rot[j] = alive ? (tin[src] & alive[src]) : tin[src];
  if (cut) rot_cut[j] = cut[src];
  __syncthreads();

  // Stage 2: every draw of this word gathers from shared memory.
  uint32_t acc = tin[w];
  const uint32_t alive_me = alive ? alive[w] : 0xFFFFFFFFu;
  const uint32_t cut_me = cut ? cut[w] : 0u;
  const int draws = fanout * kBits / SHARING;
  const size_t draw_stride = static_cast<size_t>(rows) * kLanes;
  int f = 0;
  int plane = 0;
  for (int q = 0; q < draws; q += 4) {
    uint32_t rb4[4];
    if (rbits) {
#pragma unroll
      for (int t = 0; t < 4; ++t) rb4[t] = rbits[(q + t) * draw_stride + w];
    } else {
      const uint4 r = philox4x32_10(
          make_uint4(w, static_cast<uint32_t>(q >> 2), 0u, 0u), k0, k1);
      rb4[0] = r.x;
      rb4[1] = r.y;
      rb4[2] = r.z;
      rb4[3] = r.w;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t rb = rb4[t];
      const bool keep = (rb >> 12) >= thr;
#pragma unroll
      for (int h = 0; h < SHARING; ++h) {
        const uint32_t m = (rb >> (12 * h)) & (kLanes - 1);
        const uint32_t c = (rb >> (12 * h + 7)) & (kBits - 1);
        const int p = plane + h;
        uint32_t bit = keep ? (rot[m] >> c) & 1u : 0u;
        if (cut && ((rot_cut[m] >> c) & 1u) != ((cut_me >> p) & 1u)) bit = 0u;
        bit &= (alive_me >> p) & 1u;
        acc |= bit << p;
      }
      if (++f == fanout) {
        f = 0;
        plane += SHARING;
      }
    }
  }

  // Epilogue: phantom mask, store, fused popcount.
  const uint32_t full_words = tail_mask ? n_valid_words - 1 : n_valid_words;
  uint32_t keep_mask = 0u;
  if (w < full_words) {
    keep_mask = 0xFFFFFFFFu;
  } else if (tail_mask && w == n_valid_words - 1) {
    keep_mask = tail_mask;
  }
  acc &= keep_mask;
  tout[w] = acc;
  if (pop) {
    uint32_t count = __popc(acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      count += __shfl_down_sync(0xFFFFFFFFu, count, o);
    if ((j & 31) == 0) warp_pop[j >> 5] = count;
    __syncthreads();
    if (j == 0)
      atomicAdd(pop, warp_pop[0] + warp_pop[1] + warp_pop[2] + warp_pop[3]);
  }
}

}  // namespace

// tin, tout, alive, cut: uint32[rows, 128] (alive, cut may be null);
// sbits: uint32[8, 128] and rbits: uint32[32*fanout/sharing, rows, 128],
// both null or both given; pop: uint32[1] or null.  Launches on `stream`.
extern "C" int fused_round_launch(const void* tin, void* tout,
                                  const void* alive, const void* cut,
                                  const void* sbits, const void* rbits,
                                  void* pop, int rows, int fanout,
                                  int sharing, unsigned int k0,
                                  unsigned int k1, unsigned int thr,
                                  unsigned int n_valid_words,
                                  unsigned int tail_mask, void* stream) {
  if (rows <= 0 || fanout <= 0 || (sharing != 1 && sharing != 2) ||
      (fanout * kBits / sharing) % 4 != 0 ||
      n_valid_words > static_cast<unsigned int>(rows) * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows);
  const dim3 block(kLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a_tin = static_cast<const uint32_t*>(tin);
  auto* a_tout = static_cast<uint32_t*>(tout);
  const auto* a_alive = static_cast<const uint32_t*>(alive);
  const auto* a_cut = static_cast<const uint32_t*>(cut);
  const auto* a_sbits = static_cast<const uint32_t*>(sbits);
  const auto* a_rbits = static_cast<const uint32_t*>(rbits);
  auto* a_pop = static_cast<uint32_t*>(pop);
  const uint32_t u_rows = static_cast<uint32_t>(rows);
  if (sharing == 1) {
    fused_round_kernel<1><<<grid, block, 0, st>>>(
        a_tin, a_tout, a_alive, a_cut, a_sbits, a_rbits, a_pop, u_rows,
        fanout, k0, k1, thr, n_valid_words, tail_mask);
  } else {
    fused_round_kernel<2><<<grid, block, 0, st>>>(
        a_tin, a_tout, a_alive, a_cut, a_sbits, a_rbits, a_pop, u_rows,
        fanout, k0, k1, thr, n_valid_words, tail_mask);
  }
  return static_cast<int>(cudaGetLastError());
}
