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
// What bounds it on this card: ALU issue.  At N = 10M and fanout 1 a round
// makes 8 Philox4x32-10 calls a word (10M output words) and 10M pulls, some
// 270 ALU-pipe and 123 FMA-pipe instructions a word by the function's count
// (tools/roofline.round_work), against 2.5 MB of device-memory traffic (one
// read and one write of the 1.25 MB table, which stays in L2).
//
// What the design does about it:
//  * No rotation stages.  The TPU kernel rolls the table log2(R) times only
//    because Mosaic has no cross-row gather.  Here thread j of a block
//    loads rot[j] = src[(i - s_j) mod R, j] for destination row i by
//    address arithmetic into shared memory (and the cut table's rot_cut),
//    and every draw of the row gathers from those 128 words.
//  * Few instructions a draw.  The bit c of rot[m] that a draw pulls is
//    moved to its plane p by one funnel-shift rotate by (c - p) & 31 (the
//    rotate takes its amount mod 32, so (rb >> 7) - p serves) and ORed in
//    under the mask 1 << p: a lane mask, the amount, the LDS, the rotate
//    and one LOP3 a draw.  The cut compare rotates the cut word by the same
//    amount and folds into one LOP3.  The destination's alive word gates
//    plane p by its bit p only, so it is applied once a word
//    (acc = own | pulled & alive), not once a draw.
//  * Specialised at compile time: the main path's fanout 1, plane sharing
//    1 (the 32 draws a straight line, each plane a constant) with each of
//    the eight combinations of drop threshold, alive table and cut table
//    (fused_round_kernel<1, 1, DROP, ALIVE, CUT>); a generic instantiation
//    per plane sharing (fused_round_kernel<0, SHARING, ...>) takes any
//    fanout, the operands at run time, and injected bits.  The launcher
//    picks from its arguments.
//  * A block walks several rows.  The 128 shift words are drawn once per
//    block; the grid is sized to the card (the blocks that fit at once,
//    asked of the runtime once per device and instantiation, rows spread
//    evenly over them), so no second, sparse wave runs; the
//    next row's 128 partner words are loaded before the current row's draws
//    and stored to the other half of a double-buffered rot after them, so
//    that dependent load overlaps the work.
//  * Random bits are computed where they are used (Philox4x32-10, four
//    draws per call, its ten round keys computed once a launch on the
//    host and read from the constant bank: philox.cuh), never stored.
//    The stream is specified in
//    gossip_tpu_torch/ops/philox.py and mirrored here word for word:
//      key (k0, k1) = (uint32(seed) * 1000003, uint32(round) ^ salt);
//      draw d of word w = i*128 + j: Philox(ctr = (w, d >> 2, 0, 0))[d & 3];
//      shift word of lane j:         Philox(ctr = (j, 0, 1, 0))[0], % R.
//    Injected bits (sbits row 0, rbits[d, i, j]) replace the stream in the
//    reference's inject layout, so the kernel is bitwise-comparable to it.
//  * The round writes a second buffer: other blocks still read rows
//    (i - s_m) of the pre-round table, so the wrapper ping-pongs two.
//  * Coverage is fused into the epilogue: __popc per word, summed over the
//    block's rows in a register, a warp reduction, one atomicAdd per block
//    into a device counter.  Integer sums, so the order does not matter.
//
// Changed from the first port (one block of 128 threads per row): that
// design ran at 2.6x the Philox microkernel on the same grid.  It spent
// about 15 instructions a draw (bit extraction, the alive bit and the
// fanout bookkeeping inside the loop), drew the 128 shift words again in
// every one of its 2448 blocks, ran a second wave at a sixth of the card,
// and stalled every block on its partner load before the first draw.
//
// C entry point: fused_round_launch, plain C interface, bound with ctypes
// by gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <array>
#include <cstddef>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using gossip::PhiloxKeys;
using gossip::philox4x32_10;
using gossip::philox_word;

constexpr int kLanes = 128;
constexpr int kBits = 32;
constexpr int kMaxDevices = 64;    // devices whose grid size is cached

struct Args {
  const uint32_t* tin;
  uint32_t* tout;
  const uint32_t* alive;
  const uint32_t* cut;
  const uint32_t* sbits;
  const uint32_t* rbits;
  uint32_t* pop;
  uint32_t rows;
  int fanout;
  PhiloxKeys keys;
  uint32_t thr, n_valid_words, tail_mask;
};

// Draw word rb's pull of field h into plane p: bit c of rot[m], moved to
// bit p, cut-compared against the destination's side bit p, coin-tested.
__device__ __forceinline__ uint32_t pull(uint32_t rb, int h, int p,
                                         const uint32_t* rot,
                                         const uint32_t* rot_cut,
                                         uint32_t cut_me, bool has_cut,
                                         bool has_drop, uint32_t thr) {
  const uint32_t field = rb >> (12 * h);
  const uint32_t m = field & (kLanes - 1);
  const uint32_t amount = (field >> 7) - static_cast<uint32_t>(p);
  uint32_t v = __funnelshift_r(rot[m], rot[m], amount);
  if (has_cut)
    v &= ~(__funnelshift_r(rot_cut[m], rot_cut[m], amount) ^ cut_me);
  if (has_drop && (rb >> 12) < thr) v = 0u;
  return v & (1u << p);
}

// FANOUT == 1 (with SHARING == 1): the straight-line main path, operands
// fixed by DROP, ALIVE, CUT, the Philox stream.  FANOUT == 0: generic, any
// fanout, operands and injected bits read from the arguments.
template <int FANOUT, int SHARING, bool DROP, bool ALIVE, bool CUT>
__global__ void __launch_bounds__(kLanes) fused_round_kernel(Args a) {
  constexpr bool kFast = FANOUT == 1;
  static_assert(!kFast || SHARING == 1, "the fast path has sharing 1");
  const bool has_alive = kFast ? ALIVE : a.alive != nullptr;
  const bool has_cut = kFast ? CUT : a.cut != nullptr;
  const bool has_drop = kFast ? DROP : a.thr != 0u;
  const uint32_t* rbits = kFast ? nullptr : a.rbits;

  __shared__ uint32_t rot[2][kLanes];
  __shared__ uint32_t rot_cut[2][kLanes];
  __shared__ uint32_t warp_pop[kLanes / 32];

  const uint32_t rows = a.rows;
  const uint32_t j = threadIdx.x;
  const uint32_t shift_word =
      (!kFast && a.sbits)
          ? a.sbits[j]
          : philox4x32_10(make_uint4(j, 0u, 1u, 0u), a.keys).x;
  const uint32_t s = shift_word % rows;

  // this lane's partner word for destination row i: src[(i - s) mod R, j]
  uint32_t nxt = 0u, nxt_cut = 0u;
  auto load_partner = [&](uint32_t i) {
    const uint32_t src = (i >= s ? i - s : i + rows - s) * kLanes + j;
    nxt = a.tin[src];
    if (has_alive) nxt &= a.alive[src];
    if (has_cut) nxt_cut = a.cut[src];
  };

  const uint32_t full_words =
      a.tail_mask ? a.n_valid_words - 1 : a.n_valid_words;
  uint32_t count = 0u;
  uint32_t i = blockIdx.x;
  if (i < rows) load_partner(i);
  // every thread of a block runs the same rows, so the barrier is uniform
  for (int buf = 0; i < rows; i += gridDim.x, buf ^= 1) {
    rot[buf][j] = nxt;
    if (has_cut) rot_cut[buf][j] = nxt_cut;
    __syncthreads();
    if (i + gridDim.x < rows) load_partner(i + gridDim.x);

    const uint32_t w = i * kLanes + j;
    const uint32_t own = a.tin[w];
    const uint32_t cut_me = has_cut ? a.cut[w] : 0u;
    uint32_t pulled = 0u;
    if (kFast) {
#pragma unroll
      for (int q = 0; q < kBits / 4; ++q) {
        const uint4 r4 = philox4x32_10(
            make_uint4(w, static_cast<uint32_t>(q), 0u, 0u), a.keys);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          pulled |= pull(philox_word(r4, t), 0, 4 * q + t, rot[buf],
                         rot_cut[buf], cut_me, has_cut, has_drop, a.thr);
      }
    } else {
      const int draws = a.fanout * kBits / SHARING;
      const size_t draw_stride = static_cast<size_t>(rows) * kLanes;
      int f = 0;
      int plane = 0;
      for (int q = 0; q < draws; q += 4) {
        uint4 r4;
        if (rbits) {
          r4 = make_uint4(rbits[(q + 0) * draw_stride + w],
                          rbits[(q + 1) * draw_stride + w],
                          rbits[(q + 2) * draw_stride + w],
                          rbits[(q + 3) * draw_stride + w]);
        } else {
          r4 = philox4x32_10(
              make_uint4(w, static_cast<uint32_t>(q >> 2), 0u, 0u), a.keys);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t rb = philox_word(r4, t);
#pragma unroll
          for (int h = 0; h < SHARING; ++h)
            pulled |= pull(rb, h, plane + h, rot[buf], rot_cut[buf], cut_me,
                           has_cut, has_drop, a.thr);
          if (++f == a.fanout) {
            f = 0;
            plane += SHARING;
          }
        }
      }
    }

    // Epilogue: alive gate, phantom mask, store, popcount.
    uint32_t acc = own | (has_alive ? pulled & a.alive[w] : pulled);
    if (w >= full_words)
      acc &= (a.tail_mask && w == a.n_valid_words - 1) ? a.tail_mask : 0u;
    a.tout[w] = acc;
    count += __popc(acc);
  }

  if (a.pop) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      count += __shfl_down_sync(0xFFFFFFFFu, count, o);
    if ((j & 31) == 0) warp_pop[j >> 5] = count;
    __syncthreads();
    const uint32_t total =
        warp_pop[0] + warp_pop[1] + warp_pop[2] + warp_pop[3];
    if (j == 0 && total) atomicAdd(a.pop, total);
  }
}

// The grid: as many blocks as fit on the card at once, rows spread evenly
// over them (every block walks the same number of rows, give or take one).
using KernelFn = void (*)(Args);

// How many blocks of `kernel` fit on `device` at once: asked of the
// runtime at the first launch on the device and kept (one table per
// instantiation); a failed query returns its error and keeps nothing, so
// a launch runs at the full grid or fails.
template <KernelFn kernel>
cudaError_t blocks_at_once(int device, unsigned int* slots) {
  static unsigned int cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device]) {
    *slots = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kLanes, 0);
  if (err != cudaSuccess) return err;
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  *slots = static_cast<unsigned int>(sms * per_sm);
  if (device >= 0 && device < kMaxDevices) cached[device] = *slots;
  return cudaSuccess;
}

template <KernelFn kernel>
int launch(const Args& a, int device, cudaStream_t stream) {
  unsigned int slots = 0;
  const cudaError_t err = blocks_at_once<kernel>(device, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int per_block = (a.rows + slots - 1) / slots;
  const dim3 grid((a.rows + per_block - 1) / per_block);
  kernel<<<grid, kLanes, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&, int, cudaStream_t);

// fast-path launcher for operand set OPS: bit 0 drop, 1 alive, 2 cut
template <int OPS>
int launch_fast(const Args& a, int device, cudaStream_t stream) {
  return launch<fused_round_kernel<1, 1, (OPS & 1) != 0, (OPS & 2) != 0,
                                    (OPS & 4) != 0>>(a, device, stream);
}

template <int... OPS>
constexpr std::array<Launcher, sizeof...(OPS)> fast_launchers(
    std::integer_sequence<int, OPS...>) {
  return {launch_fast<OPS>...};
}

constexpr auto kFastLaunchers =
    fast_launchers(std::make_integer_sequence<int, 8>{});

}  // namespace

// tin, tout, alive, cut: uint32[rows, 128] (alive, cut may be null);
// sbits: uint32[8, 128] and rbits: uint32[32*fanout/sharing, rows, 128],
// both null or both given; pop: uint32[1] or null.  Launches on `stream`
// of `device`, the current device (the caller passes it, so a launch
// asks the runtime nothing but the launch itself once the grid is known).
extern "C" int fused_round_launch(const void* tin, void* tout,
                                  const void* alive, const void* cut,
                                  const void* sbits, const void* rbits,
                                  void* pop, int rows, int fanout,
                                  int sharing, unsigned int k0,
                                  unsigned int k1, unsigned int thr,
                                  unsigned int n_valid_words,
                                  unsigned int tail_mask, int device,
                                  void* stream) {
  if (rows <= 0 || fanout <= 0 || (sharing != 1 && sharing != 2) ||
      (fanout * kBits / sharing) % 4 != 0 ||
      static_cast<unsigned long long>(rows) * kLanes > 0xFFFFFFFFull ||
      n_valid_words > static_cast<unsigned int>(rows) * kLanes ||
      (sbits == nullptr) != (rbits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(tin),
               static_cast<uint32_t*>(tout),
               static_cast<const uint32_t*>(alive),
               static_cast<const uint32_t*>(cut),
               static_cast<const uint32_t*>(sbits),
               static_cast<const uint32_t*>(rbits),
               static_cast<uint32_t*>(pop),
               static_cast<uint32_t>(rows),
               fanout,
               gossip::philox_keys(k0, k1),
               thr,
               n_valid_words,
               tail_mask};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fanout == 1 && sharing == 1 && rbits == nullptr)
    return kFastLaunchers[(thr != 0u ? 1 : 0) | (alive ? 2 : 0) |
                          (cut ? 4 : 0)](a, device, st);
  if (sharing == 1)
    return launch<fused_round_kernel<0, 1, false, false, false>>(a, device,
                                                                 st);
  return launch<fused_round_kernel<0, 2, false, false, false>>(a, device, st);
}
