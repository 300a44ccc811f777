// One pass of the staged multi-rumor pull round, for Hopper (sm_90a).
//
// Replaces: gossip_tpu/ops/pallas_round.py::_mr_gather_kernel, the grid
// kernel of _fused_mr_round_big (its pl.pallas_call).  The staged route
// splits a round on the reference's seam: the rotation
// rot[i, j] = src[(i - s_j) mod R, j] of the pre-round src = table & alive is
// plain torch (gossip_tpu_torch/ops/fused_mr_round.rotate_rows, as the
// reference does it in XLA), and this kernel does the rest of one fanout
// draw f: every node (i, j) takes the in-row partner word rot[i, m],
// m = rb & 127, drops it when rb >> 12 < thr, keeps it only when the
// partner's rotated cut word rot_cut[i, m] equals its own, ANDs it with its
// own alive word and writes tin | partner; words of node ids >= n are zeroed.
//
// What bounds it on this card: per pass at N = 10M x 32 rumors it reads tin
// and rot and writes the output, 120 MB, 0.036 ms at 3.35 TB/s, and makes
// 10M Philox calls and pulls; with the per-rumor counts of the last pass
// the operations (0.041 ms) are the larger.  The in-row gather is cheap:
// all 128 words of row i are in the same 512 bytes.
//
// What the design does about it:
//  * One thread per word, coalesced loads of tin, rot (the drawn lane of the
//    row's own 512 bytes) and the masks.  The reference's 1024-row blocks are
//    a VMEM artefact and are not carried over.
//  * It reads only its own word of tin, so passes f >= 1 run in place on the
//    accumulator (tout may be tin).
//  * Random bits as in fused_mr_round.cu: draw f of word w is
//    Philox(ctr = (w, f >> 2, 0, 0))[f & 3] under the multi-rumor key, or
//    the injected rbits[i, j] of this draw.
//  * The per-rumor counts (rumor_counts.cuh) are added on the last pass only,
//    when the caller passes the counter.
//
// C entry point: mr_gather_launch, plain C interface, bound with ctypes by
// gossip_tpu_torch/ops/_kernels.py; returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"
#include "rumor_counts.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;

// tin and tout may be the same buffer: no __restrict__ on either.
__global__ void __launch_bounds__(kThreads)
mr_gather_kernel(const uint32_t* tin, const uint32_t* __restrict__ rot,
                 uint32_t* tout, const uint32_t* __restrict__ alive,
                 const uint32_t* __restrict__ rot_cut,
                 const uint32_t* __restrict__ cut,
                 const uint32_t* __restrict__ rbits,
                 uint32_t* __restrict__ pop, uint32_t rows, int f,
                 const gossip::PhiloxKeys keys, uint32_t thr, uint32_t n,
                 int rumors) {
  __shared__ uint32_t block_counts[32];
  if (threadIdx.x < 32) block_counts[threadIdx.x] = 0u;
  __syncthreads();

  const uint32_t words = rows * kLanes;
  const uint32_t first = blockIdx.x * kRowsPerBlock * kLanes;
  const uint32_t last = min(first + kRowsPerBlock * kLanes, words);
  uint32_t count = 0u;
  // last - first is a multiple of 128, so every warp runs whole iterations.
  for (uint32_t w = first + threadIdx.x; w < last; w += kThreads) {
    const uint32_t rb =
        rbits ? rbits[w]
              : gossip::philox_word(
                    gossip::philox4x32_10(
                        make_uint4(w, static_cast<uint32_t>(f >> 2), 0u, 0u),
                        keys),
                    f & 3);
    const uint32_t p = (w & ~static_cast<uint32_t>(kLanes - 1)) |
                       (rb & (kLanes - 1));
    uint32_t partner = rot[p];
    if ((rb >> 12) < thr) partner = 0u;
    if (cut && rot_cut[p] != cut[w]) partner = 0u;
    if (alive) partner &= alive[w];
    const uint32_t acc = w < n ? (tin[w] | partner) : 0u;
    tout[w] = acc;
    if (pop) count += gossip::warp_bit_count(acc);
  }
  if (pop) gossip::add_rumor_counts(count, block_counts, pop, rumors);
}

}  // namespace

// tin, rot, tout, alive, rot_cut, cut: uint32[rows, 128] (alive may be null;
// rot_cut and cut both null or both given; tout may be tin, rot is neither);
// rbits: uint32[rows, 128], this draw's injected bits, or null for the
// stream; pop: uint32[32] or null, gets the count of each of the first
// `rumors` bits of the output added.  Launches on `stream`.
extern "C" int mr_gather_launch(const void* tin, const void* rot, void* tout,
                                const void* alive, const void* rot_cut,
                                const void* cut, const void* rbits, void* pop,
                                int rows, int f, unsigned int k0,
                                unsigned int k1, unsigned int thr,
                                unsigned int n, int rumors, void* stream) {
  if (rows <= 0 || f < 0 || rumors <= 0 || rumors > 32 ||
      (rot_cut == nullptr) != (cut == nullptr) ||
      static_cast<unsigned long long>(rows) * kLanes > 0xFFFFFFFFull ||
      n > static_cast<unsigned int>(rows) * kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  mr_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tin), static_cast<const uint32_t*>(rot),
      static_cast<uint32_t*>(tout), static_cast<const uint32_t*>(alive),
      static_cast<const uint32_t*>(rot_cut), static_cast<const uint32_t*>(cut),
      static_cast<const uint32_t*>(rbits), static_cast<uint32_t*>(pop),
      static_cast<uint32_t>(rows), f, gossip::philox_keys(k0, k1), thr, n,
      rumors);
  return static_cast<int>(cudaGetLastError());
}
