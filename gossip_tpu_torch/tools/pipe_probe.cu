// Issue rates of the integer pipes on Hopper (sm_90a), and the gap between
// chained launches.
//
// Built and run by gossip_tpu_torch/tools/pipe_probe.py (which documents
// what it prints); not part of the port's kernels.  Two groups:
//  * pipe_kernel<A, B, NA>: every thread runs eight independent dependent
//    chains, NA of them of instruction A and the rest of B, as inline PTX,
//    one full wave of blocks; thread 0 of each block records its start and
//    end clock64, its SM and its globaltimer span, so that a rate is taken
//    over each SM's whole span (its first block's start to its last
//    block's end).  Each chain step is one instruction: mul.wide.u32 of
//    the two halves of the last product (IMAD.WIDE.U32 with no addend, as
//    Philox's products), mul.hi.u32 (IMAD.HI.U32), mul.lo.u32 (IMAD) or
//    lop3.b32 (LOP3.LUT), so that the loop holds the named instructions,
//    its counter and the register moves the compiler adds; the Python
//    driver checks that in the SASS.
//  * nop_kernel: an empty grid, chained plainly or with programmatic
//    dependent launch (PDL), for the gap between chained launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;
constexpr int kThreads = 256;

enum Op { kWide = 0, kHi = 1, kLo = 2, kLop3 = 3 };

// One step of a chain: x is the 32-bit chains' value, p the wide one's.
template <int OP>
__device__ __forceinline__ void pipe_op(uint32_t& x, uint64_t& p, uint32_t m,
                                        uint32_t k) {
  if (OP == kWide) {
    // both halves feed the next product, so neither is dead
    asm("{.reg .u32 a, b;\n\tmov.b64 {a, b}, %0;\n\t"
        "mul.wide.u32 %0, a, b;}"
        : "+l"(p));
  } else if (OP == kHi) {
    asm("mul.hi.u32 %0, %0, %1;" : "+r"(x) : "r"(m));
  } else if (OP == kLo) {
    asm("mul.lo.u32 %0, %0, %1;" : "+r"(x) : "r"(m));
  } else {
    asm("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x) : "r"(m), "r"(k));
  }
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int A, int B, int NA>
__global__ void __launch_bounds__(kThreads)
pipe_kernel(uint32_t* out, uint32_t m, uint32_t k, int iters,
            long long* span) {
  uint32_t x[kChains];
  uint64_t p[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    x[c] = threadIdx.x * 7u + c;
    p[c] = (x[c] | 1u) | (static_cast<uint64_t>(blockIdx.x * 2u + 1u) << 32);
  }
  __syncthreads();
  const long long c0 = clock64();
  const uint64_t g0 = global_ns();
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        if (c < NA) {
          pipe_op<A>(x[c], p[c], m, k);
        } else {
          pipe_op<B>(x[c], p[c], m, k);
        }
      }
    }
  }
  __syncthreads();
  const long long c1 = clock64();
  const uint64_t g1 = global_ns();
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    acc ^= x[c] ^ static_cast<uint32_t>(p[c]) ^
           static_cast<uint32_t>(p[c] >> 32);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    span[4 * blockIdx.x] = c0;
    span[4 * blockIdx.x + 1] = c1;
    span[4 * blockIdx.x + 2] = sm;
    span[4 * blockIdx.x + 3] = static_cast<long long>(g1 - g0);
  }
}

template <bool PDL>
__global__ void nop_kernel(uint32_t* t, int write) {
  if (PDL) {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    asm volatile("griddepcontrol.wait;" ::: "memory");
  }
  if (write) t[threadIdx.x] = 0;  // never asked: keeps the argument
}

using PipeFn = void (*)(uint32_t*, uint32_t, uint32_t, int, long long*);
// all of one op, then half and half of two
struct Pipe {
  const char* name;
  PipeFn fn;
};
const Pipe kPipes[] = {
    {"wide", pipe_kernel<kWide, kWide, 8>},
    {"hi", pipe_kernel<kHi, kHi, 8>},
    {"lo", pipe_kernel<kLo, kLo, 8>},
    {"lop3", pipe_kernel<kLop3, kLop3, 8>},
    {"wide+lop3", pipe_kernel<kWide, kLop3, 4>},
    {"wide+hi", pipe_kernel<kWide, kHi, 4>},
    {"wide+lo", pipe_kernel<kWide, kLo, 4>},
    {"hi+lo", pipe_kernel<kHi, kLo, 4>},
    {"hi+lop3", pipe_kernel<kHi, kLop3, 4>},
    {"lo+lop3", pipe_kernel<kLo, kLop3, 4>}};

}  // namespace

extern "C" int probe_pipe_count() {
  return static_cast<int>(sizeof(kPipes) / sizeof(kPipes[0]));
}

extern "C" const char* probe_pipe_name(int which) {
  return kPipes[which].name;
}

// One full wave of 256-thread blocks of pipe kernel `which`; span:
// int64[4 * blocks] (start and end clock64, SM, ns per block);
// *blocks_out: the grid.  With out null, only the grid.
extern "C" int probe_pipe_launch(int which, void* out, unsigned int m,
                                 unsigned int k, int iters, void* span,
                                 int* blocks_out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kPipes[which].fn, kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks_out = sms * per_sm;
  if (out == nullptr) return 0;
  kPipes[which].fn<<<sms * per_sm, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), m, k, iters,
      static_cast<long long*>(span));
  return static_cast<int>(cudaGetLastError());
}

// One empty grid of blocks x threads on `stream`, with programmatic stream
// serialization when pdl is set.
extern "C" int probe_nop_launch(void* t, int blocks, int threads, int pdl,
                                void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e =
      pdl ? cudaLaunchKernelEx(&cfg, nop_kernel<true>,
                               static_cast<uint32_t*>(t), 0)
          : cudaLaunchKernelEx(&cfg, nop_kernel<false>,
                               static_cast<uint32_t*>(t), 0);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
