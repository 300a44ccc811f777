"""Roofline of the port's round kernels: floors from counted work and rates
calibrated on the card, against the rounds' measured times.

    python -m gossip_tpu_torch.tools.roofline [--n N] [--rumors R]
        [--iters I] [--smoke] [--device cpu] [--out PATH]

The counterpart of the JAX package's ``tools/roofline.py``, with its
names.  It counts each fused layout's work per round
(:func:`single_rumor_counts`, :func:`mr_staged_counts`), calibrates the
primitive rates on the card with the three microkernels of
``csrc/calibrate.cu`` at the single-rumor kernel's shape
(:func:`calibrate`) and a streamed-memory rate (:func:`hbm_rate`), times
the real rounds (:func:`measure_single`, :func:`measure_mr_staged`,
:func:`measure_mr_value`), and prints a one-line summary; ``--out``
writes the whole document (floors, utilizations, provenance).  Floors
come two ways, as in the reference: ``serial`` (the components' sum,
exact if the units never overlap) and ``overlap`` (their largest, exact
if they overlap perfectly).  An unresolved gather rate adds 0 to a floor,
which stays a lower bound.

It also holds the port's **datasheet bound model** (``round_bound``,
``mr_round_bound``, ``mr_gather_bound``, ``sampler_bound`` and the
microkernels' ``cal_bound``, counted from their function by pipe), which
``chip_smoke.py`` prints beside every kernel's time, and the round
kernels' counts priced at the calibrated rates (:func:`kernel_floors`),
one floor per ported round kernel.

``--smoke`` rehearses the plumbing at the reference's tiny shapes
(n = 4096 * 8, 8 rumors, 2 iterations) on the device given: its numbers
are not statistics.  Without ``--device cpu`` it runs on the card and
refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.ops import calibrate as CAL
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.utils.provenance import provenance
from gossip_tpu_torch.utils.timing import timed_chain

LANES = 128
BITS = 32
RUMORS = 32               # the multi-rumor kernels' int32[32] counters
CHAIN_REPEATS = 3         # timed chains per measurement (median)

# ------------------------------------------------ datasheet bound model
#
# Least time for one launch (the bound): the larger of bytes over the
# memory rate and integer operations over the integer rate.  H100 SXM:
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores counts an FMA as
# two operations, so 33.5e12 float32 instructions/s, and Hopper issues
# 64 int32 operations per SM per clock against 128 float32 (CUDA
# C++ documentation, arithmetic instruction throughput, compute
# capability 9.0): 67e12 / 4 int32 operations/s.  Operations are counted
# as the fewest 32-bit instructions that compute the function: a 32 x 32
# -> 64-bit product is one wide multiply-add, a three-input xor one
# logic op, and the key schedule is the same in every thread (uniform
# registers), so it is not counted.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
PHILOX_OPS = 40           # 10 rounds of 2 wide products and 2 xor3
# per word: phantom mask 2, popcount 1
WORD_OPS = 3
# per word: phantom mask 2; per-rumor counts: 5 transpose stages of a
# shuffle, a funnel shift, a select and a three-input logic op, then one
# popcount and one add
MR_WORD_OPS = 2 + 5 * 4 + 2
# staged pull: lane 1, address 1, coin 2, masked OR-in 1
MR_GATHER_PULL_OPS = 5
# sampler, per draw: a 32-bit remainder by a runtime divisor 20, the
# self-exclusion compare and add 2, the row step 2, the store 1 (the
# Philox call, a quarter per draw, is counted apart)
SAMPLER_DRAW_OPS = 25


def philox_pipe_ops(calls: int):
    """(wide products, three-input xors) that ``calls`` Philox calls with
    counters (w, q, 0, 0), q < ``calls``, take in one thread, w the
    thread's word and q the same in every thread: round 1's product of w
    and its xor with the key serve every call, its product of 0 is 0,
    round 2's product of q is one per warp (uniform datapath), and round
    3's product of round 2's first word is shared again; each call adds
    15 products and 17 xors.  A call with counter (j, f, 1, 0), j the
    thread's lane, takes what one such call takes (the product of the
    constant 1 is uniform)."""
    return 3 + 15 * calls, 2 + 17 * calls


# Microkernels, per word, counted from the function and by the pipe that
# issues each operation: wide products on the FMA pipe, logic ops on the
# ALU pipe, each pipe at 67e12 / 4 a second, side by side.  A word's 8
# Philox calls share counters but q (philox_pipe_ops): 3 + 8 * 15 wide
# products and 2 + 8 * 17 three-input xors, not 8 * 40 operations.  prng
# then ORs 32 draws and the table word with 16 three-input ORs;
# prng_gather masks each draw's lane (32) and ORs the 32 reads and the
# word (16); its shared-memory address is not counted, since the mask or
# the load's addressing can carry it.  vpu's step is a funnel shift and
# one logic op (s + k is one per warp).  The compiled code
# (SASS_PER_WORD) has 124 IMAD.WIDE.U32 for prng: these 123 and the
# global address (csrc/calibrate.cu shares a word's products by hand and
# folds round 2's uniform product into the keys on the host).
CAL_PHILOX_PRODUCTS, CAL_PHILOX_XORS = philox_pipe_ops(8)
CAL_ALU_OPS = {"cal_prng": CAL_PHILOX_XORS + 16,
               "cal_prng_gather": CAL_PHILOX_XORS + BITS + 16,
               "cal_vpu": 2 * 256}
CAL_FMA_OPS = {"cal_prng": CAL_PHILOX_PRODUCTS,
               "cal_prng_gather": CAL_PHILOX_PRODUCTS, "cal_vpu": 0}

# The two round kernels, counted the same way: Philox by philox_pipe_ops,
# and beside it the ALU-pipe instructions of the function.
# Single rumor, per pull: the lane mask, the rotate amount (c - p), the
# funnel-shift rotate that moves bit c of the partner word to plane p,
# and the OR-in under the mask 1 << p (the partner's LDS is not an ALU
# instruction); per word WORD_OPS.
PULL_ALU_OPS = 4
# Multi-rumor, per draw: the lane mask, the staged word's address and the
# OR-in (the counted rounds draw no drop threshold, so no coin).
MR_PULL_ALU_OPS = 3
# Multi-rumor, per word: phantom mask 2; per-rumor counts as the kernel
# computes them: a thread adds its MR_THREAD_WORDS words a pair at a time
# into MR_COUNT_BITS bit-sliced counters (one carry-save step, a
# three-input xor and a majority, then the carry rippled up by an AND and
# an xor a counter: 10 a pair), and transposes each counter once, at the
# end (5 warp transpose stages of a funnel shift, a select and a
# three-input logic op, their shuffles on another unit, then a popcount
# and a shift-add: 17 a counter, shared by the thread's words).
MR_THREAD_WORDS = 16
MR_COUNT_BITS = 5
MR_WORD_ALU_OPS = (2 + (2 + 2 * (MR_COUNT_BITS - 1)) / 2
                   + MR_COUNT_BITS * (5 * 3 + 2) / MR_THREAD_WORDS)

# SASS instructions per word of each microkernel's timed, straight-line
# instantiation (the stream, not the injected bits), by the pipe that
# issues them: "alu" (LOP3, SHF, LEA, ...), "fma" (the IMAD family: the
# Philox products, and shifts the compiler moved there) and "vector",
# every per-thread instruction (loads, stores and the like too).  Counted
# by :func:`sass_counts` in `cuobjdump -sass` of the built library
# (_build/calibrate-*.so; nvcc of CUDA 12.8, -O3, sm_90a; NVIDIA H100 80GB
# HBM3), NOPs and the closing self-branch left out; uniform-datapath
# instructions (U*: the round keys' loads, vpu's s + k) are one per warp,
# not per thread, and are not counted.  A thread's static count is what
# it issues (straight-line code), and each kernel runs one thread a word,
# so a thread's count is a word's.  Per word: vpu 2 a step
# (SHF.R.U32.HI and LOP3.LUT; s + k is a UIADD3); prng 124 IMAD.WIDE.U32
# for the 123 products of 8 Philox calls (see above) and the global
# address, 155 LOP3.LUT for the 138 xors and 16 ORs;
# prng_gather beside those 32 lane masks, 32 address shifts (IMAD.SHL, on
# the FMA pipe) and 32 LDS.  Philox takes its round keys from the
# constant bank, as the round kernels do.  chip_smoke.py recounts them in
# the build it runs and fails on a difference, or on an opcode in none of
# the pipe lists below.
SASS_PER_WORD = {
    "cal_prng": {"alu": 155, "fma": 125, "vector": 289},
    "cal_prng_gather": {"alu": 188, "fma": 157, "vector": 390},
    "cal_vpu": {"alu": 512, "fma": 2, "vector": 521},
}
FMA_PIPE = ("IMAD", "IMUL")
# (VIADD, Hopper's two-input integer add, is counted with IADD3: its
# pipe is not documented)
ALU_PIPE = ("LOP3", "SHF", "LEA", "IADD3", "VIADD", "ISETP", "SEL", "PRMT",
            "MOV", "POPC", "FLO", "IMNMX", "VIMNMX", "VIADDMNMX", "IABS",
            "PLOP3", "R2P")
# memory, barrier, branch and special-register instructions: other units
# (ACQBULK and PREEXIT: griddepcontrol.wait and .launch_dependents)
OTHER_PIPE = ("LDC", "LDG", "LDS", "STG", "STS", "LDGSTS", "LDGDEPBAR",
              "DEPBAR", "BAR", "BRA", "EXIT", "S2R", "S2UR", "CS2R", "SHFL",
              "ATOMS", "ATOMG", "RED", "REDG", "VOTE", "VOTEU", "BSSY",
              "BSYNC", "WARPSYNC", "MUFU", "I2F", "F2I", "ACQBULK",
              "PREEXIT")


class Work(NamedTuple):
    """One launch's counted work.  The bound takes the busier of the two
    integer pipes (``alu``, ``fma``) against the bytes; the calibrated
    floor prices the Philox ``calls`` at the prng microkernel's rate and
    ``other``, the part of ``alu`` that is not Philox, at the vpu chain's
    ALU rate."""
    calls: float
    alu: float
    fma: float
    other: float
    nbytes: float


def _bound(ops: float, nbytes: float):
    """(ms, what bounds it): the larger of the operations' time at the
    int32 rate and the bytes' time at the memory rate."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bound_of(work: Work):
    return _bound(max(work.alu, work.fma), work.nbytes)


def _one_pipe(calls, ops, nbytes) -> Work:
    """The staged pass's and the sampler's count, as PRs 2-5 made it:
    every operation on one pipe, PHILOX_OPS a call."""
    return Work(calls, calls * PHILOX_OPS + ops, 0, ops, nbytes)


def _by_pipe(words: int, calls_per_word: int, shift_calls: int,
             other: float, nbytes: float) -> Work:
    """A round kernel's count by pipe: ``calls_per_word`` Philox calls a
    word sharing their counters (:func:`philox_pipe_ops`), ``shift_calls``
    lane shifts of one call each, ``other`` ALU-pipe instructions."""
    products, xors = philox_pipe_ops(calls_per_word)
    s_products, s_xors = philox_pipe_ops(1)
    return Work(words * calls_per_word + shift_calls,
                words * xors + shift_calls * s_xors + other,
                words * products + shift_calls * s_products, other, nbytes)


def round_work(n: int, fanout: int, plane_sharing: int) -> Work:
    """One round of the fused kernel's function: the table read and
    written once; a word's draws in calls of four; the 128 lane shifts;
    every pull (PULL_ALU_OPS) and the epilogue (WORD_OPS)."""
    words = FR.n_rows(n) * LANES
    draws = FR.draw_count(fanout, plane_sharing)
    return _by_pipe(words, draws // 4, LANES,
                    words * (draws * plane_sharing * PULL_ALU_OPS + WORD_OPS),
                    2 * words * 4 + 4)


def round_bound(n: int, fanout: int, plane_sharing: int):
    """(bound_ms, bound_by) of one round of the fused kernel."""
    return _bound_of(round_work(n, fanout, plane_sharing))


def mr_round_work(n: int, fanout: int, alive: bool = False,
                  cut: bool = False) -> Work:
    """One multi-rumor round through the value kernel's function: the
    table read and written once plus the 32 counters, and the alive and
    cut words read once each when the round takes them (a partner read
    again from a staged run is not counted: each input byte once); a
    word's draws in calls of four (one call a word at fanout 1, counter
    (w, 0, 0, 0)); the 128 lane shifts of every draw; every pull
    (MR_PULL_ALU_OPS); the phantom mask and per-rumor counts of every
    word (MR_WORD_ALU_OPS)."""
    words = MR.mr_rows(n) * LANES
    arrays = 2 + int(alive) + int(cut)
    return _by_pipe(words, -(-fanout // 4), LANES * fanout,
                    words * (fanout * MR_PULL_ALU_OPS + MR_WORD_ALU_OPS),
                    arrays * words * 4 + RUMORS * 4)


def mr_round_bound(n: int, fanout: int, alive: bool = False,
                   cut: bool = False):
    """(bound_ms, bound_by) of one value-kernel round."""
    return _bound_of(mr_round_work(n, fanout, alive, cut))


def mr_gather_work(n: int) -> Work:
    """One staged pass that adds the counts (the last, and at fanout 1
    the only, pass): tin and rot read and the output written once, one
    Philox call, one pull and the epilogue per word."""
    words = MR.mr_rows(n) * LANES
    return _one_pipe(words, words * (MR_GATHER_PULL_OPS + MR_WORD_OPS),
                     3 * words * 4 + RUMORS * 4)


def mr_gather_bound(n: int):
    """(bound_ms, bound_by) of one staged pass."""
    return _bound_of(mr_gather_work(n))


def sampler_work(n_rows: int, k: int) -> Work:
    """One sampler launch: the int32 output written once, and per draw a
    quarter Philox call plus SAMPLER_DRAW_OPS."""
    draws = n_rows * k
    return _one_pipe(draws / 4, draws * SAMPLER_DRAW_OPS, draws * 4)


def sampler_bound(n_rows: int, k: int):
    """(bound_ms, bound_by) of one sampler launch."""
    return _bound_of(sampler_work(n_rows, k))


def cal_work(name: str, rows: int):
    """(ALU-pipe operations, FMA-pipe operations, bytes) of one
    microkernel launch on ``[rows, 128]``: the table read and written
    once, and each word's operations counted from the function
    (``CAL_ALU_OPS``, ``CAL_FMA_OPS``)."""
    words = rows * LANES
    return (words * CAL_ALU_OPS[name], words * CAL_FMA_OPS[name],
            2 * words * 4)


def cal_bound(name: str, rows: int):
    """(bound_ms, bound_by) of one microkernel launch: the busier pipe's
    operations at the int32 rate, or the bytes at the memory rate."""
    alu, fma, nbytes = cal_work(name, rows)
    return _bound(max(alu, fma), nbytes)


# ---------------------------------------------------------------- counts

def single_rumor_counts(n: int, plane_sharing: int = 1) -> dict:
    """Per-round primitive counts of the single-rumor kernel
    (``csrc/fused_round.cu``, fanout 1), under the reference's keys.
    ``rows``, ``table_bytes`` and ``gathers`` equal the reference's; two
    differ, by design of the port's kernel:

    * ``prng_words`` is ``128 + 32 * words / plane_sharing``, not
      ``8 * 128 + 32 * words``: one row shift per lane, drawn once, where
      the TPU draws an (8, 128) tile;
    * ``vpu_ops`` has no ``3 * ceil(log2 R)`` rotation term: the kernel
      reads partners by address arithmetic, so it is
      ``(7 * 32 + 4) * words``."""
    rows = FR.n_rows(n)
    words = rows * LANES
    return {
        "rows": rows,
        "table_bytes": words * 4,
        "prng_words": LANES + BITS * words // plane_sharing,
        "gathers": BITS * words,
        # ~7 elementwise ops around each gather, +4 mask
        "vpu_ops": (7 * BITS + 4) * words,
    }


def mr_staged_counts(n: int) -> dict:
    """Per-round traffic and counts of the staged multi-rumor route
    (``fused_mr_round_big``), every key equal to the reference's.  The
    "fused" floor's ``5 * T`` is a floor of the function: the port's
    rotation is a ``torch.gather`` with an int64 index tensor
    (``rotate_rows``), which moves more bytes than that."""
    rows = MR.mr_rows(n)
    words = rows * LANES
    t_bytes = words * 4
    stages = max(1, math.ceil(math.log2(rows)))
    return {
        "rows": rows,
        "table_bytes": t_bytes,
        "roll_stages": stages,
        # fused rotation: read table + write rot; gather pass: read
        # table + rot, write out
        "hbm_bytes_fused_rot": 5 * t_bytes,
        # if every roll stage materialized instead
        "hbm_bytes_materialized_rot": (2 * stages + 3) * t_bytes,
        "prng_words": words,
        "gathers": words,
    }


# ---------------------------------------------------------- calibration

# (name, a piece of the mangled name) of each counted instantiation, the
# more specific first: the microkernels' timed ones, and the round
# kernels' main-path ones (fused_round's fanout 1, plane sharing 1, with
# no operand and with all three; the lane-major value kernel's fast one)
CAL_SASS_TAGS = (("cal_prng_gather", "cal_prng_gather_kernelILb0E"),
                 ("cal_prng", "cal_prng_kernelILb0E"),
                 ("cal_vpu", "cal_vpu_kernel"))
ROUND_SASS_TAGS = (
    ("fused_round_f1_s1", "fused_round_kernelILi1ELi1ELb0ELb0ELb0E"),
    ("fused_round_f1_s1_drop_alive_cut",
     "fused_round_kernelILi1ELi1ELb1ELb1ELb1E"),
    ("fused_mr_round", "fused_mr_fast_kernel"))


def _opcode_kernel(mangled: str, tags):
    for name, tag in tags:
        if tag in mangled:
            return name
    return None


_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_OPCODE = re.compile(
    r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(library=None, tags=CAL_SASS_TAGS) -> dict:
    """``{kernel: {"alu": a, "fma": f, "vector": v, "opcodes": {...},
    "unassigned": [...]}}`` from ``cuobjdump -sass`` of a built library
    (default: the calibration library) for each instantiation ``tags``
    names: its static instructions per thread, NOPs and the closing
    self-branch left out, uniform-datapath ones apart; ``unassigned``
    lists the per-thread opcodes in none of ``ALU_PIPE``, ``FMA_PIPE``
    and ``OTHER_PIPE``.  For straight-line code, as the microkernels'
    timed instantiations are, that is each instruction issued once a
    word; a round kernel's loop body runs once a word, its prologue once
    a block.  Needs the CUDA toolkit."""
    lib = library or _kernels.CAL_PRNG.library()
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            name = _opcode_kernel(m.group(1), tags)
            current = counts.setdefault(name, Counter()) if name else None
            continue
        m = _SASS_OPCODE.match(line)
        if current is not None and m and m.group(1) != "NOP":
            current[m.group(1)] += 1
    out = {}
    for name, ops in counts.items():
        ops["BRA"] -= 1                  # the self-branch after EXIT
        ops = +ops
        pipe, unassigned = Counter(), []
        for op, c in ops.items():
            base = op.split(".")[0]
            if base.startswith("U"):
                continue
            pipe["vector"] += c
            if base in FMA_PIPE:
                pipe["fma"] += c
            elif base in ALU_PIPE:
                pipe["alu"] += c
            elif base not in OTHER_PIPE:
                unassigned.append(op)
        out[name] = {k: pipe[k] for k in ("alu", "fma", "vector")}
        out[name]["opcodes"] = dict(sorted(ops.items()))
        out[name]["unassigned"] = sorted(unassigned)
    return out


def calibrate(rows: int, device=None, iters: int = 20) -> dict:
    """Primitive rates at the single-rumor kernel's shape ``[rows, 128]``,
    under the reference's keys: Philox words/s (prng), in-row gathers/s
    (the prng_gather kernel less the prng one, so their shared Philox
    cost cancels; unresolved, ``None``, below 5% of the prng time) and
    elementary ops/s (vpu, the reference's 3 ops a step).  Beside them,
    each microkernel's SASS instructions per second (``SASS_PER_WORD``),
    all of them and those of the ALU and the FMA pipe, and the launches
    each kernel took (:func:`timed_chain`'s count of chains, retried ones
    included, times ``iters``)."""
    dev = resolve_device(device)
    words = rows * LANES
    init = torch.zeros(rows, LANES, dtype=torch.int32, device=dev)
    chains = []
    t_prng = timed_chain(CAL.prng_chain_step, init, iters, dev,
                         CHAIN_REPEATS, chains=chains)
    t_pg = timed_chain(CAL.prng_gather_step, init, iters, dev, CHAIN_REPEATS,
                       chains=chains)
    t_vpu = timed_chain(CAL.vpu_step, init, iters, dev, CHAIN_REPEATS,
                        chains=chains)
    # the differential only resolves the gather when the combined kernel
    # is measurably slower than draw-only; below 5% of t_prng the
    # difference is timing noise, or the gather hid under the Philox work
    t_gather = t_pg - t_prng
    resolved = t_gather > 0.05 * t_prng
    times = {"cal_prng": t_prng, "cal_prng_gather": t_pg, "cal_vpu": t_vpu}
    sass = {f"{name[4:]}_{kind}_per_s": SASS_PER_WORD[name][unit] * words / t
            for name, t in times.items()
            for kind, unit in (("sass", "vector"), ("alu", "alu"),
                               ("fma", "fma"))}
    return {
        "shape": [rows, LANES],
        "prng_words_per_s": BITS * words / t_prng,
        "gathers_per_s": (BITS * words / t_gather) if resolved else None,
        "gather_resolved": resolved,
        "vpu_ops_per_s": 3 * CAL.VPU_CHAIN * words / t_vpu,
        "t_prng_ms": t_prng * 1e3,
        "t_prng_gather_ms": t_pg * 1e3,
        "t_vpu_ms": t_vpu * 1e3,
        **sass,
        "sass_per_word": SASS_PER_WORD,
        "launches": {name: c * iters for name, c in zip(times, chains)},
    }


def hbm_rate(table_bytes: int, iters: int = 20, device=None) -> dict:
    """Streamed read+write rate: an in-place xor over ``table_bytes``
    (each step reads and writes the table once).  A torch call, as the
    reference's is an XLA op outside Pallas."""
    dev = resolve_device(device)
    init = torch.zeros(table_bytes // 4, dtype=torch.int32, device=dev)
    per_iter = timed_chain(lambda i, t: t.bitwise_xor_(i | 1), init, iters,
                           dev, CHAIN_REPEATS)
    return {"table_bytes": table_bytes,
            "bytes_per_s": 2 * table_bytes / per_iter,
            "stream_ms_per_iter": per_iter * 1e3}


# ---------------------------------------------------------- actual runs

def _time_rounds(round_fn, table, iters: int, dev, graph: bool = False,
                 chains: Optional[list] = None) -> float:
    """ms per round of ``round_fn(i, table, out)`` chained through two
    buffers.  A round's work does not depend on its table's bits, so the
    later chains may start from a later round's table.  ``chains``: as
    :func:`timed_chain`'s."""
    bufs = (table, torch.empty_like(table))

    def step(i, t):
        return round_fn(i, t, bufs[1] if t is bufs[0] else bufs[0])
    return timed_chain(step, table, iters, dev, CHAIN_REPEATS, graph,
                       chains) * 1e3


def measure_single(n: int, device=None, iters: int = 20,
                   plane_sharing: int = 1,
                   chains: Optional[list] = None) -> float:
    """Measured ms per round of the single-rumor kernel at fanout 1
    (``plane_sharing=2``: half the draw words).  ``chains``: as
    :func:`timed_chain`'s (also for the two ``measure_mr_*``)."""
    dev = resolve_device(device)
    return _time_rounds(lambda i, t, out: FR.fused_pull_round(
        t, 0, i, n, 1, plane_sharing=plane_sharing, out=out),
        FR.init_fused_state(n, 0, dev).table, iters, dev, chains=chains)


def measure_mr_staged(n: int, rumors: int, device=None,
                      iters: int = 20,
                      chains: Optional[list] = None) -> float:
    """Measured ms per round of the staged multi-rumor route
    (``fused_mr_round_big``: the torch rotation and shift words, then one
    gather pass), stepped directly: the port's public round always takes
    the value route, where the TPU routes 10M x 32 to the staged one.  A
    round is some 150 torch launches, so the chain is timed as a CUDA
    graph, the counterpart of the reference's one jitted loop."""
    dev = resolve_device(device)
    return _time_rounds(lambda i, t, out: MR.fused_mr_round_big(
        t, 0, i, n, 1, rumors=rumors, out=out),
        MR.init_multirumor_state(n, rumors, 0, dev).table, iters, dev,
        graph=True, chains=chains)


def measure_mr_value(n: int, rumors: int, device=None,
                     iters: int = 20,
                     chains: Optional[list] = None) -> float:
    """Measured ms per round of the value route as the run loops launch
    it (:func:`~gossip_tpu_torch.ops.fused_mr_round.fused_mr_round_lanes`
    on lane-major buffers: the value kernel on the card)."""
    dev = resolve_device(device)
    return _time_rounds(lambda i, t, out: MR.fused_mr_round_lanes(
        t, 0, i, n, 1, rumors=rumors, out=out),
        MR.to_lanes(MR.init_multirumor_state(n, rumors, 0, dev).table),
        iters, dev, chains=chains)


# ---------------------------------------------------------------- floors

def _floors(components: dict, actual_ms: float) -> dict:
    serial, overlap = sum(components.values()), max(components.values())
    return {"floor_components_ms": components,
            "floor_serial_ms": serial, "floor_overlap_ms": overlap,
            "utilization_vs_serial": serial / actual_ms,
            "utilization_vs_overlap": overlap / actual_ms}


def single_floor(counts: dict, cal: dict) -> dict:
    """The reference's floor components of the single-rumor round: its
    counts at the calibrated rates (an unresolved gather adds 0)."""
    return {"prng": counts["prng_words"] / cal["prng_words_per_s"] * 1e3,
            "gather": (counts["gathers"] / cal["gathers_per_s"] * 1e3
                       if cal["gather_resolved"] else 0.0),
            "vpu": counts["vpu_ops"] / cal["vpu_ops_per_s"] * 1e3}


def kernel_floors(n: int, cal: dict, hbm_bytes_per_s: float) -> dict:
    """One calibrated floor for each ported round kernel at ``n``, fanout
    1, from its datasheet bound's counts: the Philox calls (four words
    each) at the rate the prng microkernel sustains them (its products
    and xors on their two pipes), the other operations at the ALU pipe's
    rate in the vpu chain (the bound model counts instructions), the
    bytes at the streamed rate.  These units work side by side, so the
    floor is the largest component, not their sum.  It is an estimate,
    not a proven bound: a Philox call whose counters share less than
    prng's costs more than this charges (the floor errs low), and the
    bound model counts the sampler's remainder at 20 operations (there
    it may err high)."""
    out = {}
    for name, work in (("fused_round", round_work(n, 1, 1)),
                       ("fused_mr_round", mr_round_work(n, 1)),
                       ("mr_gather", mr_gather_work(n)),
                       ("sampler", sampler_work(n, 1))):
        comp = {"prng": work.calls * 4 / cal["prng_words_per_s"] * 1e3,
                "vpu": work.other / cal["vpu_alu_per_s"] * 1e3,
                "hbm": work.nbytes / hbm_bytes_per_s * 1e3}
        by = max(comp, key=comp.get)
        bound_ms, bound_by = _bound_of(work)
        out[name] = {"floor_ms": comp[by], "floor_by": by,
                     "floor_components_ms": comp,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return out


# ----------------------------------------------------------------- driver

def roofline(n: int, rumors: int, iters: int, device=None,
             smoke: bool = False) -> dict:
    """The whole document: calibration, the three measured layouts with
    their floors, and the ported kernels' calibrated floors."""
    dev = resolve_device(device)
    sr = single_rumor_counts(n)
    sr2 = single_rumor_counts(n, plane_sharing=2)
    mr = mr_staged_counts(n)

    cal = calibrate(sr["rows"], dev, iters)
    hbm = hbm_rate(mr["table_bytes"], iters, dev)
    hbm4 = hbm_rate(4 * mr["table_bytes"], iters, dev)

    # the launches each round kernel took, from the chains that ran
    chains = {"fused_round": [], "mr_gather": [], "fused_mr_round": []}
    actual_sr_ms = measure_single(n, dev, iters,
                                  chains=chains["fused_round"])
    actual_sr2_ms = measure_single(n, dev, iters, plane_sharing=2,
                                   chains=chains["fused_round"])
    actual_mr_ms = measure_mr_staged(n, rumors, dev, iters,
                                     chains=chains["mr_gather"])
    actual_value_ms = measure_mr_value(n, rumors, dev, iters,
                                       chains=chains["fused_mr_round"])

    mr_floor_fused = mr["hbm_bytes_fused_rot"] / hbm["bytes_per_s"] * 1e3
    mr_floor_mat = (mr["hbm_bytes_materialized_rot"]
                    / hbm["bytes_per_s"] * 1e3)
    staged_floor = max(mr_floor_fused,
                       mr["prng_words"] / cal["prng_words_per_s"] * 1e3)
    kernels = kernel_floors(n, cal, hbm["bytes_per_s"])
    value_floor = kernels["fused_mr_round"]["floor_ms"]
    return {
        "what": ("per-round floors from counted work at rates calibrated on "
                 "the device this run, against measured rounds, for both "
                 "fused layouts (gossip_tpu_torch/tools/roofline.py)"),
        "provenance": provenance(device=dev),
        "backend": dev.type,
        "smoke": smoke,
        "n": n,
        "rumors": rumors,
        "iters": iters,
        "calibration": {**cal, "hbm": hbm, "hbm_beyond_l2": hbm4},
        "single_rumor": {
            "counts": sr,
            "actual_ms_per_round": actual_sr_ms,
            "actual_ms_plane_sharing2": actual_sr2_ms,
            **_floors(single_floor(sr, cal), actual_sr_ms),
            "gather_floor_resolved": cal["gather_resolved"],
            "floor_overlap_ms_plane_sharing2": max(
                single_floor(sr2, cal).values()),
        },
        "mr_staged": {
            "counts": mr,
            "actual_ms_per_round": actual_mr_ms,
            "timed_as": "CUDA graph" if dev.type == "cuda" else "host clock",
            "floor_ms_fused_rotation": mr_floor_fused,
            "floor_ms_materialized_rotation": mr_floor_mat,
            "utilization_vs_fused_floor": mr_floor_fused / actual_mr_ms,
            "rotation_fuses": bool(actual_mr_ms < mr_floor_mat / 2),
            "floor_overlap_ms": staged_floor,
        },
        "mr_value": {
            "actual_ms_per_round": actual_value_ms,
            "floor_ms": value_floor,
            "utilization_vs_floor": value_floor / actual_value_ms,
        },
        "kernels": kernels,
        "round_launches": {name: sum(c) * iters
                           for name, c in chains.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossip_tpu_torch.tools.roofline")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--rumors", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="plumbing rehearsal at tiny shapes")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    ap.add_argument("--out", default=None,
                    help="write the whole document here as JSON")
    a = ap.parse_args(argv)
    n, rumors, iters = ((4096 * 8, 8, 2) if a.smoke
                        else (a.n, a.rumors, a.iters))
    try:
        doc = roofline(n, rumors, iters, a.device, a.smoke)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps({
        "single_actual_ms": doc["single_rumor"]["actual_ms_per_round"],
        "single_util_serial": doc["single_rumor"]["utilization_vs_serial"],
        "mr_actual_ms": doc["mr_staged"]["actual_ms_per_round"],
        "mr_util_hbm": doc["mr_staged"]["utilization_vs_fused_floor"],
        "backend": doc["backend"], "smoke": doc["smoke"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
