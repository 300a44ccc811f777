"""Issue rates of the card's integer pipes, and the gap between chained
launches.

    python -m gossip_tpu_torch.tools.pipe_probe [--out PATH]

It builds ``tools/pipe_probe.cu`` as the port's kernels are built
(``ops/_kernels``: ``nvcc`` with their flags, ``-Xptxas -v`` among them,
cached by a hash of the source) and prints one JSON line each:

* ``clock``: the card's name, power limit and SM clocks (``nvidia-smi``),
  before and after;
* ``pipe``: for each instruction mix, every named instruction's thread
  instructions per clock per SM (one full wave of blocks; an SM's
  instructions over its ``clock64`` span, from its first block's start
  to its last block's end; the median over the SMs), all the loop's
  instructions per clock (``issue_per_clock``), the SM clock the wave
  ran at (``clock64`` over ``%globaltimer``), and the opcodes of the
  timed loop's body in the built code (``loop_opcodes``), with ``clean``
  true when the body holds the named instructions and others (its
  counter, its branch, register moves) at most ``OTHER_SHARE`` of them;
  ``per_clock_per_sm_block_median`` is each instruction's rate over the
  median block's own span instead, which overstates a mix whose blocks
  do not end together;
* ``gap_ms``: ms per launch of empty grids of a few shapes, chained
  plainly and with programmatic dependent launch (PDL).

``--out`` also writes the whole document with the ptxas report.  It
needs a CUDA device and exits 1 without one, and exits 1 after its lines
when a mix is not clean, since its rates then count other instructions
too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.tools import roofline as R
from gossip_tpu_torch.utils.timing import timed_chain

SOURCE = Path(__file__).resolve().with_suffix(".cu")
GRIDS = ((1, 128), (132, 128), (2448, 128), (306, 1024))  # empty grids
PIPE_ITERS = 4096
CHAINS, UNROLL, THREADS = 8, 16, 256     # pipe_probe.cu's constants
OTHER_SHARE = 1 / 32
# each op's template argument in pipe_probe.cu and the opcodes it may
# compile to
OPS = {"wide": (0, ("IMAD.WIDE.U32",)), "hi": (1, ("IMAD.HI.U32",)),
       "lo": (2, ("IMAD", "IMUL")), "lop3": (3, ("LOP3.LUT",))}
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
PROBE = _kernels.Kernel("pipe_probe", SOURCE, "probe_pipe_launch",
                        [_I, _P, _U, _U, _I, _P, _P, _P])
_BRANCH = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/.*\bBRA\b.*?0x([0-9a-f]+)")
_ADDRESS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/")


def mix_kernel(mix: str) -> str:
    """The mangled-name fragment of the instantiation that runs ``mix``
    (``pipe_kernel<A, B, NA>``)."""
    ops = [OPS[op][0] for op in mix.split("+")]
    return (f"pipe_kernelILi{ops[0]}ELi{ops[-1]}"
            f"ELi{CHAINS // len(ops)}EE")


def loop_bodies(sass: str) -> dict:
    """{mangled kernel name: Counter of the opcodes of its largest loop
    body} from ``cuobjdump -sass``: the instructions from a backward
    branch's target to the branch, NOPs left out."""
    out, lines, name = {}, [], None

    def close():
        if name is None:
            return
        best = Counter()
        for addr, target in ((int(m.group(1), 16), int(m.group(2), 16))
                             for m in map(_BRANCH.match, lines) if m):
            if target < addr:
                body = Counter(
                    op.group(1) for line in lines
                    if (a := _ADDRESS.match(line))
                    and target <= int(a.group(1), 16) <= addr
                    and (op := R._SASS_OPCODE.match(line))
                    and op.group(1) != "NOP")
                if sum(body.values()) > sum(best.values()):
                    best = body
        out[name] = best

    for line in sass.splitlines():
        m = R._SASS_FUNCTION.match(line)
        if m:
            close()
            name, lines = m.group(1), []
        elif name is not None:
            lines.append(line)
    close()
    return out


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def pipe_rates(bodies: dict) -> list:
    """One line per instruction mix (module doc)."""
    launch = PROBE.fn()
    name_of = PROBE.entry_point("probe_pipe_name", [_I])
    name_of.restype = ctypes.c_char_p
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for which in range(PROBE.entry_point("probe_pipe_count", [])()):
        mix = name_of(which).decode()
        blocks = ctypes.c_int()
        _check(launch(which, None, 0, 0, 0, None, ctypes.byref(blocks), None),
               mix)
        res = torch.empty(blocks.value * THREADS, dtype=torch.int32,
                          device="cuda")
        span = torch.empty(4 * blocks.value, dtype=torch.int64,
                           device="cuda")
        ops = mix.split("+")
        per_block = CHAINS // len(ops) * UNROLL * PIPE_ITERS * THREADS
        rates, by_block, ghz = [], [], []
        for rep in range(4):                      # one warm-up
            _check(launch(which, ctypes.c_void_p(res.data_ptr()), 0xD2511F53,
                          0xCD9E8D57, PIPE_ITERS,
                          ctypes.c_void_p(span.data_ptr()),
                          ctypes.byref(blocks), _stream()), mix)
            torch.cuda.synchronize()
            if rep:
                s = span.view(-1, 4).cpu().double()
                cycles = s[:, 1] - s[:, 0]
                ghz.append(float((cycles / s[:, 3]).median()))
                by_block.append(per_block * blocks.value / sms
                                / float(cycles.median()))
                rates.append(statistics.median(
                    per_block * len(sm) / float(sm[:, 1].max()
                                                - sm[:, 0].min())
                    for sm in (s[s[:, 2] == k] for k in s[:, 2].unique())))
        per_op = statistics.median(rates)
        body = next((dict(c) for k, c in bodies.items()
                     if mix_kernel(mix) in k), {})
        named = sum(c for op, c in body.items()
                    if any(op in OPS[o][1] for o in ops))
        total = sum(body.values())
        out.append({
            "mix": mix, "blocks": blocks.value,
            "blocks_per_sm": blocks.value / sms,
            "sm_ghz": statistics.median(ghz),
            "per_clock_per_sm": {op: per_op for op in ops},
            "per_clock_per_sm_block_median": statistics.median(by_block),
            "issue_per_clock": (per_op * len(ops) * total / named
                                if named else None),
            "loop_opcodes": dict(sorted(body.items())),
            "clean": bool(named) and total - named <= OTHER_SHARE * named})
    return out


def launch_gap() -> dict:
    """ms a launch of an empty grid of (blocks, threads), plain and with
    PDL."""
    nop = PROBE.entry_point("probe_nop_launch", [_P, _I, _I, _I, _P])
    t = torch.zeros(128, dtype=torch.int32, device="cuda")

    def step(i, c, blocks, threads, pdl):
        _check(nop(ctypes.c_void_p(t.data_ptr()), blocks, threads, pdl,
                   _stream()), "nop")
    return {f"{b}x{n} {'pdl' if pdl else 'plain'}": 1e3 * timed_chain(
        lambda i, c, b=b, n=n, pdl=pdl: step(i, c, b, n, pdl), None, 20,
        "cuda", 9) for b, n in GRIDS for pdl in (0, 1)}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossip_tpu_torch.tools.pipe_probe")
    ap.add_argument("--out", default=None,
                    help="write every line and the ptxas report here as "
                         "JSON")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pipe_probe: needs a CUDA device", file=sys.stderr)
        return 1
    clock = _smi("name,power.limit,clocks.sm,clocks.max.sm")
    PROBE.fn()
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(PROBE.library())],
                          capture_output=True, text=True, check=True).stdout
    doc = {"clock": clock, "pipes": pipe_rates(loop_bodies(sass)),
           "gap_ms": launch_gap(),
           "clock_after": _smi("clocks.sm,power.draw")}
    for line in ({"clock": clock, "clock_after": doc["clock_after"]},
                 *({"pipe": p} for p in doc["pipes"]),
                 {"gap_ms": doc["gap_ms"]}):
        print(json.dumps(line), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({**doc, "ptxas": PROBE.ptxas},
                                          indent=1))
    unclean = [p["mix"] for p in doc["pipes"] if not p["clean"]]
    if unclean:
        print(f"pipe_probe: loops hold other instructions: {unclean}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
