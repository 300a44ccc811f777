"""Host cost of the single-rumor round's launch path, and the fused loop's
wall per round, on the card.

    PYTHONPATH=<checkout> python gossip_tpu_torch/tools/launch_cost.py \
        [--n N] [--calls C] [--batches B] [--reps K]

It times the package it imports, so with a checkout's root first on
``PYTHONPATH`` it times that checkout: the script uses only names that
every tree of the port has had since the fused round's first port
(``ops/_kernels.fused_round`` and ``FUSED_ROUND``, ``ops/fused_round``'s
``n_rows``, ``until_fused`` and ``curve_fused``), so one copy of it
compares two trees run one after the other.  It prints one JSON line:

* ``entry_us``: host microseconds per call of the C entry point
  ``fused_round_launch`` through ctypes, with the arguments the wrapper
  passes (captured from one wrapper call): the median of ``batches``
  batches of ``calls`` calls, each batch enqueued without a
  synchronisation and shorter than the device's launch queue;
* ``wrapper_us``: the same for the wrapper ``_kernels.fused_round``
  (its checks, the ctypes call and the launch count);
* ``until_ms_per_round`` and ``curve_ms_per_round``: the loops' wall
  (synchronised, ``reps`` runs, median) over their rounds at ``n``:
  ``until_fused`` reads each round's counter on the host,
  ``curve_fused`` reads them once at the end;
* the card's name and power limit, as ``nvidia-smi`` gives them.

It needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time


def _per_call_us(call, calls: int, batches: int, sync) -> float:
    """Median over ``batches`` of the host microseconds per ``call()``
    in a batch of ``calls`` back-to-back calls (one warm-up batch)."""
    out = []
    for b in range(batches + 1):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        t = time.perf_counter() - t0
        if b:
            out.append(t / calls * 1e6)
    sync()
    return statistics.median(out)


def _loop_ms(fn, reps: int, sync) -> tuple:
    """(median wall ms, rounds) of ``reps`` synchronised runs of ``fn``
    (one warm-up run)."""
    walls, rounds = [], None
    for r in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        st = fn()
        sync()
        if r:
            walls.append((time.perf_counter() - t0) * 1e3)
        rounds = st.round
    return statistics.median(walls), rounds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=10_000_000)
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--batches", type=int, default=9)
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("launch_cost: needs a CUDA device", file=sys.stderr)
        return 1
    import gossip_tpu_torch
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_round as FR

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    rows = FR.n_rows(args.n)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-2**31, 2**31, (rows, 128), generator=gen,
                          dtype=torch.int32, device=dev)
    out = torch.empty_like(table)
    pop = torch.zeros(1, dtype=torch.int32, device=dev)
    key = (12345, 3)

    def wrapper():
        _kernels.fused_round(table, args.n, 1, key, 0, 1, out=out, pop=pop)

    captured = []
    real = _kernels._launch

    def grab(kernel, device, *a):
        captured.append(a)
        return real(kernel, device, *a)

    _kernels._launch = grab
    try:
        wrapper()
    finally:
        _kernels._launch = real
    entry = _kernels.FUSED_ROUND.fn()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def raw():
        if entry(*captured[0], stream):
            raise RuntimeError("fused_round_launch failed")

    entry_us = _per_call_us(raw, args.calls, args.batches, sync)
    wrapper_us = _per_call_us(wrapper, args.calls, args.batches, sync)
    until_ms, rounds = _loop_ms(
        lambda: FR.until_fused(args.n, 0, device=dev)[0], args.reps, sync)
    curve_ms, _ = _loop_ms(
        lambda: FR.curve_fused(args.n, 0, max_rounds=rounds, device=dev)[0],
        args.reps, sync)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "package": str(gossip_tpu_torch.__file__), "n": args.n,
        "calls": args.calls, "batches": args.batches, "reps": args.reps,
        "entry_us": entry_us, "wrapper_us": wrapper_us, "rounds": rounds,
        "until_ms_per_round": until_ms / rounds,
        "curve_ms_per_round": curve_ms / rounds, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
