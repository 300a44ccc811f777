"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in this checkout,
holds it bitwise against its plain PyTorch version at N = 10M, drives the
flagship run (single-rumor pull gossip to 99% coverage) through the
port's own entry points, and measures it.  One JSON line per phase:

1. ``device``  the card, as ``nvidia-smi`` and torch name it;
2. ``build``   the kernel build (one ``nvcc`` per source, started together);
3. ``checks``  one kernel round against the plain version on the card,
   bitwise (tolerance 0), on the Philox stream at fanout 1 and 2,
   plane sharing 1 and 2, with the drop coin, alive and cut tables, at
   N = 10M and 10M - 37, and under injected bits (once with every
   draw's drop coin at the threshold or one below it); then the
   kernel's time per round, the plain version's, and the bound;
4. ``main_path``  ``run_simulation`` at N = 10M, pull, fanout 1, seed 0,
   target 0.99, with every launch count set to 0 just before and read
   just after; then the same loop replayed round by round with the
   plain version, the cost of the loop's once-per-round host read, and
   the kernel's share of the loop's wall (rounds x kernel time / wall);
5. ``bench``   the node-rounds/s line of ``gossip_tpu_torch.bench``.

Then the ``kernels`` line, and last ``{"ok": true, "device": ...}``.  Any
failed check raises, and the exit code is not 0.  Without a CUDA device,
or without the repository around it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N = 10_000_000
SEED = 0
CHECK_ROUND = 3           # a round other than 0, so the key's k1 is not 0
INFECTED = 0.03           # share of nodes infected in the checks' table
TIMED_LAUNCHES = 20       # launches per timed batch
TIMED_BATCHES = 9         # batches; the median batch is reported
SLEEP_CYCLES = 20_000_000  # device sleep that queues a batch behind it

# Least time for one round (the bound): the larger of bytes over the
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
PULL_OPS = 9              # lane 1, bit 2, partner bit 2, coin 2, OR-in 2
WORD_OPS = 3              # phantom mask 2, popcount 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def round_bound(n: int, fanout: int, plane_sharing: int):
    """(bound_ms, bound_by) of one round of the fused kernel's function:
    the table read and written once, and the integer work of the Philox
    stream (one call per four draws, plus the 128 lane shifts), of every
    pull and of the epilogue."""
    from gossip_tpu_torch.ops.fused_round import LANES, draw_count, n_rows
    words = n_rows(n) * LANES
    draws = draw_count(fanout, plane_sharing)
    ops = ((words * draws / 4 + LANES) * PHILOX_OPS
           + words * draws * plane_sharing * PULL_OPS + words * WORD_OPS)
    nbytes = 2 * words * 4 + 4
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_ms(launch) -> float:
    """Median time of one launch on the card: batches of launches queued
    behind a device sleep (so the host's enqueue is off the clock), timed
    with CUDA events."""
    import torch
    per_launch = []
    for _ in range(TIMED_BATCHES):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_LAUNCHES):
            launch()
        stop.record()
        torch.cuda.synchronize()
        per_launch.append(start.elapsed_time(stop) / TIMED_LAUNCHES)
    return statistics.median(per_launch)


def phase_checks(dev, n: int):
    """Kernel against plain on the card, bitwise.  Returns the cases'
    results, their largest absolute difference, and the table at n."""
    import numpy as np
    import torch
    from gossip_tpu_torch.config import FaultConfig
    from gossip_tpu_torch.ops import fused_round as FR

    rng = np.random.default_rng(SEED)
    tables = {}
    for m in (n, n - 37):
        tables[m] = FR.node_pack(
            torch.from_numpy(rng.random(m) < INFECTED).to(dev))
    alive = FR.node_pack(torch.from_numpy(rng.random(n) < 0.9).to(dev))
    cut = FR.render_cut_bits(n // 3, n, dev)
    thr = FR.drop_threshold_for(FaultConfig(drop_prob=0.05))
    rows = FR.n_rows(n)
    inject = (
        rng.integers(0, 2**32, size=(8, FR.LANES), dtype=np.uint32),
        rng.integers(0, 2**32, size=(FR.BITS, rows, FR.LANES),
                     dtype=np.uint32))
    # every draw's coin field exactly at the threshold or one below it
    coin = np.where(rng.random(inject[1].shape) < 0.5, thr, thr - 1)
    boundary = (inject[0], (coin.astype(np.uint32) << np.uint32(12))
                | (inject[1] & np.uint32(0xFFF)))
    # (name, n, fanout, sharing, drop threshold, alive, cut, inject)
    cases = [("f1_s1", n, 1, 1, 0, None, None, None),
             ("f2_s1", n, 2, 1, 0, None, None, None),
             ("f1_s2", n, 1, 2, 0, None, None, None),
             ("f2_s2", n, 2, 2, 0, None, None, None),
             ("drop", n, 1, 1, thr, None, None, None),
             ("alive", n, 1, 1, 0, alive, None, None),
             ("cut", n, 1, 1, 0, None, cut, None),
             ("drop_alive_cut", n, 2, 1, thr, alive, cut, None),
             ("tail_f1_s1", n - 37, 1, 1, 0, None, None, None),
             ("tail_f2_s2", n - 37, 2, 2, 0, None, None, None),
             ("inject", n, 1, 1, 0, None, None, inject),
             ("inject_coin_boundary", n, 1, 1, thr, None, None, boundary)]
    results, max_err = [], 0
    for name, m, fanout, sharing, t, a, c, bits in cases:
        table = tables[m]
        pop = torch.zeros(1, dtype=torch.int32, device=dev)
        got = FR.fused_pull_round(table, SEED, CHECK_ROUND, m, fanout,
                                  inject_bits=bits, drop_threshold=t,
                                  alive_table=a, plane_sharing=sharing,
                                  cut_words=c, pop=pop)
        want = FR.fused_pull_round_plain(table, SEED, CHECK_ROUND, m, fanout,
                                         bits, t, a, sharing, c)
        err = int((FR.to_words(got) - FR.to_words(want)).abs().max())
        equal = bool(torch.equal(got, want))
        pop_ok = int(pop.item()) == FR.popcount(want)
        grew = FR.popcount(want) - FR.popcount(table)
        results.append({"case": name, "n": m, "fanout": fanout,
                        "sharing": sharing, "bitwise_equal": equal,
                        "max_abs_err": err, "popcount_equal": pop_ok,
                        "newly_infected": grew})
        check(equal and pop_ok and grew > 0, f"kernel vs plain, {name}")
        max_err = max(max_err, err)
    return results, max_err, tables[n]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import numpy as np

    from gossip_tpu_torch import bench
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (ProtocolConfig, RunConfig,
                                         TopologyConfig)
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.ops import fused_round as FR
    from gossip_tpu_torch.utils.timing import steady_timed

    dev = torch.device("cuda", 0)
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _kernels.build_all()
    emit("build", build_s=time.perf_counter() - t0,
         kernels={k.name: [ln.strip() for ln in k.ptxas.splitlines()
                           if "registers" in ln] for k in _kernels.KERNELS})

    # 3. kernel against plain, then times at the main path's shape
    results, max_err, table = phase_checks(dev, N)
    out = torch.empty_like(table)
    pop = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = kernel_ms(lambda: FR.fused_pull_round(table, SEED, CHECK_ROUND, N,
                                               out=out, pop=pop))
    plain_ms = 1e3 * statistics.median(
        steady_timed(dev, FR.fused_pull_round_plain, table, SEED,
                     CHECK_ROUND, N)[1] for _ in range(3))
    bound_ms, bound_by = round_bound(N, 1, 1)
    emit("checks", cases=results, max_abs_err=max_err, tolerance=0,
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, card=smi)

    # 4. the main path, counts from 0
    for k in _kernels.KERNELS:
        k.launches = 0
    report = run_simulation(ProtocolConfig(mode="pull", fanout=1),
                            TopologyConfig(family="complete", n=N),
                            RunConfig(seed=SEED, target_coverage=0.99,
                                      engine="fused"),
                            device="cuda")
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    rounds = report.rounds
    check(rounds > 0 and report.coverage >= np.float32(0.99),
          f"coverage {report.coverage} after {rounds} rounds")
    check(report.msgs == float(np.float32(2 * N * rounds)),
          f"msgs {report.msgs} != 2*n*rounds")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    check(launches["fused_round"] == rounds,
          f"{launches['fused_round']} launches for {rounds} rounds")
    emit("main_path", report=report.to_dict(), launches=launches, card=smi)

    # the same loop, round by round through the plain version
    final, _ = FR.until_fused(N, SEED, device=dev)
    plain = FR.init_fused_state(N, 0, dev).table
    for r in range(final.round):
        plain = FR.fused_pull_round_plain(plain, SEED, r, N)
    check(final.round == rounds and torch.equal(final.table, plain),
          "main path vs its plain replay")
    # the once-per-round host read: the loop against the curve loop
    # (same rounds, counters read once at the end)
    until_s = statistics.median(
        steady_timed(dev, FR.until_fused, N, SEED, device=dev)[1]
        for _ in range(5))
    curve_s = statistics.median(
        steady_timed(dev, FR.curve_fused, N, SEED, max_rounds=rounds,
                     device=dev)[1] for _ in range(5))
    emit("main_path_replay", plain_replay_equal=True, rounds=rounds,
         until_ms=until_s * 1e3, curve_ms=curve_s * 1e3,
         host_read_ms_per_round=(until_s - curve_s) * 1e3 / rounds,
         kernel_share_of_until=rounds * ms / (until_s * 1e3),
         kernel_share_of_curve=rounds * ms / (curve_s * 1e3), card=smi)

    # 5. bench
    b_rounds, seconds = bench.run_fused(N, "cuda")
    line = bench.measurement_line(N, b_rounds, seconds, bench.card_info())
    check(b_rounds == rounds, f"bench ran {b_rounds} rounds, not {rounds}")
    emit("bench", line=line)

    print(json.dumps({"kernels": [{
        "name": "fused_round", "route": "cuda",
        "source": "gossip_tpu_torch/csrc/fused_round.cu",
        "replaces": "gossip_tpu/ops/pallas_round.py:316",
        "launches": launches["fused_round"], "max_abs_err": max_err,
        "bitwise_equal": True, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": "no single PyTorch call computes this round",
        "card": smi}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
