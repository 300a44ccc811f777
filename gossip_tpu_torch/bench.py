"""The port's headline number: simulated node-rounds/s per chip.

The flagship run of the JAX package's ``bench.py`` (``run_tpu_fused``):
single-rumor pull gossip over N = 10M nodes on the implicit complete
graph, to 99% coverage, as

    node_rounds_per_sec_per_chip = N * rounds / wall_seconds

with the wall of one steady run (after a warm-up run that also builds
the kernel) read from CUDA events.  It prints one JSON line with the
card's name and power limit::

    python -m gossip_tpu_torch.bench [--n N] [--churn-heal SAMPLER]
        [--churn-sweep]

:func:`run_xla_packed` times the XLA engine's bit-packed pull loop (the
JAX package's ``run_xla_packed``) for the same line; ``chip_smoke.py``
prints it.  :func:`run_churn_heal` (``--churn-heal threefry|kernel``)
times that loop under the JAX package's ``churn_heal`` fault program,
and :func:`run_churn_sweep` (``--churn-sweep``) its ``churn_sweep``
family, eight fault programs as one batch.

``GOSSIP_PROFILE=<dir>`` captures the measured leg as a
``torch.profiler`` Chrome trace into that directory
(:func:`~gossip_tpu_torch.utils.trace.profile`); a profiled leg's walls
carry the profiler's overhead.

There is no CPU row: without a CUDA device it prints nothing and exits
non-zero.  There is no ``vs_baseline`` either: the JAX package derives
that figure for a TPU v4-8.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.utils.provenance import card_info
from gossip_tpu_torch.utils.timing import steady_timed
from gossip_tpu_torch.utils.trace import profile

N_FLAGSHIP = 10_000_000
TARGET = 0.99
LINE_KEYS = ("metric", "value", "unit", "n", "rounds", "wall_ms", "backend",
             "card", "power_limit")


def run_fused(n: int = N_FLAGSHIP, device=None):
    """(rounds, seconds) of the flagship loop at ``n``: one warm-up run,
    then one timed run of ``until_fused`` from a fresh state."""
    dev = resolve_device(device)
    FR.until_fused(n, seed=0, target_coverage=TARGET, device=dev)
    (final, cov), seconds = steady_timed(
        dev, FR.until_fused, n, seed=0, target_coverage=TARGET, device=dev)
    if cov < np.float32(TARGET):
        raise RuntimeError(f"coverage {cov} below the target after "
                           f"{final.round} rounds")
    return final.round, seconds


def run_xla_packed(n: int = N_FLAGSHIP, device=None,
                   sampler: str = "threefry"):
    """(rounds, seconds) of the XLA engine's bit-packed pull loop at
    ``n`` (the JAX package's ``bench.py:run_xla_packed``): one warm-up
    run, then one timed run of ``compiled_until_packed`` from a fresh
    state.  ``sampler="kernel"`` draws the partners with
    ``csrc/sampler.cu``."""
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.si_packed import (compiled_until_packed,
                                                   init_packed_state)
    from gossip_tpu_torch.ops.bitpack import coverage_packed
    from gossip_tpu_torch.topology import generators as G
    dev = resolve_device(device)
    proto = ProtocolConfig(mode="pull", fanout=1, rumors=1)
    run = RunConfig(target_coverage=TARGET, max_rounds=128, seed=0)
    loop, init = compiled_until_packed(proto, G.complete(n), run,
                                       sampler=sampler, device=dev)
    loop(init)
    final, seconds = steady_timed(dev, loop,
                                  init_packed_state(run, proto, n, dev))
    cov = coverage_packed(final.seen, proto.rumors)
    if cov < np.float32(TARGET):
        raise RuntimeError(f"coverage {cov} below the target after "
                           f"{final.round} rounds")
    return final.round, seconds


HEAL_END = 6      # the churn_heal program's partition window closes here


def heal_fault(n: int):
    """The JAX package's ``churn_heal`` program at ``n`` (its
    ``bench.py:run_churn_families``): node 1 down for rounds [1, 4), node
    2 down from round 2 for good, a partition at ``n // 2`` for rounds
    [0, 6), and the drop probability ramped from 0 to 0.1 over rounds
    [0, 4) and held at 0.1 after (``drop_prob=0.02`` would apply before
    the ramp, which starts at round 0)."""
    from gossip_tpu_torch.config import ChurnConfig, FaultConfig
    return FaultConfig(drop_prob=0.02, seed=0, churn=ChurnConfig(
        events=((1, 1, 4), (2, 2, -1)),
        partitions=((0, HEAL_END, n // 2),),
        ramp=(0, 4, 0.0, 0.1)))


def run_churn_heal(n: int = N_FLAGSHIP, device=None,
                   sampler: str = "threefry"):
    """(rounds, coverage, msgs, seconds) of the XLA engine's packed pull
    loop under :func:`heal_fault` at ``n`` (pull, fanout 1, seed 0, to
    99% of the eventual alive set, at most 128 rounds): one warm-up run,
    then one timed run of ``compiled_until_packed`` from a fresh state.
    The JAX package runs this family at 1M on a TPU; 10M is the port's
    full width.  ``sampler="kernel"`` draws the partners with
    ``csrc/sampler.cu``."""
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.models.si_packed import (compiled_until_packed,
                                                   init_packed_state)
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.ops.bitpack import coverage_packed
    from gossip_tpu_torch.topology import generators as G
    dev = resolve_device(device)
    proto = ProtocolConfig(mode="pull", fanout=1, rumors=1)
    run = RunConfig(target_coverage=TARGET, max_rounds=128, seed=0)
    fault = heal_fault(n)
    loop, init = compiled_until_packed(proto, G.complete(n), run, fault,
                                       sampler=sampler, device=dev)
    loop(init)
    final, seconds = steady_timed(dev, loop,
                                  init_packed_state(run, proto, n, dev))
    cov = coverage_packed(final.seen, proto.rumors,
                          NE.metric_alive(fault, n, run.origin, dev))
    if cov < np.float32(TARGET):
        raise RuntimeError(f"coverage {cov} below the target after "
                           f"{final.round} rounds")
    return final.round, cov, float(final.msgs.item()), seconds


SWEEP_K, SWEEP_N = 8, 65_536   # the churn_sweep family's batch and n


def run_churn_sweep(n: int = SWEEP_N, device=None) -> dict:
    """The JAX package's ``churn_sweep`` family (its
    ``bench.py:run_churn_families``): K = 8 ``mixed_scenarios`` (drop
    0.01, ramps to 0.09) over pull, fanout 1, 32 rounds at ``n`` as one
    batch (:func:`~gossip_tpu_torch.parallel.sweep.churn_sweep_curves`).
    ``first_ms`` times the family of salt 0, the first batch the process
    runs; ``warm_ms`` a second family (salt 9) of the same shapes.  There
    is no compile to amortize: the ratio is the first run's own cost
    (allocator growth, first launches)."""
    from gossip_tpu_torch.config import ProtocolConfig, RunConfig
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.parallel.sweep import churn_sweep_curves
    from gossip_tpu_torch.topology import generators as G
    dev = resolve_device(device)
    proto = ProtocolConfig(mode="pull", fanout=1, rumors=1)
    run = RunConfig(target_coverage=TARGET, max_rounds=32, seed=0)

    def family(salt):
        return NE.mixed_scenarios(SWEEP_K, n, salt=salt, drop_prob=0.01,
                                  seed=0, ramp_to=0.09)

    first, first_s = steady_timed(dev, churn_sweep_curves, proto,
                                  G.complete(n), run, family(0), device=dev)
    res, warm_s = steady_timed(dev, churn_sweep_curves, proto,
                               G.complete(n), run, family(9), device=dev)
    return {"k": SWEEP_K, "n": n, "first_ms": first_s * 1e3,
            "warm_ms": warm_s * 1e3,
            "amortization": first_s / max(warm_s, 1e-12),
            "converged": int((res.rounds_to_target >= 0).sum()),
            "first": first, "warm": res}


def measurement_line(n: int, rounds: int, seconds: float, card: dict,
                     engine: str = "fused-cuda") -> dict:
    """The one-line result, with the card it ran on."""
    rate = n * rounds / seconds
    return {"metric": "node_rounds_per_sec_per_chip",
            "value": rate,
            "unit": f"node-rounds/s/chip (N={n}, {engine} pull SI to "
                    f"99% in {rounds} rounds, {seconds * 1e3:.3f} ms)",
            "n": n, "rounds": rounds, "wall_ms": seconds * 1e3,
            "backend": "cuda", "card": card["name"],
            "power_limit": card["power_limit"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossip_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=N_FLAGSHIP)
    ap.add_argument("--churn-heal", choices=("threefry", "kernel"),
                    default=None, metavar="SAMPLER",
                    help="time the churn_heal program on the XLA engine's "
                         "packed loop with this sampler instead of the "
                         "fused flagship")
    ap.add_argument("--churn-sweep", action="store_true",
                    help="time the churn_sweep family (8 mixed scenarios "
                         "at n = 65,536 as one batch) instead of the "
                         "fused flagship")
    a = ap.parse_args(argv)
    try:
        card = card_info()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if a.churn_sweep:
        with profile("bench:cuda", "cuda"):
            sweep = run_churn_sweep(device="cuda")
        print(json.dumps({"churn_sweep": {k: v for k, v in sweep.items()
                                          if k not in ("first", "warm")},
                          "card": card["name"],
                          "power_limit": card["power_limit"]}))
        return 0
    with profile("bench:cuda", "cuda"):
        if a.churn_heal:
            rounds, _, _, seconds = run_churn_heal(a.n, "cuda", a.churn_heal)
        else:
            rounds, seconds = run_fused(a.n, "cuda")
    if a.churn_heal:
        line = measurement_line(a.n, rounds, seconds, card,
                                f"bit-packed {a.churn_heal}, churn_heal")
    else:
        line = measurement_line(a.n, rounds, seconds, card)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
