"""Run loops of the XLA engine's bool rounds.

The port of the JAX package's ``runtime/simulator.py`` (SI modes; the
SWIM and checkpointed loops wait for their slices):

* :func:`simulate_curve` runs exactly ``run.max_rounds`` rounds and
  records the coverage and the message count after each (the
  reference's ``lax.scan``);
* :func:`simulate_until` runs until the float32 coverage reaches the
  float32 target or ``run.max_rounds`` (the reference's
  ``lax.while_loop``); it reads the coverage on the host once per round.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models.si import (coverage, make_si_round,
                                        topology_device)
from gossip_tpu_torch.models.state import SimState, alive_mask, init_state
from gossip_tpu_torch.topology.generators import Topology


@dataclasses.dataclass
class CurveResult:
    coverage: np.ndarray        # float32[T]: coverage after round t
    msgs: np.ndarray            # float32[T]: cumulative messages after t
    rounds_to_target: int       # first round with coverage >= target, or -1
    final_coverage: float
    state: SimState


@dataclasses.dataclass
class UntilResult:
    rounds: int
    coverage: float
    msgs: float
    state: SimState


def _build(proto, topo, run, fault, device):
    dev = topology_device(topo, device)
    step = make_si_round(proto, topo, fault, run.origin, dev)
    return (step, init_state(run, proto, topo.n, dev),
            alive_mask(fault, topo.n, run.origin, dev))


def simulate_curve(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                   fault: Optional[FaultConfig] = None,
                   device=None) -> CurveResult:
    step, state, alive = _build(proto, topo, run, fault, device)
    covs, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(coverage(state.seen, alive))
        msgs.append(state.msgs)
    covs = np.asarray(covs, np.float32)
    msgs = np.asarray([float(m.item()) for m in msgs], np.float32)
    hit = np.nonzero(covs >= run.target_coverage)[0]
    return CurveResult(coverage=covs, msgs=msgs,
                       rounds_to_target=int(hit[0]) + 1 if len(hit) else -1,
                       final_coverage=float(covs[-1]), state=state)


def simulate_until(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                   fault: Optional[FaultConfig] = None,
                   device=None) -> UntilResult:
    step, state, alive = _build(proto, topo, run, fault, device)
    target = np.float32(run.target_coverage)
    cov = coverage(state.seen, alive)
    while cov < target and state.round < run.max_rounds:
        state = step(state)
        cov = coverage(state.seen, alive)
    return UntilResult(rounds=state.round, coverage=cov,
                       msgs=float(state.msgs.item()), state=state)
