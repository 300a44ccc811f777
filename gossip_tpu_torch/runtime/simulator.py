"""Run loops of the XLA engine's bool rounds.

The port of the JAX package's ``runtime/simulator.py`` (SI modes, with
their fault programs; the SWIM and checkpointed loops wait for their
slices):

* :func:`simulate_curve` runs exactly ``run.max_rounds`` rounds and
  records the coverage and the message count after each (the
  reference's ``lax.scan``);
* :func:`simulate_until` (:func:`compiled_until`'s loop) runs until the
  float32 coverage reaches the float32 target or ``run.max_rounds`` (the
  reference's ``lax.while_loop``); it reads the coverage on the host once
  per round.

Under a fault program the coverage's denominator is the eventual alive
set, and the round's ``lost`` count is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models.si import (coverage, make_si_round,
                                        topology_device)
from gossip_tpu_torch.models.state import SimState, init_state
from gossip_tpu_torch.ops import nemesis as NE
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
    """The step (``state -> state``: ``lost`` dropped under a program),
    a fresh state, the coverage denominator, and whether the reference's
    compiled loops fold it (:func:`~gossip_tpu_torch.ops.nemesis.folded_denominator`)."""
    dev = topology_device(topo, device)
    step = NE.drop_lost(make_si_round(proto, topo, fault, run.origin, dev),
                        NE.get(fault))
    return (step, init_state(run, proto, topo.n, dev),
            NE.metric_alive(fault, topo.n, run.origin, dev),
            NE.folded_denominator(fault))


def simulate_curve(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                   fault: Optional[FaultConfig] = None,
                   device=None) -> CurveResult:
    """Exactly ``run.max_rounds`` rounds; the coverage after each as the
    reference's scan computes it."""
    step, state, alive, folded = _build(proto, topo, run, fault, device)
    covs, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(coverage(state.seen, alive, folded))
        msgs.append(state.msgs)
    covs = np.asarray(covs, np.float32)
    msgs = np.asarray([float(m.item()) for m in msgs], np.float32)
    hit = np.nonzero(covs >= run.target_coverage)[0]
    return CurveResult(coverage=covs, msgs=msgs,
                       rounds_to_target=int(hit[0]) + 1 if len(hit) else -1,
                       final_coverage=float(covs[-1]), state=state)


def compiled_until(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                   fault: Optional[FaultConfig] = None, device=None):
    """``(loop, init)``: the bool while-loop and a fresh state; call
    ``loop(state)``.  It steps while the coverage, as the reference's
    compiled condition computes it, is below the float32 target and the
    round below ``run.max_rounds``."""
    step, init, alive, folded = _build(proto, topo, run, fault, device)
    target = np.float32(run.target_coverage)

    def loop(state: SimState) -> SimState:
        while (coverage(state.seen, alive, folded) < target
               and state.round < run.max_rounds):
            state = step(state)
        return state

    return loop, init


def simulate_until(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                   fault: Optional[FaultConfig] = None,
                   device=None) -> UntilResult:
    """:func:`compiled_until`'s loop from a fresh state; the report's
    coverage is the reference's eager value."""
    loop, init = compiled_until(proto, topo, run, fault, device)
    final = loop(init)
    alive = NE.metric_alive(fault, topo.n, run.origin, final.seen.device)
    return UntilResult(rounds=final.round, coverage=coverage(final.seen,
                                                             alive),
                       msgs=float(final.msgs.item()), state=final)
