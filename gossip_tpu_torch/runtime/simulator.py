"""Run loops of the XLA engine's bool rounds.

The port of the JAX package's ``runtime/simulator.py`` (the SI modes
and SWIM, with their fault programs):

* :func:`simulate_curve` runs exactly ``run.max_rounds`` rounds and
  records the coverage and the message count after each (the
  reference's ``lax.scan``);
* :func:`simulate_until` (:func:`compiled_until`'s loop) runs until the
  float32 coverage reaches the float32 target or ``run.max_rounds`` (the
  reference's ``lax.while_loop``); it reads the coverage on the host once
  per round.

Under a fault program the coverage's denominator is the eventual alive
set, and the round's ``lost`` count is dropped.

SWIM's loops (:func:`simulate_swim_curve`, :func:`simulate_swim_until`)
record the detection fraction of the round just run: the share of
(alive observer, dead subject) pairs confirmed DEAD, a float32 quotient
in the reference's compiled loops too (its denominator is not folded).
With a ``group`` (the reference's ``mesh=``) they run the node-sharded
round, and the detection's integer counts are summed over the ranks.

The checkpointed loops (:mod:`gossip_tpu_torch.utils.checkpoint`'s
segments): :func:`checkpointed_si` (the single-device SI driver of the
reference's ``run --checkpoint``) and :func:`checkpointed_swim` (one
device or a group) here; the packed node-sharded one in
:mod:`gossip_tpu_torch.parallel.sharded_packed`, rumor mongering's in
:mod:`gossip_tpu_torch.models.rumor` and the fused rumor planes' in
:mod:`gossip_tpu_torch.parallel.sharded_fused`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import swim as SW
from gossip_tpu_torch.models.si import (coverage, least_count, make_si_round,
                                        topology_device)
from gossip_tpu_torch.models.state import SimState, init_state
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.topology.generators import Topology, complete


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


def _swim_setup(proto: ProtocolConfig, n: int, rounds: int, dead_nodes,
                fail_round: int, fault: Optional[FaultConfig],
                topo: Optional[Topology], seed: int, device, group=None):
    """The SWIM round, a fresh state, and the detection of the round just
    run as ``state -> (confirmed, pairs)`` 0-d tensors on the device
    (None without dead subjects: the metric is then 0).  With a
    ``group`` the round is the sharded one
    (:mod:`gossip_tpu_torch.parallel.sharded_swim`), and the counts are
    this rank's share, which the loops sum over the ranks."""
    dead_nodes = tuple(dead_nodes)
    if group is None:
        step = SW.make_swim_round(proto, n, dead_nodes, fail_round, fault,
                                  topo, max_rounds=rounds, device=device)
        dev = topology_device(complete(n) if topo is None else topo, device)
        init = SW.init_swim_state(n, proto.swim_subjects, seed, dev)
        # the metric's observers: the nodes alive after fail_round
        observers = SW.observer_alive(n, dead_nodes, fault, dev)
    else:
        from gossip_tpu_torch.parallel import sharded_swim as SS
        dev = group.device
        step = SS.make_sharded_swim_round(proto, n, group, dead_nodes,
                                          fail_round, fault, topo,
                                          max_rounds=rounds)
        init = SS.init_sharded_swim_state(n, proto, group, seed)
        observers = SS.observer_rows(n, dead_nodes, fault, group)
    # the metric's targets: the scripted deaths and the program's
    # permanent ones
    dead = SW.detection_targets(dead_nodes, fault)
    epoch_rounds = SW.resolve_epoch_rounds(proto, n)

    def counts(s):
        window = SW.subject_window(s.round - 1, proto.swim_subjects, n,
                                   proto.swim_rotate, epoch_rounds, dev)
        return SW.detection_counts(s.wire, dead, observers, window)

    return step, init, counts if dead else None, observers


class SwimRecorder:
    """The reference's ``_swim_recorder``, the failure-detection reading
    of the round metrics: ``newly`` the newly confirmed-dead (observer,
    subject) wire entries among the observers, ``front`` each shard's
    fraction of observers holding any confirmed death, ``offered`` the
    dissemination bound ``fanout * n * S``, ``bytes`` the wire merge's
    ``4 * n_pad * S`` table and the msgs sum on a mesh (0 on one
    device).  ``observers`` is this rank's rows of the metric's
    observers."""

    def __init__(self, label: str, proto: ProtocolConfig, n: int,
                 max_rounds: int, observers: torch.Tensor, group=None):
        s_subj = proto.swim_subjects
        k = 1 if group is None else group.size
        n_pad = n if group is None else group.rows(n)[0]
        self.observers = observers
        self.offered = float(np.float32(proto.fanout * n * s_subj))
        self.bytes = 0.0 if k == 1 else 4.0 * n_pad * s_subj + 4.0
        self.m = RM.init(max(max_rounds, 1), k, label, observers.device,
                         group=group, local_shards=1)
        self.prev = None

    def _dead(self, state):
        return state.wire == SW.DEAD_WIRE

    def start(self, state) -> None:
        self.prev = RM.count_bool(self._dead(state), self.observers)

    def wrap(self, step):
        def recorded(s0):
            s1 = step(s0)
            dead = self._dead(s1)
            count = RM.count_bool(dead, self.observers)
            RM.record(self.m, newly=count - self.prev,
                      msgs=s1.msgs - s0.msgs, offered=self.offered,
                      bytes=self.bytes,
                      front=RM.front_bool(dead, self.observers))
            self.prev = count
            return s1

        return recorded


def _swim_recorded(label, proto, n, rounds, step, state, observers, group):
    """``(step, recorder or None)``: the SWIM step with its round metrics
    recorded when they are wanted."""
    if not RM.wanted():
        return step, None
    rec = SwimRecorder(label, proto, n, rounds, observers, group)
    rec.start(state)
    return rec.wrap(step), rec


def simulate_swim_curve(proto: ProtocolConfig, n: int, rounds: int,
                        dead_nodes=(), fail_round: int = 0,
                        fault: Optional[FaultConfig] = None,
                        topo: Optional[Topology] = None, seed: int = 0,
                        device=None, group=None):
    """Exactly ``rounds`` SWIM rounds.  Returns the detection fraction
    after each (float32 numpy, read from the device once at the end) and
    the final state.  With a ``group`` (the reference's ``mesh``) the
    sharded round runs, the state is this rank's rows, and the counts
    are summed over the ranks once, at the end."""
    step, state, counts, observers = _swim_setup(
        proto, n, rounds, dead_nodes, fail_round, fault, topo, seed, device,
        group)
    step, rec = _swim_recorded("simulate_swim_curve", proto, n, rounds, step,
                               state, observers, group)
    per_round = []
    for _ in range(rounds):
        state = step(state)
        if counts is not None:
            per_round.append(torch.stack(counts(state)))
    RM.deliver(rec and rec.m)
    if counts is None:
        return np.zeros(rounds, np.float32), state
    table = torch.stack(per_round) if per_round else None
    if table is not None and group is not None:
        table = group.all_reduce_sum(table)
    table = table.cpu().tolist() if table is not None else []
    return np.asarray([SW.detection_quotient(c, p) for c, p in table],
                      np.float32), state


def simulate_swim_until(proto: ProtocolConfig, n: int, max_rounds: int,
                        target: float, dead_nodes=(), fail_round: int = 0,
                        fault: Optional[FaultConfig] = None,
                        topo: Optional[Topology] = None, seed: int = 0,
                        device=None, group=None):
    """SWIM rounds until the detection fraction reaches the float32
    ``target`` or ``max_rounds``, one host read a round.  Returns
    ``(rounds, detection, peak, final_state)``: ``peak`` is the best
    detection of the run (a rotating window's headline: the detection
    falls back once the window has left the dead node's epoch).  With a
    ``group``: as :func:`simulate_swim_curve`, the counts summed over the
    ranks every round."""
    step, state, counts, observers = _swim_setup(
        proto, n, max_rounds, dead_nodes, fail_round, fault, topo, seed,
        device, group)
    step, rec = _swim_recorded("simulate_swim_until", proto, n, max_rounds,
                               step, state, observers, group)

    def detection(s):
        c = torch.stack(counts(s))
        if group is not None:
            c = group.all_reduce_sum(c)
        return SW.detection_quotient(*c.tolist())

    tgt = np.float32(target)
    det = peak = 0.0
    while det < tgt and state.round < max_rounds:
        state = step(state)
        det = detection(state) if counts is not None else 0.0
        peak = max(peak, det)
    RM.deliver(rec and rec.m)
    return state.round, det, peak, state


def checkpointed_si(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                    path: str, every: int = 50,
                    fault: Optional[FaultConfig] = None, resume_state=None,
                    want_curve: bool = False, curve_prefix=(),
                    extra_meta=None, lost_prefix: float = 0.0, device=None,
                    stats=None):
    """The single-device SI run of ``run.max_rounds`` rounds in segments
    with a checkpoint every ``every`` rounds
    (:func:`~gossip_tpu_torch.utils.checkpoint.run_with_checkpoints`),
    the reference's ``run --checkpoint`` driver: from ``resume_state``
    (a loaded checkpoint) on, else from round 0.  Under a fault program
    the step reads its schedule at the absolute round and the destroyed
    messages persist as ``dropped`` (seed a resume with
    ``lost_prefix``); the coverage's denominator is the eventual alive
    set.  ``want_curve`` records the coverage after each round, as the
    reference's scan computes it.  Returns ``(final state, coverage,
    curve or None)``, the coverage eager."""
    from gossip_tpu_torch.utils.checkpoint import (on_device,
                                                   run_with_checkpoints)
    dev = topology_device(topo, device)
    step = make_si_round(proto, topo, fault, run.origin, dev)
    state = (on_device(resume_state, dev) if resume_state is not None
             else init_state(run, proto, topo.n, dev))
    alive = NE.metric_alive(fault, topo.n, run.origin, dev)
    kw = {}
    if want_curve:
        total = topo.n if alive is None else int(alive.sum())
        frac = (f32_mean if alive is None or NE.folded_denominator(fault)
                else f32_fraction)
        kw = dict(curve_fn=lambda s: least_count(s.seen, alive),
                  curve_value=lambda c: frac(int(c), total))
    out = run_with_checkpoints(
        step, state, max(0, run.max_rounds - state.round), path,
        every=every, extra_meta=extra_meta, curve_prefix=curve_prefix,
        track_lost=NE.get(fault) is not None, lost_prefix=lost_prefix,
        stats=stats, **kw)
    final, curve = out if want_curve else (out, None)
    return final, coverage(final.seen, alive), curve


def checkpointed_swim(proto: ProtocolConfig, n: int, run: RunConfig,
                      path: str, every: int = 50, dead_nodes=(),
                      fail_round: int = 0,
                      fault: Optional[FaultConfig] = None,
                      topo: Optional[Topology] = None, group=None,
                      resume_state=None, want_curve: bool = False,
                      curve_prefix=(), extra_meta=None, device=None,
                      stats=None):
    """SWIM for ``run.max_rounds`` rounds in checkpointed segments, the
    reference's: the tables are built for ``run.max_rounds`` (so a
    resume with a larger budget builds them for the new one), the
    rotating window is a function of the absolute round, and the curve
    is the detection of each round.  With a ``group`` this rank runs the
    sharded round (a resume takes its rows of the padded file,
    :func:`~gossip_tpu_torch.parallel.sharded_swim.restore_sharded_swim_state`)
    and the counts are summed over the ranks.  Returns ``(final state,
    detection, curve or None)``: the detection is the curve's last
    value, or without a curve that of the final state (0.0 at round
    0)."""
    from gossip_tpu_torch.utils.checkpoint import (on_device,
                                                   run_with_checkpoints)
    step, state, counts, _ = _swim_setup(proto, n, run.max_rounds, dead_nodes,
                                      fail_round, fault, topo, run.seed,
                                      device, group)
    if resume_state is not None:
        if group is None:
            state = on_device(resume_state, state.wire.device)
        else:
            from gossip_tpu_torch.parallel.sharded_swim import \
                restore_sharded_swim_state
            state = restore_sharded_swim_state(resume_state, group)

    def pairs(s):
        if counts is None:
            return torch.zeros(2, dtype=torch.int64, device=s.wire.device)
        return torch.stack(counts(s))

    reduce = None if group is None else group.all_reduce_sum
    kw = {}
    if want_curve:
        kw = dict(curve_fn=pairs, curve_reduce=reduce,
                  curve_value=lambda row: SW.detection_quotient(*row))
    out = run_with_checkpoints(
        step, state, max(0, run.max_rounds - state.round), path,
        every=every, extra_meta=extra_meta, curve_prefix=curve_prefix,
        group=group, stats=stats, **kw)
    final, curve = out if want_curve else (out, None)
    if curve:
        det = float(curve[-1])
    elif final.round:
        c = pairs(final)
        det = SW.detection_quotient(*(c if reduce is None
                                      else reduce(c)).tolist())
    else:
        det = 0.0
    return final, det, curve
