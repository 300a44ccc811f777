"""SI-family rounds of the XLA engine: push, pull, push-pull, flood and
anti-entropy, on bool state.

The port of the JAX package's ``models/si.py``.  One round is a function
``SimState -> SimState``; its draws are the reference's threefry draws
(same tags, same per-node keys), so ``seen``, ``round`` and ``msgs`` equal
the reference's bit for bit.  ``msgs`` is a float32 scalar that grows in
the reference's order, one float32 add per term.

Static faults: ``node_death_rate`` kills a static set (dead nodes neither
send, answer nor receive); ``drop_prob`` drops each (sender, target) use
per round.  Anti-entropy with ``period > 1`` exchanges on rounds that are
a multiple of the period and is quiescent on the others: the port draws
nothing on a quiescent round, where the reference draws and masks it
all, with the same result.

The step is the one-point case of :func:`make_si_round_batched`, which
runs S points of one configuration on a leading batch axis (the
ensembles and the churn sweep, :mod:`gossip_tpu_torch.parallel.sweep`).

Under a fault program (``fault.churn``, lowered by
:mod:`gossip_tpu_torch.ops.nemesis`) the step reads the round's
liveness, drop probability and partition cut from the schedule's tables,
always draws its drop coins, sends cross-cut targets to the sentinel, and
returns ``(state, lost)``: ``lost`` is the float32 count of messages the
coins and the cut destroyed (0 on a quiescent anti-entropy round).
"""

from __future__ import annotations

from typing import Optional

import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig
from gossip_tpu_torch.models.state import SimState, alive_mask
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import (f32_fraction, f32_mean,
                                         resolve_device)
from gossip_tpu_torch.ops.propagate import (flood_gather, pull_merge,
                                            push_delta)
from gossip_tpu_torch.ops.sampling import apply_drop, drop_mask, sample_peers
from gossip_tpu_torch.topology.generators import Topology

# Sub-key tags, so push and pull draws of one round are independent.
PUSH_TAG, PULL_TAG, PUSH_DROP_TAG, PULL_DROP_TAG, FLOOD_DROP_TAG = (
    1, 2, 3, 4, 5)


def topology_device(topo: Topology, device=None) -> torch.device:
    """The device a run on ``topo`` uses: the table's, unless the caller
    names one (which must then hold the table)."""
    if topo.nbrs is not None:
        dev = topo.nbrs.device
        want = None if device is None else torch.device(device)
        # a device without an index ("cuda") names the current one
        if want is not None and (want.type != dev.type or (
                want.index is not None and want.index != dev.index)):
            raise ValueError(f"the topology's table is on {dev}, not "
                             f"{device}")
        return dev
    return resolve_device(device)


def f32(x) -> torch.Tensor:
    """A count as float32 (int32/int64 to float32 rounds to nearest, as
    the reference's ``astype(float32)``)."""
    return x.to(torch.float32)


def round_schedule(fault: Optional[FaultConfig], n: int, dev,
                   schedule: Optional[NE.Schedule] = None):
    """The schedule a step runs under: ``schedule`` if given (any
    :func:`~gossip_tpu_torch.ops.nemesis.build_or_static` output), else
    the lowering of ``fault.churn``, else None (the static path)."""
    if schedule is not None:
        if schedule.die.shape[0] != n or schedule.die.device != dev:
            raise ValueError(f"the schedule holds {schedule.die.shape[0]} "
                             f"rows on {schedule.die.device}, the round "
                             f"{n} on {dev}")
        return schedule
    if NE.get(fault) is not None:
        return NE.build(fault, n, device=dev)
    return None


def make_si_round(proto: ProtocolConfig, topo: Topology,
                  fault: Optional[FaultConfig] = None, origin: int = 0,
                  device=None, schedule: Optional[NE.Schedule] = None):
    """The single-device round step on ``device`` (default: the
    topology's table's, or CUDA): ``SimState -> SimState``, or under a
    schedule (``fault.churn``, or ``schedule``) ``SimState -> (SimState,
    lost)``.  The one-point case of :func:`make_si_round_batched`."""
    bstep = make_si_round_batched(proto, topo, fault, origin, device,
                                  schedule)

    def step(state: SimState):
        out = bstep(SimState(seen=state.seen[None], round=state.round,
                             key=state.key[None], msgs=state.msgs[None]))
        out, lost = (out, None) if isinstance(out, SimState) else out
        one = SimState(seen=out.seen[0], round=out.round, key=state.key,
                       msgs=out.msgs[0])
        return one if lost is None else (one, lost[0])

    return step


def _per_point(x, dims: int):
    """A per-point value (a float, a 0-d tensor, or one a point ``[S]``)
    shaped to broadcast against ``[S, ...]`` of ``dims`` axes."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * (dims - 1))
    return x


def make_si_round_batched(proto: ProtocolConfig, topo: Topology,
                          fault: Optional[FaultConfig] = None,
                          origin: int = 0, device=None,
                          schedule: Optional[NE.Schedule] = None):
    """The round step of a batch of S points of one configuration, on a
    leading axis: ``seen`` ``bool[S, N, R]``, ``key`` ``int64[S, 2]`` (a
    seed a point), ``msgs`` ``float32[S]``, and the round shared.  Point
    s's trajectory is the solo step's from its key, bit for bit: its
    draws are keyed ``fold_in(fold_in(key_s, round), node)`` as the solo
    draws are, and its push scatter counts into its own block of one
    table (:func:`~gossip_tpu_torch.ops.propagate.push_counts`).

    ``schedule`` may be a stacked one
    (:func:`~gossip_tpu_torch.ops.nemesis.build_stack`, die/rec ``[S,
    N]``): point s then runs scenario s, its liveness, drop probability
    and cut its own, and ``lost`` is ``float32[S]``."""
    n, k = topo.n, proto.fanout
    mode = proto.mode
    if mode == C.SWIM:
        raise ValueError("SWIM rounds are built by models/swim.py")
    if mode == C.RUMOR:
        raise ValueError("rumor-mongering rounds are built by "
                         "models/rumor.py (SIR state, not SI)")
    if mode == C.FLOOD and topo.implicit:
        raise ValueError("flood mode needs an explicit neighbor table")
    NE.check_supported(fault, engine="si-xla")
    dev = topology_device(topo, device)
    if schedule is not None and schedule.die.dim() == 2:
        on = schedule.die.device
        if schedule.die.shape[1] != n or on.type != dev.type or (
                dev.index is not None and on.index != dev.index):
            raise ValueError(f"the schedule holds {schedule.die.shape[1]} "
                             f"rows on {schedule.die.device}, the round "
                             f"{n} on {dev}")
        sched = schedule
    else:
        sched = round_schedule(fault, n, dev, schedule)
    churn = sched is not None
    drop_prob = 0.0 if fault is None else fault.drop_prob
    # the static mask; under a schedule always a tensor, which each
    # round's down nodes are taken out of
    base_alive = (NE.base_alive_or_ones(fault, n, origin, dev) if churn
                  else alive_mask(fault, n, origin, dev))
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    nbrs_t = None if topo.implicit else topo.nbrs.to(torch.int64)

    def cut_off(cut, targets):
        """Targets across the point's open cut become the sentinel."""
        return NE.partition_targets(_per_point(cut, 3), ids, targets, n)

    def step(state: SimState):
        rkey = threefry.fold_in(state.key, state.round)[:, None]
        seen = state.seen
        if churn:
            alive = NE.alive_rows(sched, base_alive, state.round)
            dp = _per_point(NE.drop_at(sched, state.round), 3)
            cut = NE.cut_at(sched, state.round)
        else:
            alive, dp = base_alive, drop_prob
        lost = torch.zeros(seen.shape[0], dtype=torch.float32, device=dev)
        am = None if alive is None else alive[..., None]
        visible = seen if am is None else seen & am
        delta = torch.zeros_like(seen)
        msgs = state.msgs

        if mode in (C.PUSH, C.PUSH_PULL):
            pkey = threefry.fold_in(rkey, PUSH_TAG)
            targets0 = sample_peers(pkey, ids, topo, k, proto.exclude_self)
            targets = apply_drop(rkey, PUSH_DROP_TAG, ids, targets0, dp, n,
                                 force=churn)
            if churn:
                targets = cut_off(cut, targets)
            sender_active = visible.any(dim=-1)
            valid = (targets < n) & sender_active[..., None]
            delta = delta | push_delta(n, torch.where(valid, targets, n),
                                       visible)
            msgs = msgs + f32(valid.sum(dim=(-2, -1)))
            if churn:
                lost = lost + NE.lost_count(targets0, targets,
                                            sender_active, n)

        exchange = (mode != C.ANTI_ENTROPY or proto.period <= 1
                    or state.round % proto.period == 0)
        if mode in (C.PULL, C.PUSH_PULL, C.ANTI_ENTROPY) and exchange:
            qkey = threefry.fold_in(rkey, PULL_TAG)
            partners0 = sample_peers(qkey, ids, topo, k, proto.exclude_self)
            partners = apply_drop(rkey, PULL_DROP_TAG, ids, partners0, dp,
                                  n, force=churn)
            if churn:
                partners = cut_off(cut, partners)
            pulled = pull_merge(visible, partners, n)
            if am is not None:        # dead nodes neither ask nor receive
                partners = torch.where(am, partners, n)
            n_req = f32((partners < n).sum(dim=(-2, -1)))
            if churn:
                lost = lost + NE.lost_count(partners0, partners, alive, n)
            if mode == C.ANTI_ENTROPY:
                # both directions: request, digest, reverse delta
                back = push_delta(n, partners, visible)
                delta = delta | pulled | back
                msgs = msgs + 3.0 * n_req
            else:
                delta = delta | pulled
                msgs = msgs + 2.0 * n_req     # request + digest response

        if mode == C.FLOOD:
            nbrs = nbrs_t
            if churn or drop_prob > 0.0:
                dropped = drop_mask(rkey, FLOOD_DROP_TAG, ids,
                                    nbrs.shape[1], dp)
                nbrs = torch.where(dropped, n, nbrs)
            sender_active = visible.any(dim=-1)
            if churn:
                nbrs = cut_off(cut, nbrs)
                # lost edge uses whose sender (the neighbour the gather
                # reads from) had something to say
                live = (nbrs_t < n) & sender_active[
                    ..., torch.clamp(nbrs_t, 0, n - 1)]
                lost = lost + f32((live & (nbrs >= n)).sum(dim=(-2, -1)))
            delta = flood_gather(visible, nbrs, n)
            msgs = msgs + f32(torch.where(sender_active, topo.deg,
                                          0).sum(dim=-1))

        if am is not None:
            delta = delta & am             # dead nodes receive nothing
        out = SimState(seen=seen | delta, round=state.round + 1,
                       key=state.key, msgs=msgs)
        return (out, lost) if churn else out

    return step


def least_count(seen: torch.Tensor,
                alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The holders of the least-held rumor (alive nodes only, with
    ``alive``), an int64 0-d tensor on the device (no host read)."""
    if alive is not None:
        seen = seen & alive[:, None]
    return seen.sum(dim=0).min()


def coverage_count(seen: torch.Tensor,
                   alive: Optional[torch.Tensor] = None):
    """``(count, total)``: the exact holders of the least-held rumor
    (alive nodes only, with ``alive``) and the nodes counted."""
    total = seen.shape[0] if alive is None else int(alive.sum())
    return int(least_count(seen, alive)), total


def coverage(seen: torch.Tensor, alive: Optional[torch.Tensor] = None,
             folded: bool = False) -> float:
    """Min-over-rumors fraction of (alive) nodes holding each rumor, in
    the reference's float32 rounding (:mod:`gossip_tpu_torch.ops.bitpack`
    module doc); ``folded``: the alive count is a constant of the
    reference's compiled loop, which multiplies by its reciprocal
    (:func:`~gossip_tpu_torch.ops.nemesis.folded_denominator`)."""
    count, total = coverage_count(seen, alive)
    frac = f32_mean if alive is None or folded else f32_fraction
    return frac(count, total)
