"""Rumor mongering: push gossip that stops (Demers et al.'s counter death).

The port of the JAX package's ``models/rumor.py`` on one device.  Each
(node, rumor) is susceptible, infective ("hot": still pushed) or removed
(known, no longer pushed).  A hot pair pushes to ``fanout`` peers a round
and counts its unnecessary contacts: ``feedback`` counts the pushes whose
recipient already knew the rumor, ``blind`` every push; at ``rumor_k``
the pair is removed.  A run ends when no pair is hot; its quality is the
residue, the share of nodes never informed.
:func:`checkpointed_rumor` runs a fixed number of rounds in
checkpointed segments, on one device or a group's rank.

One round: sample the hot senders' peers (threefry, the reference's tags
and keys), OR the hot payload into them, count the hits against the
round's starting knowledge, then remove the pairs at ``rumor_k`` and make
the new arrivals hot.  Static faults mask dead nodes (the origin pinned
alive) and drop pushes; under a fault program (``fault.churn``) the round
reads its alive rows, drop probability and cut from the schedule and
returns ``(state, lost)``, as the SI rounds do.  Every field of
:class:`RumorState` equals the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models.si import f32, round_schedule, topology_device
from gossip_tpu_torch.models.state import alive_mask, init_state
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.propagate import push_delta
from gossip_tpu_torch.ops.sampling import apply_drop, sample_peers
from gossip_tpu_torch.topology.generators import Topology

RUMOR_PUSH_TAG, RUMOR_DROP_TAG = 11, 12


class RumorState(NamedTuple):
    """The SIR state of every (node, rumor) pair."""

    seen: torch.Tensor       # bool[N, R]: informed (hot or removed)
    hot: torch.Tensor        # bool[N, R]: still pushed
    cnt: torch.Tensor        # int32[N, R]: unnecessary contacts
    round: int
    base_key: torch.Tensor   # int64[2]: the key's threefry words
    msgs: torch.Tensor       # float32 scalar: pushes sent


def init_rumor_state(run: RunConfig, proto: ProtocolConfig, n: int,
                     device=None) -> RumorState:
    """Rumor r starts hot at node ``(origin + r) % n``."""
    st = init_state(run, proto, n, device)
    return RumorState(seen=st.seen, hot=st.seen.clone(),
                      cnt=torch.zeros(st.seen.shape, dtype=torch.int32,
                                      device=st.seen.device),
                      round=0, base_key=st.key, msgs=st.msgs)


def make_rumor_round(proto: ProtocolConfig, topo: Topology,
                     fault: Optional[FaultConfig] = None, origin: int = 0,
                     device=None):
    """The single-device round on ``device`` (default: the topology's
    table's, or CUDA): ``RumorState -> RumorState``, or under a fault
    program ``RumorState -> (RumorState, lost)``.  The one-point case of
    :func:`make_rumor_round_batched`."""
    bstep = make_rumor_round_batched(proto, topo, fault, origin, device)

    def step(state: RumorState):
        out = bstep(RumorState(
            seen=state.seen[None], hot=state.hot[None], cnt=state.cnt[None],
            round=state.round, base_key=state.base_key[None],
            msgs=state.msgs[None]))
        out, lost = (out, None) if isinstance(out, RumorState) else out
        one = RumorState(seen=out.seen[0], hot=out.hot[0], cnt=out.cnt[0],
                         round=out.round, base_key=state.base_key,
                         msgs=out.msgs[0])
        return one if lost is None else (one, lost[0])

    return step


def make_rumor_round_batched(proto: ProtocolConfig, topo: Topology,
                             fault: Optional[FaultConfig] = None,
                             origin: int = 0, device=None):
    """The round of a batch of S seeds of one configuration on a leading
    axis (``seen``, ``hot``, ``cnt`` ``[S, N, R]``, ``base_key`` ``[S,
    2]``, ``msgs`` ``[S]``, the round shared); seed s's trajectory is the
    solo round's from its key, bit for bit, and under a program ``lost``
    is ``float32[S]``."""
    if proto.mode != C.RUMOR:
        raise ValueError(f"make_rumor_round builds mode='rumor' only "
                         f"(got {proto.mode!r})")
    n, k, kk = topo.n, proto.fanout, proto.rumor_k
    feedback = proto.rumor_variant == "feedback"
    NE.check_supported(fault, engine="rumor")
    dev = topology_device(topo, device)
    sched = round_schedule(fault, n, dev)
    churn = sched is not None
    drop_prob = 0.0 if fault is None else fault.drop_prob
    static_alive = (NE.base_alive_or_ones(fault, n, origin, dev) if churn
                    else alive_mask(fault, n, origin, dev))
    ids = torch.arange(n, dtype=torch.int64, device=dev)

    def step(state: RumorState):
        rkey = threefry.fold_in(state.base_key, state.round)[:, None]
        seen, hot, cnt = state.seen, state.hot, state.cnt
        if churn:
            # a node that is down loses its hot state, as a crash would;
            # what it has seen persists
            alive = NE.alive_rows(sched, static_alive, state.round)
            dp = NE.drop_at(sched, state.round)
        else:
            alive, dp = static_alive, drop_prob
        am = None if alive is None else alive[:, None]
        payload = hot if am is None else hot & am

        targets0 = sample_peers(threefry.fold_in(rkey, RUMOR_PUSH_TAG), ids,
                                topo, k, proto.exclude_self)
        targets = apply_drop(rkey, RUMOR_DROP_TAG, ids, targets0, dp, n,
                             force=churn)
        if churn:
            targets = NE.partition_targets(NE.cut_at(sched, state.round),
                                           ids, targets, n)
        sender_active = payload.any(dim=-1)
        valid = (targets < n) & sender_active[..., None]
        delta = push_delta(n, torch.where(valid, targets, n), payload)
        if am is not None:
            delta = delta & am                 # dead nodes receive nothing

        # hits against the round's starting knowledge
        if feedback:
            safe_t = torch.where(valid, targets, 0)
            pts = torch.arange(seen.shape[0], device=dev)[:, None, None]
            knew = seen[pts, safe_t] & valid[..., None]       # [S, N, k, R]
            hits = knew.sum(dim=-2, dtype=torch.int32)
        else:
            hits = valid.sum(dim=-1, dtype=torch.int32)[..., None]
        cnt = cnt + torch.where(payload, hits, 0)

        # removal, and the new arrivals become hot (a dead node holds no
        # hot pair, or the run would never end)
        hot = (hot & (cnt < kk)) | (delta & ~seen)
        if am is not None:
            hot = hot & am
        out = RumorState(seen=seen | delta, hot=hot, cnt=cnt,
                         round=state.round + 1, base_key=state.base_key,
                         msgs=state.msgs + f32(valid.sum(dim=(-2, -1))))
        if churn:
            return out, NE.lost_count(targets0, targets, sender_active, n)
        return out

    return step


def rumor_coverage(seen: torch.Tensor, alive: Optional[torch.Tensor] = None,
                   folded: bool = False) -> float:
    """The worst rumor's informed fraction of the (alive) nodes, in the
    reference's float32: without ``alive`` a mean (the count times
    ``float32(1 / n)``), with it a quotient, or with ``folded`` (a
    denominator the reference's compiled loop holds as a constant) the
    product with its reciprocal."""
    if alive is None:
        return f32_mean(int(seen.sum(dim=0).min()), seen.shape[0])
    counts = (seen & alive[:, None]).sum(dim=0)
    frac = f32_mean if folded else f32_fraction
    return frac(int(counts.min()), int(alive.sum()))


def hot_fraction(hot: torch.Tensor, alive: Optional[torch.Tensor] = None,
                 folded: bool = False) -> float:
    """The share of (alive) nodes holding a hot pair, in the float32 of
    :func:`rumor_coverage`."""
    hot_any = hot.any(dim=1)
    if alive is None:
        return f32_mean(int(hot_any.sum()), hot.shape[0])
    frac = f32_mean if folded else f32_fraction
    return frac(int((hot_any & alive).sum()), int(alive.sum()))


def _build(proto, topo, run, fault, device):
    dev = topology_device(topo, device)
    step = NE.drop_lost(make_rumor_round(proto, topo, fault, run.origin,
                                         dev), NE.get(fault))
    return step, init_rumor_state(run, proto, topo.n, dev), \
        NE.metric_alive(fault, topo.n, run.origin, dev)


def simulate_until_rumor(proto: ProtocolConfig, topo: Topology,
                         run: RunConfig,
                         fault: Optional[FaultConfig] = None, device=None):
    """Rounds until no pair is hot or ``run.max_rounds``, one host read a
    round.  Returns ``(rounds, coverage, residue, msgs, final_state)``:
    the coverage of the (eventual) alive set, the reference's eager one,
    and ``residue = 1 - coverage``."""
    step, state, alive = _build(proto, topo, run, fault, device)
    while bool(state.hot.any()) and state.round < run.max_rounds:
        state = step(state)
    cov = rumor_coverage(state.seen, alive)
    return state.round, cov, 1.0 - cov, float(state.msgs.item()), state


def simulate_curve_rumor(proto: ProtocolConfig, topo: Topology,
                         run: RunConfig,
                         fault: Optional[FaultConfig] = None, device=None):
    """Exactly ``run.max_rounds`` rounds.  Returns float32 arrays of the
    coverage, the hot fraction and msgs after each round, as the
    reference's scan computes them, and the final state."""
    step, state, alive = _build(proto, topo, run, fault, device)
    folded = NE.folded_denominator(fault)
    covs, hots, msgs = [], [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(rumor_coverage(state.seen, alive, folded))
        hots.append(hot_fraction(state.hot, alive, folded))
        msgs.append(state.msgs)
    return (np.asarray(covs, np.float32), np.asarray(hots, np.float32),
            np.asarray([m.item() for m in msgs], np.float32), state)


def checkpointed_rumor(proto: ProtocolConfig, topo: Topology,
                       run: RunConfig, path: str, every: int = 50,
                       fault: Optional[FaultConfig] = None, group=None,
                       resume_state=None, want_curve: bool = False,
                       curve_prefix=(), extra_meta=None,
                       lost_prefix: float = 0.0, device=None, stats=None):
    """Rumor mongering for ``run.max_rounds`` rounds in checkpointed
    segments (:func:`~gossip_tpu_torch.utils.checkpoint.run_with_checkpoints`),
    the reference's: the segments are fixed, so the run does not stop at
    extinction (the extinct state is absorbing).  ``want_curve`` records
    two named channels a round, ``coverage`` and ``hot`` (the extinction
    round is only recoverable from the second).  Under a fault program
    the destroyed messages persist as ``dropped`` (seed a resume with
    ``lost_prefix``) and the denominator is the eventual alive set.
    With a ``group`` this rank runs the sharded round on its rows (a
    resume takes its slice of the padded file).  Returns ``(final state,
    coverage, residue, curve or None)``, the coverage eager.

    The channels divide as the reference's scan does: by a denominator
    it folds into a product with the float32 reciprocal where its alive
    set is a constant of the trace (one device without random deaths;
    on a mesh only the plain node count,
    :func:`~gossip_tpu_torch.parallel.sharded.sharded_folded`), by the
    true quotient elsewhere."""
    from gossip_tpu_torch.utils.checkpoint import (on_device,
                                                   run_with_checkpoints)
    if group is None:
        dev = topology_device(topo, device)
        step = make_rumor_round(proto, topo, fault, run.origin, dev)
        state = (on_device(resume_state, dev) if resume_state is not None
                 else init_rumor_state(run, proto, topo.n, dev))
        alive = NE.metric_alive(fault, topo.n, run.origin, dev)
        total = topo.n if alive is None else int(alive.sum())
        reduce = None

        def local(s):
            seen, hot = s.seen, s.hot.any(dim=1)
            if alive is not None:
                seen, hot = seen & alive[:, None], hot & alive
            return torch.cat([seen.sum(dim=0), hot.sum()[None]])
    else:
        from gossip_tpu_torch.parallel import sharded_rumor as SR
        step = SR.make_sharded_rumor_round(proto, topo, group, fault,
                                           run.origin)
        state = (SR.restore_sharded_rumor_state(resume_state, group)
                 if resume_state is not None
                 else SR.init_sharded_rumor_state(run, proto, topo, group))
        counts = SR._Counts(fault, topo.n, run.origin, group)
        total, local, reduce = (counts.total, counts.local,
                                group.all_reduce_sum)
    if group is None:
        folded = alive is None or NE.folded_denominator(fault)
    else:
        from gossip_tpu_torch.parallel.sharded import sharded_folded
        folded = sharded_folded(fault)
    frac = f32_mean if folded else f32_fraction
    kw = {}
    if want_curve:
        kw = dict(curve_fn=local, curve_reduce=reduce,
                  curve_value=lambda row: {
                      "coverage": frac(int(min(row[:-1])), total),
                      "hot": frac(int(row[-1]), total)})
    out = run_with_checkpoints(
        step, state, max(0, run.max_rounds - state.round), path,
        every=every, extra_meta=extra_meta, curve_prefix=curve_prefix,
        track_lost=NE.get(fault) is not None, lost_prefix=lost_prefix,
        group=group, stats=stats, **kw)
    final, curve = out if want_curve else (out, None)
    held = local(final)
    if reduce is not None:
        held = reduce(held)
    # eager: a mean without an alive set, else the quotient
    eager = f32_mean if group is None and alive is None else f32_fraction
    cov = eager(int(held[:-1].min()), total)
    return final, cov, 1.0 - cov, curve
