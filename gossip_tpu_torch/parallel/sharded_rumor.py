"""Node-dimension sharding of rumor mongering (the SIR rounds).

The port of the JAX package's ``parallel/sharded_rumor.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`: semantically
:func:`~gossip_tpu_torch.models.rumor.make_rumor_round` on the ``[nl,
R]`` rows of the rank's global ids (``seen``, ``hot``, ``cnt``), every
draw keyed by the global id.  A round's collectives:

* **deliveries**: each rank counts its hot senders' pushes into an
  ``int32[n_pad, R]`` table
  (:func:`~gossip_tpu_torch.ops.propagate.push_counts`, invalid targets
  aimed at ``n_pad`` and cut off), which a reduce-scatter brings to the
  owning rank; ``counts > 0`` is the OR;
* **feedback's counters**: the *round-start* ``seen`` of every rank,
  all-gathered before any update, tells whether a push's recipient
  already knew the rumor (blind counts every push and gathers nothing);
* **counters**: the ranks' float32 ``msgs`` and ``lost`` partials added
  in rank order (:meth:`Group.combine_f32`); the loops' coverage and
  hot counts are integer sums (:meth:`Group.all_reduce_sum`).

Padding rows are dead: they never push, receive or hold a hot pair, and
no coverage counts them, so the coverage is always the alive-weighted
quotient.  The reference's compiled scan multiplies by the float32
reciprocal of the alive count where that set is every real node (no
deaths, no fault program:
:func:`~gossip_tpu_torch.parallel.sharded.sharded_folded`), and divides
otherwise; the reports' coverage is the eager quotient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models.rumor import (RUMOR_DROP_TAG, RUMOR_PUSH_TAG,
                                           RumorState)
from gossip_tpu_torch.models.si import f32
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.propagate import push_counts
from gossip_tpu_torch.ops.sampling import apply_drop
from gossip_tpu_torch.parallel.group import Group
from gossip_tpu_torch.parallel.sharded import (SIRecorder, _Rows,
                                               init_sharded_state,
                                               instrumented,
                                               metric_alive_pad,
                                               sharded_folded)
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_rumor_round(proto: ProtocolConfig, topo: Topology,
                             group: Group,
                             fault: Optional[FaultConfig] = None,
                             origin: int = 0):
    """The sharded round step of this rank: ``RumorState ->
    RumorState`` on the rank's rows (:func:`init_sharded_rumor_state`),
    or under a fault program ``RumorState -> (RumorState, lost)`` with
    ``lost`` the float32 total over ranks.  Feedback and blind, with the
    nemesis."""
    if proto.mode != C.RUMOR:
        raise ValueError(f"make_sharded_rumor_round builds mode='rumor' "
                         f"only (got {proto.mode!r})")
    n, k, kk = topo.n, proto.fanout, proto.rumor_k
    feedback = proto.rumor_variant == "feedback"
    NE.check_supported(fault, engine="rumor")
    rows = _Rows(topo, group, fault, origin)
    churn = rows.sched is not None
    n_pad, gids = rows.n_pad, rows.gids

    def step(state: RumorState):
        rkey = threefry.fold_in(state.base_key, state.round)
        alive_l, dp, cut = rows.at(state.round)
        seen, hot, cnt = state.seen, state.hot, state.cnt
        payload = hot & alive_l[:, None]

        targets0 = rows.sample(threefry.fold_in(rkey, RUMOR_PUSH_TAG), topo,
                               k, proto.exclude_self)
        targets = apply_drop(rkey, RUMOR_DROP_TAG, gids, targets0, dp, n,
                             force=churn)
        if churn:
            targets = NE.partition_targets(cut, gids, targets, n)
        sender_active = payload.any(dim=1)
        valid = (targets < n) & sender_active[:, None]

        # deliveries: the hot payload's counts, reduce-scattered
        counts = push_counts(n_pad, torch.where(valid, targets, n_pad),
                             payload)
        delta = (group.reduce_scatter_sum(counts) > 0) & alive_l[:, None]

        # hits against the round-start knowledge of every rank
        if feedback:
            seen_all = group.all_gather(seen)
            safe_t = torch.where(valid, targets, 0)
            knew = seen_all[safe_t] & valid[:, :, None]          # [nl, k, R]
            hits = knew.sum(dim=1, dtype=torch.int32)
        else:
            hits = valid.sum(dim=1, dtype=torch.int32)[:, None]
        cnt = cnt + torch.where(payload, hits, 0)

        # removal, and the new arrivals become hot (a dead node holds no
        # hot pair, or the run would never end)
        hot = ((hot & (cnt < kk)) | (delta & ~seen)) & alive_l[:, None]
        lost = (NE.lost_count(targets0, targets, sender_active, n) if churn
                else torch.zeros((), dtype=torch.float32,
                                 device=group.device))
        total, lost_all = group.combine_f32(torch.stack(
            [f32(valid.sum()), lost]))
        out = RumorState(seen=seen | delta, hot=hot, cnt=cnt,
                         round=state.round + 1, base_key=state.base_key,
                         msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def init_sharded_rumor_state(run: RunConfig, proto: ProtocolConfig,
                             topo: Topology, group: Group) -> RumorState:
    """This rank's rows of the initial state: rumor r starts hot at node
    ``(origin + r) % n``."""
    st = init_sharded_state(run, proto, topo, group)
    return RumorState(seen=st.seen, hot=st.seen.clone(),
                      cnt=torch.zeros(st.seen.shape, dtype=torch.int32,
                                      device=st.seen.device),
                      round=0, base_key=st.key, msgs=st.msgs)


class _Counts:
    """The integer counts the loops read, summed over the ranks: the
    least-informed rumor's holders and the nodes holding a hot pair,
    among this rank's alive rows (the coverage's alive set: the static
    mask, or under a program the eventual alive set, padding rows
    dead)."""

    def __init__(self, fault, n: int, origin: int, group: Group):
        n_pad, nl, lo = group.rows(n)
        alive = metric_alive_pad(fault, n, n_pad, origin, group.device)
        self.alive_l = alive[lo:lo + nl]
        self.total = int(alive.sum())
        self.group = group

    def local(self, state: RumorState) -> torch.Tensor:
        """int64[R + 1]: this rank's per-rumor holders, then its nodes
        holding a hot pair."""
        a = self.alive_l[:, None]
        held = (state.seen & a).sum(dim=0)
        hot = (state.hot.any(dim=1) & self.alive_l).sum()[None]
        return torch.cat([held, hot]).to(torch.int64)


class RumorRecorder(SIRecorder):
    """The reference's ``_rumor_recorder``: the SI row plus the hit
    counters' growth (``contacts``), which is ``dup`` itself for the
    feedback variant (the counter grows by exactly the contacts whose
    recipient already knew) and ``contacts - newly`` for blind; the
    bytes are the count table's reduce-scatter, feedback's seen
    all_gather and the msgs sum."""

    def __init__(self, label: str, proto: ProtocolConfig, n: int,
                 group: Group, fault, origin: int, max_rounds: int):
        n_pad, nl, _ = group.rows(n)
        r = proto.rumors
        self.feedback = proto.rumor_variant == "feedback"
        b = 4.0 * n_pad * r + (1.0 * nl * r if self.feedback else 0.0) + 4.0
        super().__init__(label, proto, n, group, fault, origin, max_rounds,
                         lambda round_: b)

    def _hits(self, state: RumorState) -> torch.Tensor:
        return torch.where(self.alive_l[:, None], state.cnt, 0).sum()

    def start(self, state: RumorState) -> None:
        self.prev = RM.count_bool(state.seen, self.alive_l)
        self.prev_hits = self._hits(state)

    def __call__(self, s0: RumorState, s1: RumorState, lost=None) -> None:
        count = RM.count_bool(s1.seen, self.alive_l)
        hits = self._hits(s1)
        RM.record(self.m, newly=count - self.prev, msgs=s1.msgs - s0.msgs,
                  contacts=hits - self.prev_hits,
                  contacts_exact=self.feedback,
                  bytes=self.bytes_of(s0.round),
                  front=RM.front_bool(s1.seen, self.alive_l),
                  **self.nemesis(s0, lost))
        self.prev, self.prev_hits = count, hits


def _rumor_step(label, proto, topo, run, group, fault, state):
    return instrumented(
        make_sharded_rumor_round(proto, topo, group, fault, run.origin),
        state, fault, lambda: RumorRecorder(label, proto, topo.n, group,
                                            fault, run.origin,
                                            run.max_rounds))


def simulate_until_rumor_sharded(proto: ProtocolConfig, topo: Topology,
                                 run: RunConfig, group: Group,
                                 fault: Optional[FaultConfig] = None):
    """The sharded loop until no pair is hot anywhere or
    ``run.max_rounds``, one summed count a round.  Returns ``(rounds,
    coverage, residue, msgs, final_state)``: the coverage of the
    (eventual) alive set, the reference's eager quotient, and
    ``residue = 1 - coverage``; ``final_state`` holds this rank's rows."""
    state = init_sharded_rumor_state(run, proto, topo, group)
    step, rec = _rumor_step("simulate_until_rumor_sharded", proto, topo, run,
                            group, fault, state)
    counts = _Counts(fault, topo.n, run.origin, group)

    def any_hot(s):
        return int(group.all_reduce_sum(s.hot.any(dim=1).sum()
                                        .to(torch.int64)[None])[0]) > 0

    while any_hot(state) and state.round < run.max_rounds:
        state = step(state)
    held = group.all_reduce_sum(counts.local(state))[:-1]
    cov = f32_fraction(int(held.min()), counts.total)
    RM.deliver(rec and rec.m)
    return (state.round, cov, 1.0 - cov, float(state.msgs.item()), state)


def simulate_curve_rumor_sharded(proto: ProtocolConfig, topo: Topology,
                                 run: RunConfig, group: Group,
                                 fault: Optional[FaultConfig] = None):
    """Exactly ``run.max_rounds`` sharded rounds.  Returns float32 arrays
    of the coverage, the hot fraction and msgs after each round, as the
    reference's scan computes them (the counts summed over the ranks
    once, at the end), and this rank's final state."""
    state = init_sharded_rumor_state(run, proto, topo, group)
    step, rec = _rumor_step("simulate_curve_rumor_sharded", proto, topo, run,
                            group, fault, state)
    counts = _Counts(fault, topo.n, run.origin, group)
    frac = f32_mean if sharded_folded(fault) else f32_fraction
    per_round, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        per_round.append(counts.local(state))
        msgs.append(state.msgs)
    RM.deliver(rec and rec.m)
    table = group.all_reduce_sum(torch.stack(per_round)).cpu().tolist()
    covs = [frac(min(row[:-1]), counts.total) for row in table]
    hots = [frac(row[-1], counts.total) for row in table]
    return (np.asarray(covs, np.float32), np.asarray(hots, np.float32),
            np.asarray([m.item() for m in msgs], np.float32), state)


def restore_sharded_rumor_state(state: RumorState,
                                group: Group) -> RumorState:
    """This rank's rows of a loaded checkpoint (the padded rows, as in
    ``parallel.sharded_swim.restore_sharded_swim_state``)."""
    from gossip_tpu_torch.utils.checkpoint import rank_share
    return rank_share(state, group)
