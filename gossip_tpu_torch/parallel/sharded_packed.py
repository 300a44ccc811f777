"""Node-dimension sharding of the bit-packed pull and anti-entropy rounds.

The port of the JAX package's ``parallel/sharded_packed.py``: the twin of
:mod:`gossip_tpu_torch.models.si_packed` over a
:class:`~gossip_tpu_torch.parallel.group.Group`.  Each rank holds its
``int32[nl, W]`` rows of packed words.  The round's one collective is the
all_gather of the packed visible table (``n_pad x W`` words: 40 MB a round
at N = 10M with 32 rumors), 8 times fewer bytes than the bool table's;
anti-entropy adds its reverse delta, a reduce-scatter of unpacked
``int32[n_pad, R]`` counts, on exchange rounds only.  Draws, liveness,
the fault program, the counters and the coverage rule are those of
:mod:`gossip_tpu_torch.parallel.sharded`.

:func:`checkpointed_packed_sharded` is the reference's checkpointed
multi-device SI driver: the packed rounds for a fixed number of rounds
in checkpointed segments, one file of the padded words for all ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import si as si_mod
from gossip_tpu_torch.models.si_packed import pull_merge_packed
from gossip_tpu_torch.models.state import SimState
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops.bitpack import (n_words, pack, rumor_count_tensor,
                                          unpack)
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.propagate import push_counts
from gossip_tpu_torch.ops.sampling import apply_drop
from gossip_tpu_torch.parallel.group import Group
from gossip_tpu_torch.parallel.sharded import (Coverage, SIRecorder, _Rows,
                                               exchange_bytes,
                                               init_sharded_state,
                                               instrumented,
                                               metric_alive_pad, run_until,
                                               sharded_folded)
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_packed_round(proto: ProtocolConfig, topo: Topology,
                              group: Group,
                              fault: Optional[FaultConfig] = None,
                              origin: int = 0,
                              schedule: Optional[NE.Schedule] = None,
                              chunks: int = 1):
    """This rank's packed pull / anti-entropy step on ``state.seen`` of
    shape ``[nl, W]`` (:func:`init_sharded_packed_state`): ``SimState ->
    SimState``, or under a fault program ``SimState -> (SimState, lost)``
    (:func:`~gossip_tpu_torch.parallel.sharded.make_sharded_si_round`).
    ``schedule`` (the program's tables over the padded rows) and
    ``chunks`` (pull on the complete graph: the rank's rows draw, pull
    and merge in that many chunks) are
    :func:`~gossip_tpu_torch.models.si_packed.make_packed_round`'s."""
    n, k = topo.n, proto.fanout
    mode = proto.mode
    if mode not in (C.PULL, C.ANTI_ENTROPY):
        raise ValueError("packed rounds support pull/antientropy only")
    if chunks < 1 or (chunks > 1 and (mode != C.PULL
                                       or not topo.implicit)):
        raise ValueError(f"chunks={chunks}: the rows split into chunks "
                         "in pull rounds on the complete graph only")
    NE.check_supported(fault, engine="si-packed")
    rows = _Rows(topo, group, fault, origin, schedule)
    churn = rows.sched is not None
    n_pad, gids = rows.n_pad, rows.gids
    dev = group.device
    mfac = 3.0 if mode == C.ANTI_ENTROPY else 2.0
    step_rows = -(-rows.nl // chunks)
    spans = [(lo, min(lo + step_rows, rows.nl))
             for lo in range(0, rows.nl, step_rows)]

    def step(state: SimState):
        nxt = state._replace(round=state.round + 1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if (mode == C.ANTI_ENTROPY and proto.period > 1
                and state.round % proto.period):
            # a quiescent round sends nothing, so it adds and loses nothing
            return (nxt, zero) if churn else nxt
        rkey = threefry.fold_in(state.key, state.round)
        alive_l, dp, cut = rows.at(state.round)
        packed = state.seen
        visible = torch.where(alive_l[:, None], packed, 0)
        packed_all = group.all_gather(visible)
        qkey = threefry.fold_in(rkey, si_mod.PULL_TAG)
        seen = None if len(spans) == 1 else torch.empty_like(packed)
        req = pre = post = 0
        for lo, hi in spans:
            ids, al = gids[lo:hi], alive_l[lo:hi]
            partners0 = rows.sample(qkey, topo, k, proto.exclude_self,
                                    slice(lo, hi))
            partners = apply_drop(rkey, si_mod.PULL_DROP_TAG, ids,
                                  partners0, dp, n, force=churn)
            if churn:
                partners = NE.partition_targets(cut, ids, partners, n)
            pulled = pull_merge_packed(packed_all, partners, n)
            partners = torch.where(al[:, None], partners, n)
            req = req + (partners < n).sum()
            if churn:
                # the nemesis's losses (NE.lost_count), counted in
                # integers across chunks
                pre = pre + ((partners0 < n) & al[:, None]).sum()
                post = post + ((partners < n) & al[:, None]).sum()
            if mode == C.ANTI_ENTROPY:
                # the reverse delta scatters bool contributions, adds them
                # across ranks (OR = count > 0) and packs them again
                back = push_counts(n_pad, torch.where(partners < n,
                                                      partners, n_pad),
                                   unpack(visible, proto.rumors))
                pulled = pulled | pack(group.reduce_scatter_sum(back) > 0)
            pulled = torch.where(al[:, None], pulled, 0)
            if seen is None:
                seen = packed | pulled
            else:
                torch.bitwise_or(packed[lo:hi], pulled, out=seen[lo:hi])
        lost = si_mod.f32(pre) - si_mod.f32(post) if churn else zero
        total, lost_all = group.combine_f32(
            torch.stack([mfac * si_mod.f32(req), lost]))
        out = nxt._replace(seen=seen, msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def init_sharded_packed_state(run: RunConfig, proto: ProtocolConfig,
                              topo: Topology, group: Group) -> SimState:
    """:func:`~gossip_tpu_torch.parallel.sharded.init_sharded_state` with
    this rank's rows packed to ``int32[nl, ceil(R / 32)]``."""
    st = init_sharded_state(run, proto, topo, group)
    return st._replace(seen=pack(st.seen))


def simulate_until_packed_sharded(proto: ProtocolConfig, topo: Topology,
                                  run: RunConfig, group: Group,
                                  fault: Optional[FaultConfig] = None):
    """The packed sharded while-loop to ``run.target_coverage`` or
    ``run.max_rounds``.  Returns ``(rounds, coverage, msgs,
    final_state)``; ``final_state`` holds this rank's words.  Under an
    active run ledger the loop records the reference's round metrics
    (its ``_packed_recorder``: the packed all_gather's ``4 * nl * W``
    bytes a round, anti-entropy's reverse count table on exchange
    rounds)."""
    state = init_sharded_packed_state(run, proto, topo, group)
    n_pad, nl, _ = group.rows(topo.n)
    step, rec = instrumented(
        make_sharded_packed_round(proto, topo, group, fault, run.origin),
        state, fault, lambda: SIRecorder(
            "simulate_until_packed_sharded", proto, topo.n, group, fault,
            run.origin, run.max_rounds, exchange_bytes(
                proto, 4.0 + 4.0 * nl * n_words(proto.rumors),
                4.0 * n_pad * proto.rumors), packed=True))
    cov = Coverage(fault, topo.n, run.origin, group, proto.rumors)
    out = run_until(step, state, cov, run)
    RM.deliver(rec and rec.m)
    return out


def sharded_checkpoint_ineligible_reason(proto: ProtocolConfig,
                                         exchange: str):
    """Why a multi-device SI run cannot take the checkpointed sharded
    driver, or None: the reference's list and words."""
    if exchange != "dense":
        return ("--checkpoint shards via the dense packed engine; "
                f"exchange={exchange!r} has no checkpointed driver")
    if proto.mode not in (C.PULL, C.ANTI_ENTROPY):
        return ("the sharded checkpointed driver runs the packed "
                f"pull/antientropy kernels (got mode {proto.mode!r})")
    return None


def restore_sharded_packed_state(state: SimState, group: Group) -> SimState:
    """This rank's words of a loaded checkpoint: the file holds the
    mesh-padded rows, so a resume on the same number of ranks (the
    configuration fingerprint refuses another) is bitwise."""
    from gossip_tpu_torch.utils.checkpoint import rank_share
    return rank_share(state, group)


def checkpointed_packed_sharded(proto: ProtocolConfig, topo: Topology,
                                run: RunConfig, group: Group, path: str,
                                every: int = 50,
                                fault: Optional[FaultConfig] = None,
                                resume_state: Optional[SimState] = None,
                                want_curve: bool = False, curve_prefix=(),
                                extra_meta=None, lost_prefix: float = 0.0,
                                stats=None):
    """This rank's share of a packed pull / anti-entropy run of
    ``run.max_rounds`` rounds in checkpointed segments
    (:func:`~gossip_tpu_torch.utils.checkpoint.run_with_checkpoints`):
    one file, the padded global words, written by rank 0.  Under a fault
    program the step reads its schedule at the absolute round, the
    destroyed messages persist as ``dropped`` and the denominator is the
    eventual alive set.  The curve is the reference's scan's (the
    division folded into a product with the reciprocal only over the
    plain node count,
    :func:`~gossip_tpu_torch.parallel.sharded.sharded_folded`).  Returns
    ``(final state, coverage, curve or None)``: this rank's words, the
    eager quotient."""
    from gossip_tpu_torch.utils.checkpoint import run_with_checkpoints
    step = make_sharded_packed_round(proto, topo, group, fault, run.origin)
    state = (restore_sharded_packed_state(resume_state, group)
             if resume_state is not None
             else init_sharded_packed_state(run, proto, topo, group))
    n_pad, nl, lo = group.rows(topo.n)
    alive = metric_alive_pad(fault, topo.n, n_pad, run.origin,
                             group.device)
    total = int(alive.sum())
    alive_l = alive[lo:lo + nl]

    def held(s):
        return rumor_count_tensor(s.seen, proto.rumors, alive_l)

    kw = {}
    if want_curve:
        frac = f32_mean if sharded_folded(fault) else f32_fraction
        kw = dict(curve_fn=held, curve_reduce=group.all_reduce_sum,
                  curve_value=lambda row: frac(int(min(row)), total))
    out = run_with_checkpoints(
        step, state, max(0, run.max_rounds - state.round), path,
        every=every, extra_meta=extra_meta, curve_prefix=curve_prefix,
        track_lost=NE.get(fault) is not None, lost_prefix=lost_prefix,
        group=group, stats=stats, **kw)
    final, curve = out if want_curve else (out, None)
    count = int(group.all_reduce_sum(held(final)).min())
    return final, f32_fraction(count, total), curve
