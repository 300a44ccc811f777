"""Bit-packed pull and anti-entropy rounds: the XLA engine's fast path.

The port of the JAX package's ``models/si_packed.py``, with its fault
programs (:mod:`gossip_tpu_torch.models.si` module doc).
``seen`` is packed 32 rumors to a word (:mod:`gossip_tpu_torch.ops.bitpack`),
so a pull moves one word per partner.  The semantics are exactly
:mod:`gossip_tpu_torch.models.si`'s pull and anti-entropy modes (same
tags, same per-node keys, same message accounting), bitwise.  Push modes
are refused, as in the reference; anti-entropy's reverse delta unpacks to
bools for the scatter and packs again, on exchange rounds only.

``sampler``: ``"threefry"`` (default, the reference's stream) or
``"kernel"`` (the reference's ``"pallas"``): partners from the sampling
kernel ``csrc/sampler.cu`` (:mod:`gossip_tpu_torch.ops.fast_sampling`), a
Philox stream of its own, on the implicit complete graph only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import si as si_mod
from gossip_tpu_torch.models.state import SimState, alive_mask, init_state
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.bitpack import coverage_packed, pack, unpack
from gossip_tpu_torch.ops.fast_sampling import sample_peers_fast
from gossip_tpu_torch.ops.propagate import push_delta
from gossip_tpu_torch.ops.sampling import apply_drop, sample_peers
from gossip_tpu_torch.topology.generators import Topology

SAMPLERS = ("threefry", "kernel")


def init_packed_state(run: RunConfig, proto: ProtocolConfig, n: int,
                      device=None) -> SimState:
    """:func:`init_state` with ``seen`` packed to int32[N, ceil(R/32)]."""
    st = init_state(run, proto, n, device)
    return st._replace(seen=pack(st.seen))


def pull_merge_packed(packed_all: torch.Tensor, partners: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """int32[N, W]: the OR of the k sampled peers' words; sentinel
    entries pull nothing."""
    valid = partners < sentinel
    safe = torch.clamp(partners, max=sentinel - 1).to(torch.int64)
    got = torch.where(valid[:, :, None], packed_all[safe], 0)
    out = got[:, 0, :]
    for j in range(1, got.shape[1]):
        out = out | got[:, j, :]
    return out


def make_packed_round(proto: ProtocolConfig, topo: Topology,
                      fault: Optional[FaultConfig] = None, origin: int = 0,
                      sampler: str = "threefry", sampler_seed: int = 0,
                      device=None, schedule: Optional[NE.Schedule] = None,
                      chunks: int = 1):
    """Packed pull / anti-entropy round step on ``device`` (default: the
    topology's table's, or CUDA): ``SimState -> SimState``, or under a
    schedule (``fault.churn``, or ``schedule``) ``SimState -> (SimState,
    lost)``, as :func:`gossip_tpu_torch.models.si.make_si_round`.  Under
    a schedule the kernel sampler draws the partners and the threefry
    coin, the cut and the alive rows act on them, as the reference's
    ``sampler="pallas"`` branch does.  The step reads ``schedule``'s
    tensors when it runs, so new content copied into them in place is
    the next round's program.

    ``chunks`` (pull on the complete graph with the threefry sampler):
    the rows draw, pull and
    merge in that many node chunks, so the draw's transient tensors are
    a chunk's, not the table's.  Every draw is keyed by its node's id,
    so the trajectory is bitwise the one-chunk round's; the counts add
    in integers and round to float32 once."""
    n, k = topo.n, proto.fanout
    mode = proto.mode
    if mode not in (C.PULL, C.ANTI_ENTROPY):
        raise ValueError(
            f"packed rounds support pull/antientropy only, got {mode!r} "
            "(the push half needs a scatter-OR; use models/si.py)")
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; choose from "
                         f"{SAMPLERS}")
    if sampler == "kernel" and not topo.implicit:
        raise ValueError("the kernel sampler draws on the implicit "
                         "complete graph only")
    if chunks < 1 or (chunks > 1 and (mode != C.PULL or not topo.implicit
                                       or sampler != "threefry")):
        raise ValueError(f"chunks={chunks}: the rows split into chunks "
                         "in threefry pull rounds on the complete graph "
                         "only")
    NE.check_supported(fault, engine="si-packed")
    dev = si_mod.topology_device(topo, device)
    sched = si_mod.round_schedule(fault, n, dev, schedule)
    churn = sched is not None
    drop_prob = 0.0 if fault is None else fault.drop_prob
    base_alive = (NE.base_alive_or_ones(fault, n, origin, dev) if churn
                  else alive_mask(fault, n, origin, dev))
    rows = -(-n // chunks)
    spans = [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]
    mfac = 3.0 if mode == C.ANTI_ENTROPY else 2.0
    # the round key is one threefry of a single key: some 150 tiny
    # launches, skipped where nothing draws from it
    keyed = sampler == "threefry" or drop_prob > 0.0 or churn

    def step(state: SimState):
        nxt = state._replace(round=state.round + 1)
        if (mode == C.ANTI_ENTROPY and proto.period > 1
                and state.round % proto.period):
            # a quiescent round sends nothing, so loses nothing
            return (nxt, torch.zeros((), dtype=torch.float32, device=dev)
                    ) if churn else nxt
        rkey = threefry.fold_in(state.key, state.round) if keyed else None
        if churn:
            alive = NE.alive_rows(sched, base_alive, state.round)
            dp = NE.drop_at(sched, state.round)
        else:
            alive, dp = base_alive, drop_prob
        packed = state.seen
        visible = packed if alive is None else torch.where(
            alive[:, None], packed, 0)
        qkey = (threefry.fold_in(rkey, si_mod.PULL_TAG)
                if sampler == "threefry" else None)
        cut = NE.cut_at(sched, state.round) if churn else None
        seen = None if len(spans) == 1 else torch.empty_like(packed)
        req = pre = post = 0
        for lo, hi in spans:
            ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
            al = None if alive is None else alive[lo:hi]
            if sampler == "kernel":
                partners0 = sample_peers_fast(sampler_seed, state.round, n,
                                              n, k, proto.exclude_self,
                                              device=dev)
            else:
                partners0 = sample_peers(qkey, ids, topo, k,
                                         proto.exclude_self)
            partners = apply_drop(rkey, si_mod.PULL_DROP_TAG, ids,
                                  partners0, dp, n, force=churn)
            if churn:
                partners = NE.partition_targets(cut, ids, partners, n)
            pulled = pull_merge_packed(visible, partners, n)
            if al is not None:
                partners = torch.where(al[:, None], partners, n)
            req = req + (partners < n).sum()
            if churn:
                # the nemesis's losses (NE.lost_count), counted in
                # integers across chunks
                pre = pre + ((partners0 < n) & al[:, None]).sum()
                post = post + ((partners < n) & al[:, None]).sum()
            if mode == C.ANTI_ENTROPY:
                # the initiator's digest scatters back into the partner's
                # row
                pulled = pulled | pack(push_delta(
                    n, partners, unpack(visible, proto.rumors)))
            if al is not None:
                pulled = torch.where(al[:, None], pulled, 0)
            if seen is None:
                seen = packed | pulled
            else:
                torch.bitwise_or(packed[lo:hi], pulled, out=seen[lo:hi])
        out = nxt._replace(seen=seen,
                           msgs=state.msgs + mfac * si_mod.f32(req))
        if churn:
            return out, si_mod.f32(pre) - si_mod.f32(post)
        return out

    return step


def _until(step, state: SimState, rumors: int, target: float,
           max_rounds: int, alive, folded: bool = False) -> SimState:
    """The reference's while-loop: step while the float32 coverage is
    below the float32 target and the round below ``max_rounds``; the
    coverage is read on the host once per round, as the reference's
    compiled condition computes it (``folded``: ``coverage_packed``)."""
    tgt = np.float32(target)
    while (coverage_packed(state.seen, rumors, alive, folded) < tgt
           and state.round < max_rounds):
        state = step(state)
    return state


def simulate_until_packed(proto: ProtocolConfig, topo: Topology,
                          run: RunConfig,
                          fault: Optional[FaultConfig] = None, device=None):
    """Run the packed round to ``run.target_coverage`` (alive-weighted
    under deaths; under a fault program over the eventual alive set) or
    ``run.max_rounds``.  Returns ``(rounds, coverage, msgs,
    final_state)``; the coverage is the reference's eager value."""
    loop, init = compiled_until_packed(proto, topo, run, fault,
                                       device=device)
    final = loop(init)
    alive = NE.metric_alive(fault, topo.n, run.origin, final.seen.device)
    return (final.round, coverage_packed(final.seen, proto.rumors, alive),
            float(final.msgs.item()), final)


def compiled_until_packed(proto: ProtocolConfig, topo: Topology,
                          run: RunConfig,
                          fault: Optional[FaultConfig] = None,
                          sampler: str = "threefry", device=None):
    """``(loop, init)``: the packed while-loop and a fresh state; call
    ``loop(state)``.  The reference's version also returns its topology
    tables, which its jit takes as arguments; here the step holds them.
    ``sampler="kernel"`` keys the sampling kernel with ``run.seed``."""
    step = NE.drop_lost(make_packed_round(proto, topo, fault, run.origin,
                                          sampler, run.seed, device),
                        NE.get(fault))
    dev = si_mod.topology_device(topo, device)
    init = init_packed_state(run, proto, topo.n, dev)
    alive = NE.metric_alive(fault, topo.n, run.origin, dev)
    folded = NE.folded_denominator(fault)

    def loop(state: SimState) -> SimState:
        return _until(step, state, proto.rumors, run.target_coverage,
                      run.max_rounds, alive, folded)

    return loop, init
