"""The halo exchange of the node mesh: ``ppermute`` rounds on banded graphs.

The port of the JAX package's ``parallel/halo.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`.  On a band-limited graph
(a ring, a row-major grid, an unrewired Watts-Strogatz lattice) every
edge stays within circular distance B of its source, so a rank's block
only reads the B rows on each side of it.  Each round sends its first B
visible rows to the left neighbour rank and its last B to the right one
(two :meth:`Group.ppermute` calls, kept apart even where the two
neighbours are one rank), and reads every neighbour from the extended
buffer ``[nl + 2B, R]``: global id ``i`` is row ``(i - (rank * nl - B))
mod n``.  Push scatters into that buffer and hands its first and last B
rows back to their owners with the reverse shifts.  O(B) bytes a round
where the dense drivers move O(N); the trajectory is bitwise the
single-device one (draws keyed by global id, as everywhere in the mesh).

Constraints, checked in the reference's words: an explicit table,
``n % K == 0`` (contiguous blocks, no padding rows in the circular
index), and ``band <= nl`` (halos come from the immediate neighbours).
The reference's halo loops fold the stop test's division where its dense
loops do (:func:`~gossip_tpu_torch.parallel.sharded.sharded_folded`);
their reports carry the mean's product where there is no alive set, the
quotient otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import si as si_mod
from gossip_tpu_torch.models.state import SimState
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import f32_mean
from gossip_tpu_torch.ops.propagate import push_counts
from gossip_tpu_torch.ops.sampling import apply_drop, drop_mask
from gossip_tpu_torch.parallel.group import Group
from gossip_tpu_torch.parallel.sharded import (Coverage, _Rows,
                                               init_sharded_state, run_until,
                                               sharded_folded)
from gossip_tpu_torch.topology.generators import Topology


def band_of(topo: Topology) -> int:
    """The largest circular edge distance: every edge (i, j) has
    ``min(|i - j|, n - |i - j|) <= B``."""
    if topo.implicit:
        raise ValueError("band is undefined for the implicit complete graph")
    nbrs = topo.nbrs.cpu().numpy().astype(np.int64)
    deg = topo.deg.cpu().numpy()
    n = topo.n
    rows = np.repeat(np.arange(n), nbrs.shape[1])
    flat = nbrs.reshape(-1)
    cols = (np.arange(nbrs.shape[1])[None, :] < deg[:, None]).reshape(-1)
    use = (flat < n) & cols
    d = np.abs(flat[use] - rows[use])
    return int(np.minimum(d, n - d).max()) if d.size else 0


def _exchange_halos(visible_l: torch.Tensor, band: int,
                    group: Group) -> torch.Tensor:
    """``[nl, R] -> [nl + 2B, R]``: the left neighbour's last B rows, these
    rows, the right neighbour's first B rows."""
    from_left = group.ppermute(visible_l[-band:], 1)
    from_right = group.ppermute(visible_l[:band], -1)
    return torch.cat([from_left, visible_l, from_right])


def check_halo(proto: ProtocolConfig, n: int, implicit: bool,
               p: int) -> None:
    """Refuse, in the reference's words, what the halo rounds cannot run
    before the table is read: another mode, the implicit complete graph,
    or ``n`` that ``p`` ranks do not divide."""
    if proto.mode not in (C.FLOOD, C.PULL, C.PUSH, C.PUSH_PULL):
        raise ValueError("halo rounds support flood/pull/push/pushpull, "
                         f"got {proto.mode!r}")
    if implicit:
        raise ValueError("halo exchange needs an explicit neighbor table")
    if n % p != 0:
        raise ValueError(f"halo rounds need n % mesh size == 0 "
                         f"(n={n}, mesh={p}); pad the topology instead")


def make_halo_round(proto: ProtocolConfig, topo: Topology, group: Group,
                    fault: Optional[FaultConfig] = None, origin: int = 0):
    """This rank's flood, pull, push or push-pull step with O(band)
    traffic, on ``state.seen`` ``bool[nl, R]``: ``SimState -> SimState``,
    or under a fault program ``SimState -> (SimState, lost)``."""
    n, k, mode = topo.n, proto.fanout, proto.mode
    check_halo(proto, n, topo.implicit, group.size)
    nl = n // group.size
    band = band_of(topo)
    if band > nl:
        raise ValueError(
            f"band {band} exceeds rows/shard {nl}: edges span non-adjacent "
            "shards — use the all_gather kernels (parallel/sharded.py)")
    band = max(band, 1)             # a ppermute of 0 rows is degenerate
    NE.check_supported(fault, engine="halo")
    rows = _Rows(topo, group, fault, origin)
    churn = rows.sched is not None
    gids, dev = rows.gids, group.device
    base = group.rank * nl - band
    ext_rows = nl + 2 * band
    nbrs = None if rows.nbrs is None else rows.nbrs.to(torch.int64)

    def to_ext(idx):
        # global id -> extended row; every id read is within B of the block
        return torch.remainder(idx - base, n)

    def step(state: SimState):
        rkey = threefry.fold_in(state.key, state.round)
        alive_l, dp, cut = rows.at(state.round)
        seen = state.seen
        lost = msgs_local = torch.zeros((), dtype=torch.float32, device=dev)
        visible = seen & alive_l[:, None]
        ext = _exchange_halos(visible, band, group)
        delta = torch.zeros_like(seen)

        if mode == C.FLOOD:
            use = nbrs
            if churn or rows.drop_prob > 0.0:
                dropped = drop_mask(rkey, si_mod.FLOOD_DROP_TAG, gids,
                                    nbrs.shape[1], dp)
                use = torch.where(dropped, n, use)
            if churn:
                use = NE.partition_targets(cut, gids, use, n)
                valid0 = nbrs < n
                sender_up = ext.any(dim=1)[torch.where(valid0, to_ext(nbrs),
                                                       0)]
                lost = lost + si_mod.f32((valid0 & sender_up
                                          & (use >= n)).sum())
            valid = use < n
            got = ext[torch.where(valid, to_ext(use), 0)]
            delta = (got & valid[:, :, None]).any(dim=1)
            msgs_local = si_mod.f32(torch.where(visible.any(dim=1),
                                                rows.deg, 0).sum())

        if mode in (C.PUSH, C.PUSH_PULL):
            pkey = threefry.fold_in(rkey, si_mod.PUSH_TAG)
            targets0 = rows.sample(pkey, topo, k, proto.exclude_self)
            targets = apply_drop(rkey, si_mod.PUSH_DROP_TAG, gids, targets0,
                                 dp, n, force=churn)
            if churn:
                targets = NE.partition_targets(cut, gids, targets, n)
            sender_active = visible.any(dim=1)
            if churn:
                lost = lost + NE.lost_count(targets0, targets, sender_active,
                                            n)
            valid = (targets < n) & sender_active[:, None]
            # scatter into the extended buffer; its first B rows belong to
            # the left neighbour's last B, its last B to the right's first
            contrib = push_counts(ext_rows, torch.where(
                valid, to_ext(targets), ext_rows), visible) > 0
            recv_hi = group.ppermute(contrib[:band], -1)
            recv_lo = group.ppermute(contrib[band + nl:], 1)
            pushed = contrib[band:band + nl].clone()
            pushed[:band] |= recv_lo
            pushed[nl - band:] |= recv_hi
            delta = delta | pushed
            msgs_local = msgs_local + si_mod.f32(valid.sum())

        if mode in (C.PULL, C.PUSH_PULL):
            qkey = threefry.fold_in(rkey, si_mod.PULL_TAG)
            partners0 = rows.sample(qkey, topo, k, proto.exclude_self)
            partners = apply_drop(rkey, si_mod.PULL_DROP_TAG, gids,
                                  partners0, dp, n, force=churn)
            if churn:
                partners = NE.partition_targets(cut, gids, partners, n)
                lost = lost + NE.lost_count(partners0, partners, alive_l, n)
            valid = partners < n
            got = ext[torch.where(valid, to_ext(partners), 0)]
            delta = delta | (got & valid[:, :, None]).any(dim=1)
            req = torch.where(alive_l[:, None], partners, n)
            msgs_local = msgs_local + 2.0 * si_mod.f32((req < n).sum())

        delta = delta & alive_l[:, None]
        total, lost_all = group.combine_f32(torch.stack([msgs_local, lost]))
        out = SimState(seen=seen | delta, round=state.round + 1,
                       key=state.key, msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def _loop_parts(proto, topo, run, group, fault):
    step = NE.drop_lost(make_halo_round(proto, topo, group, fault,
                                        run.origin), NE.get(fault))
    cov = Coverage(fault, topo.n, run.origin, group)
    return step, init_sharded_state(run, proto, topo, group), cov


def simulate_until_halo(proto: ProtocolConfig, topo: Topology,
                        run: RunConfig, group: Group,
                        fault: Optional[FaultConfig] = None):
    """The halo while-loop to ``run.target_coverage`` or
    ``run.max_rounds``.  Returns ``(rounds, coverage, msgs, final_state,
    band)``; the coverage as the reference's report computes it (the
    mean's product without an alive set, else the quotient)."""
    step, state, cov = _loop_parts(proto, topo, run, group, fault)
    rounds, coverage, msgs, state = run_until(step, state, cov, run)
    if sharded_folded(fault):
        coverage = f32_mean(cov.count(state.seen), topo.n)
    return rounds, coverage, msgs, state, band_of(topo)


def simulate_curve_halo(proto: ProtocolConfig, topo: Topology,
                        run: RunConfig, group: Group,
                        fault: Optional[FaultConfig] = None):
    """Exactly ``run.max_rounds`` halo rounds, recording the coverage and
    the cumulative msgs after each.  Returns ``(coverage float32[T], msgs
    float32[T], final_state, band)``."""
    step, state, cov = _loop_parts(proto, topo, run, group, fault)
    covs, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(cov.compiled(state.seen))
        msgs.append(state.msgs)
    return (np.asarray(covs, np.float32),
            np.asarray([float(m.item()) for m in msgs], np.float32), state,
            band_of(topo))
