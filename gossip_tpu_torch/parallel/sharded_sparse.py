"""The sparse exchange of the node mesh: all_to_all requests and responses.

The port of the JAX package's ``parallel/sharded_sparse.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`.  The dense drivers move
the whole digest table every round (O(N) bytes); here each pull request
travels to the one rank that holds its partner and comes back as one
digest (O(messages) bytes).  Collectives move fixed-size buffers, so the
per-(source, destination) counts must be known in advance:

* **complete graph** (:func:`make_sparse_pull_round`): the partner draw
  is stratified over ranks.  Each rank's ``nl * k`` request slots fall
  round-robin into P groups of ``cap = nl * k / P`` (slot t in group
  ``(t + o) mod P``, with a fresh offset o each round), a fresh uniform
  permutation ``pi`` of the ranks (the same on every rank) maps groups to
  partner ranks, and the partner row within that rank is drawn per slot,
  keyed by the slot's global id.  Every slot's partner is uniform over
  all ``n_pad`` rows, and each (source, destination) pair carries
  exactly ``cap`` requests: ``[P, cap]`` ids out, ``[P, cap, W]`` words
  back.  The stratification P is part of the trajectory, so it depends
  on the mesh and equals the dense drivers' at no P;
  :func:`sparse_pull_round_reference` is its single-device twin for a
  given P.  ``exclude_self`` is not honoured: a slot pulls its own row
  with probability ``1 / n_pad``, a no-op for SI state;
* **explicit tables** (:func:`make_sparse_topo_pull_round`): a slot's
  partner is the graph's (``nbrs[i, j]`` for a uniform ``j < deg[i]``),
  so the counts depend on the data.  Requests go into capacity-capped
  buckets ``[P, cap]`` by the partner's rank, ranked in slot order
  (:func:`_bucket_rank`); a slot past its bucket's ``cap`` is dropped,
  deterministically, and counted as ``overflow``.  ``cap`` comes from the
  table (:func:`auto_topo_cap`); :func:`sparse_topo_pull_round_reference`
  is the twin.

Anti-entropy sends the requester's digest with the request (a third
``all_to_all``) and the responder merges it into the requested rows; with
``period > 1`` every rank skips the whole exchange, collectives and all,
on the same quiet rounds.  Draws are keyed by (round, global slot id), as
the reference keys them; ``msgs``, ``lost`` and ``overflow`` partials are
added in rank order (:meth:`Group.combine_f32`).  The coverage and the
loops follow :mod:`gossip_tpu_torch.parallel.sharded`: the reference's
sparse loops fold the stop test's division exactly where its dense
loops do (:func:`~gossip_tpu_torch.parallel.sharded.sharded_folded`),
and their reports carry the quotient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models.si import f32
from gossip_tpu_torch.models.si_packed import init_packed_state
from gossip_tpu_torch.models.state import SimState
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.bitpack import n_words, pack, unpack
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.parallel.group import Group, pad_rows, pad_to_mesh
from gossip_tpu_torch.parallel.sharded import (Coverage, SIRecorder, _Rows,
                                               exchange_bytes, instrumented,
                                               run_until,
                                               sharded_alive)
from gossip_tpu_torch.parallel.sharded_packed import init_sharded_packed_state
from gossip_tpu_torch.topology import generators as G
from gossip_tpu_torch.topology.generators import Topology

# RNG tags, disjoint from the SI rounds' 1..5
SPARSE_PERM_TAG = 101
SPARSE_OFFSET_TAG = 102
SPARSE_ROW_TAG = 103
SPARSE_DROP_TAG = 104
TOPO_NBR_TAG = 105


class SparseMeta(NamedTuple):
    """A rank's bytes a round on the sparse exchange and on the dense one.
    For anti-entropy with ``period > 1`` the exchange moves on exchange
    rounds only, so every sparse figure is per exchange round."""

    p: int                    # ranks
    cap: int                  # requests per (source, destination) pair
    request_bytes: int
    response_bytes: int
    dense_bytes: int          # the dense all_gather's
    reverse_bytes: int = 0    # anti-entropy's requester digests

    @property
    def sparse_bytes(self) -> int:
        return self.request_bytes + self.response_bytes + self.reverse_bytes


def sparse_meta(n_pad: int, p: int, k: int, w: int,
                bidirectional: bool = False) -> SparseMeta:
    return sparse_topo_meta(n_pad, p, k, w, (n_pad // p * k) // p,
                            bidirectional)


def sparse_topo_meta(n_pad: int, p: int, k: int, w: int, cap: int,
                     bidirectional: bool = False) -> SparseMeta:
    return SparseMeta(p=p, cap=cap, request_bytes=p * cap * 4,
                      response_bytes=p * cap * 4 * w,
                      dense_bytes=n_pad * 4 * w,
                      reverse_bytes=p * cap * 4 * w if bidirectional else 0)


def _validate(n_pad: int, p: int, k: int) -> int:
    nl = n_pad // p
    if n_pad % p:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {p}")
    if (nl * k) % p:
        raise ValueError(
            f"slots per shard ({nl}*{k}) must divide by mesh size {p} for "
            "balanced stratification; pad n or adjust fanout")
    return nl


def _round_draws(rkey: torch.Tensor, p: int):
    """``(pi, o)``: the round's rank permutation and group offset, the
    same on every rank (0-d ``o``, no host read)."""
    pi = threefry.permutation(threefry.fold_in(rkey, SPARSE_PERM_TAG), p)
    o = threefry.randint(threefry.fold_in(rkey, SPARSE_OFFSET_TAG), (), 0, p)
    return pi, o


def _slot_keys(rkey: torch.Tensor, tag: int, slot_gids: torch.Tensor):
    return threefry.fold_in(threefry.fold_in(rkey, tag), slot_gids)


def _slot_rows(rkey: torch.Tensor, slot_gids: torch.Tensor,
               nl: int) -> torch.Tensor:
    """A uniform partner row in ``[0, nl)`` a slot, keyed by its global
    id."""
    return threefry.randint(_slot_keys(rkey, SPARSE_ROW_TAG, slot_gids), (),
                            0, nl)


def _slot_valid(rkey: torch.Tensor, slot_gids: torch.Tensor, drop_prob,
                alive_rows: torch.Tensor, k: int,
                force: bool = False) -> torch.Tensor:
    """The slots that send a request: requester alive and link not
    dropped.  ``force`` always draws the coins (a program's per-round
    rate, a float32 0-d tensor; at 0 they are all False)."""
    valid = alive_rows.repeat_interleave(k)
    if force or drop_prob > 0.0:
        dropped = threefry.bernoulli(
            _slot_keys(rkey, SPARSE_DROP_TAG, slot_gids), drop_prob, ())
        valid = valid & ~dropped
    return valid


def _or_reduce_k(flat: torch.Tensor, nl: int, k: int) -> torch.Tensor:
    """``[nl * k, W]`` -> the OR over each row's k slots, ``[nl, W]``."""
    g = flat.reshape(nl, k, -1)
    out = g[:, 0, :]
    for j in range(1, k):
        out = out | g[:, j, :]
    return out


def _scatter_merge_digests(ok: torch.Tensor, recv: torch.Tensor,
                           recv_d: torch.Tensor, nl: int,
                           rumors: int) -> torch.Tensor:
    """The responder's anti-entropy merge: the requester digests
    (``recv_d`` ``[..., W]``) ORed into the requested rows (``recv``
    ``[...]``, of ``nl``; slots where ``ok`` is false drop).  No
    scatter-OR on words: unpacked bits are added in integers, ``> 0`` is
    the OR, packed again.  The mesh rounds pass what they received
    (``[P, cap]``), the twins every slot of the round."""
    rows_in = torch.where(ok, recv, nl).reshape(-1).to(torch.int64)
    contrib = unpack(recv_d.reshape(-1, recv_d.shape[-1]), rumors)
    cnt = torch.zeros(nl + 1, rumors, dtype=torch.int32, device=recv.device)
    cnt.index_add_(0, rows_in, contrib.to(torch.int32))
    return pack(cnt[:nl] > 0)


def _quiet(proto: ProtocolConfig, round_: int) -> bool:
    """An anti-entropy round with ``period > 1`` that exchanges nothing
    (every rank skips the same rounds)."""
    return (proto.mode == C.ANTI_ENTROPY and proto.period > 1
            and round_ % proto.period != 0)


def _mfac(proto: ProtocolConfig) -> float:
    return 3.0 if proto.mode == C.ANTI_ENTROPY else 2.0


def check_sparse(proto: ProtocolConfig, n: int, p: int,
                 fault: Optional[FaultConfig] = None) -> None:
    """Refuse, in the reference's words, what the complete-graph exchange
    cannot run on ``p`` ranks: another mode, or request slots that do not
    split evenly over the ranks."""
    if proto.mode not in (C.PULL, C.ANTI_ENTROPY):
        raise ValueError("sparse exchange is a pull/anti-entropy path; "
                         f"got mode {proto.mode!r}")
    _validate(pad_to_mesh(n, p), p, proto.fanout)
    NE.check_supported(fault, engine="sparse")


def make_sparse_pull_round(proto: ProtocolConfig, n: int, group: Group,
                           fault: Optional[FaultConfig] = None,
                           origin: int = 0):
    """This rank's sparse pull / anti-entropy step on the implicit
    complete graph, on ``state.seen`` of packed words ``int32[nl, W]``
    (:func:`init_sparse_state`): ``SimState -> SimState``, or under a
    fault program ``SimState -> (SimState, lost)``."""
    check_sparse(proto, n, group.size, fault)
    p, k = group.size, proto.fanout
    rows = _Rows(G.complete(n), group, fault, origin)
    nl = rows.nl
    cap, s = (nl * k) // p, nl * k
    churn = rows.sched is not None
    dev = group.device
    local_slot = torch.arange(s, dtype=torch.int64, device=dev)
    slot_gids = group.rank * s + local_slot
    ar_p = torch.arange(p, dtype=torch.int64, device=dev)

    def exchange(visible, rkey, alive_l, dp, cut):
        pi, o = _round_draws(rkey, p)
        inv_pi = torch.argsort(pi)
        rows_req = _slot_rows(rkey, slot_gids, nl)
        valid = _slot_valid(rkey, slot_gids, dp, alive_l, k, force=churn)
        lost = torch.zeros((), dtype=torch.float32, device=dev)
        if churn:
            # cross-cut requests are lost for this round only
            partner_gid = pi[(local_slot + o) % p] * nl + rows_req
            would = alive_l.repeat_interleave(k)
            valid = valid & NE.same_side(cut, slot_gids // k, partner_gid)
            lost = f32((would & ~valid).sum())
        rows_req = torch.where(valid, rows_req, -1).to(torch.int32)
        # column c of the [cap, P] slot view holds group (c + o) mod P,
        # which goes to rank pi[(c + o) mod P]: send[d] is rank d's block
        cols_for_dst = (inv_pi - o) % p
        send = rows_req.reshape(cap, p).t()[cols_for_dst]
        recv = group.all_to_all(send)          # rows rank s asks of us
        ok = recv >= 0
        resp = visible[torch.clamp(recv, 0, nl - 1).to(torch.int64)]
        resp = torch.where(ok[:, :, None], resp, 0)
        back = group.all_to_all(resp)          # back[d]: rank d's answers
        r_cols = back[pi[(ar_p + o) % p]]
        pulled = _or_reduce_k(r_cols.permute(1, 0, 2).reshape(s, -1), nl, k)
        if proto.mode == C.ANTI_ENTROPY:
            # the requester's digest rides with its request
            digest = torch.where(valid[:, None], visible[local_slot // k], 0)
            send_d = digest.reshape(cap, p, -1).permute(1, 0, 2)[
                cols_for_dst]
            recv_d = group.all_to_all(send_d)
            pulled = pulled | _scatter_merge_digests(ok, recv, recv_d, nl,
                                                     proto.rumors)
        return pulled, f32(valid.sum()), lost

    def step(state: SimState):
        nxt = state._replace(round=state.round + 1)
        if _quiet(proto, state.round):
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            return (nxt, zero) if churn else nxt
        rkey = threefry.fold_in(state.key, state.round)
        alive_l, dp, cut = rows.at(state.round)
        visible = torch.where(alive_l[:, None], state.seen, 0)
        pulled, n_req, lost = exchange(visible, rkey, alive_l, dp, cut)
        pulled = torch.where(alive_l[:, None], pulled, 0)
        total, lost_all = group.combine_f32(
            torch.stack([_mfac(proto) * n_req, lost]))
        out = nxt._replace(seen=state.seen | pulled, msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def sparse_pull_round_reference(proto: ProtocolConfig, n: int, p: int,
                                fault: Optional[FaultConfig] = None,
                                origin: int = 0, device=None):
    """The single-device twin of :func:`make_sparse_pull_round` for the
    stratification ``p``: the same trajectory on ``seen`` ``int32[n_pad,
    W]`` (:func:`init_sparse_state` with ``p``), where the collectives
    only move data."""
    dev = resolve_device(device)
    k = proto.fanout
    n_pad = pad_to_mesh(n, p)
    nl = _validate(n_pad, p, k)
    s = nl * k
    drop_prob = 0.0 if fault is None else fault.drop_prob
    alive_pad = sharded_alive(fault, n, n_pad, origin, dev)
    churn = NE.get(fault) is not None
    sched = NE.build(fault, n, n_pad, device=dev) if churn else None
    slot_gids = torch.arange(n_pad * k, dtype=torch.int64, device=dev)
    mfac = _mfac(proto)

    def step(state: SimState):
        seen, round_ = state.seen, state.round
        rkey = threefry.fold_in(state.key, round_)
        pi, o = _round_draws(rkey, p)
        gids = pi[(slot_gids % s + o) % p] * nl + _slot_rows(rkey, slot_gids,
                                                             nl)
        if churn:
            alive_now = NE.alive_rows(sched, alive_pad, round_)
            valid = _slot_valid(rkey, slot_gids, NE.drop_at(sched, round_),
                                alive_now, k, force=True)
            valid = valid & NE.same_side(NE.cut_at(sched, round_),
                                         slot_gids // k, gids)
            lost = f32((alive_now.repeat_interleave(k) & ~valid).sum())
        else:
            alive_now = alive_pad
            valid = _slot_valid(rkey, slot_gids, drop_prob, alive_pad, k)
            lost = torch.zeros((), dtype=torch.float32, device=dev)
        visible = torch.where(alive_now[:, None], seen, 0)
        got = torch.where(valid[:, None], visible[gids], 0)
        pulled = _or_reduce_k(got, n_pad, k)
        n_req = f32(valid.sum())
        if proto.mode == C.ANTI_ENTROPY:
            digest = torch.where(valid[:, None], visible[slot_gids // k], 0)
            pulled = pulled | _scatter_merge_digests(valid, gids, digest,
                                                     n_pad, proto.rumors)
        if _quiet(proto, round_):
            pulled = torch.zeros_like(pulled)
            n_req = lost = torch.zeros((), dtype=torch.float32, device=dev)
        pulled = torch.where(alive_now[:, None], pulled, 0)
        out = SimState(seen=seen | pulled, round=round_ + 1, key=state.key,
                       msgs=state.msgs + mfac * n_req)
        return (out, lost) if churn else out

    return step


def init_sparse_state(run: RunConfig, proto: ProtocolConfig, n: int,
                      group: Optional[Group] = None, p: Optional[int] = None,
                      device=None) -> SimState:
    """Packed state padded to the mesh: this rank's rows with a ``group``
    (built from its rows alone), else every row padded to ``p``
    stratification ranks (the twin's state; ``p = 1`` by default).  Rumor
    r starts at node ``(origin + r) % n``."""
    if group is not None:
        return init_sharded_packed_state(run, proto, G.complete(n), group)
    st = init_packed_state(run, proto, n, resolve_device(device))
    return st._replace(seen=pad_rows(st.seen, pad_to_mesh(n, p or 1), 0))


# -- explicit tables: capacity-capped buckets ---------------------------

def auto_topo_cap(nbrs, deg, nl: int, k: int, p: int,
                  slack_sigma: float = 4.0, floor: int = 4) -> int:
    """The bucket capacity from the table: the largest expected load of a
    (source, destination) pair, ``E[s, d] = k * sum over rows i of s of
    |nbrs(i) in d| / deg(i)``, plus ``slack_sigma`` times its square root
    plus ``floor``, at most ``nl * k``.  A banded graph drives it toward
    ``nl * k`` (no byte win: the halo exchange's ground).  One numpy
    pass over the real (unpadded) rows."""
    nbrs = np.asarray(nbrs)
    deg = np.asarray(deg)
    n_rows, d_max = nbrs.shape
    src = np.repeat(np.arange(n_rows) // nl, d_max)
    valid = np.arange(d_max)[None, :] < deg[:, None]
    dst = np.where(valid, nbrs // nl, 0).reshape(-1)
    wts = np.where(valid, k / np.maximum(deg, 1)[:, None], 0.0).reshape(-1)
    e = np.zeros((p, p))
    np.add.at(e, (src, dst), wts)
    max_e = float(e.max())
    cap = math.ceil(max_e + slack_sigma * math.sqrt(max(max_e, 1.0))
                    + floor)
    return min(nl * k, max(1, cap))


def resolve_topo_cap(topo: Topology, p: int, k: int,
                     cap: Optional[int] = None) -> int:
    """The capacity the topology exchange uses: ``cap`` if given, else
    :func:`auto_topo_cap` of the table."""
    if cap is not None:
        return cap
    return auto_topo_cap(topo.nbrs.cpu().numpy(), topo.deg.cpu().numpy(),
                         pad_to_mesh(topo.n, p) // p, k, p)


def _slot_nbr_choice(rkey: torch.Tensor, slot_gids: torch.Tensor,
                     deg_slot: torch.Tensor) -> torch.Tensor:
    """A uniform neighbour index ``j < deg`` a slot, keyed by its global
    id: ``min(int32(u * float32(deg)), max(deg - 1, 0))``, the product in
    float32 (degree-0 slots get 0 and are invalid)."""
    u = threefry.uniform(_slot_keys(rkey, TOPO_NBR_TAG, slot_gids), ())
    j = (u * deg_slot.to(torch.float32)).to(torch.int64)
    return torch.minimum(j, torch.clamp(deg_slot.to(torch.int64) - 1, min=0))


def _bucket_rank(dst_eff: torch.Tensor, p: int) -> torch.Tensor:
    """Each slot's rank within its destination's bucket, in slot order;
    ``dst_eff == p`` marks an invalid slot (it takes no capacity)."""
    occ = dst_eff[:, None] == torch.arange(p, device=dst_eff.device)
    pos = torch.cumsum(occ.to(torch.int32), dim=0) - 1
    return torch.gather(pos, 1, torch.clamp(dst_eff, 0, p - 1)[:, None]
                        )[:, 0].to(torch.int64)


def check_topo_sparse(proto: ProtocolConfig, implicit: bool,
                      fault: Optional[FaultConfig]) -> None:
    """Refuse, in the reference's words, what the explicit-table exchange
    cannot run: another mode, the implicit graph, and any fault
    program."""
    if proto.mode not in (C.PULL, C.ANTI_ENTROPY):
        raise ValueError("sparse topology exchange covers pull and "
                         f"anti-entropy (got mode {proto.mode!r}); push/"
                         "flood ride the dense kernels")
    if implicit:
        raise ValueError("implicit complete topology routes to "
                         "make_sparse_pull_round (stratified draw)")
    NE.check_supported(fault, engine="topo-sparse", events=False,
                       partitions=False, ramp=False)


def make_sparse_topo_pull_round(proto: ProtocolConfig, topo: Topology,
                                group: Group,
                                fault: Optional[FaultConfig] = None,
                                origin: int = 0,
                                cap: Optional[int] = None):
    """This rank's pull / anti-entropy step over an explicit table with
    the capacity-capped exchange: ``step(state, overflow) -> (state,
    overflow)``, ``overflow`` the float32 running count of the requests
    the buckets dropped (module doc)."""
    check_topo_sparse(proto, topo.implicit, fault)
    p, k = group.size, proto.fanout
    cap = resolve_topo_cap(topo, p, k, cap)
    rows = _Rows(topo, group, fault, origin)
    nl, s = rows.nl, rows.nl * k
    dev = group.device
    drop_prob = rows.drop_prob
    alive_l = rows.static_alive
    local_slot = torch.arange(s, dtype=torch.int64, device=dev)
    slot_gids = group.rank * s + local_slot
    row_of_slot = local_slot // k
    deg_slot = rows.deg.repeat_interleave(k)

    def exchange(visible, rkey):
        j = _slot_nbr_choice(rkey, slot_gids, deg_slot)
        gid = rows.nbrs[row_of_slot, j].to(torch.int64)
        valid = (_slot_valid(rkey, slot_gids, drop_prob, alive_l, k)
                 & (deg_slot > 0))
        dst_eff = torch.where(valid, gid // nl, p)
        pos = _bucket_rank(dst_eff, p)
        sent = valid & (pos < cap)
        # the sent slots' (bucket, rank) pairs are distinct; the rest keep
        # the -1 sentinel
        send_rows = torch.full((p, cap), -1, dtype=torch.int32, device=dev)
        send_rows[dst_eff[sent], pos[sent]] = (gid[sent] % nl).to(
            torch.int32)
        recv = group.all_to_all(send_rows)
        ok = recv >= 0
        resp = visible[torch.clamp(recv, 0, nl - 1).to(torch.int64)]
        resp = torch.where(ok[:, :, None], resp, 0)
        back = group.all_to_all(resp)
        got = back[torch.clamp(dst_eff, 0, p - 1), torch.clamp(pos, 0,
                                                               cap - 1)]
        pulled = _or_reduce_k(torch.where(sent[:, None], got, 0), nl, k)
        if proto.mode == C.ANTI_ENTROPY:
            # the requester's digest rides in its request's bucket slot
            send_d = torch.zeros((p, cap, visible.shape[1]),
                                 dtype=visible.dtype, device=dev)
            send_d[dst_eff[sent], pos[sent]] = visible[row_of_slot[sent]]
            recv_d = group.all_to_all(send_d)
            pulled = pulled | _scatter_merge_digests(ok, recv, recv_d, nl,
                                                     proto.rumors)
        return pulled, f32(sent.sum()), f32((valid & ~sent).sum())

    def step(state: SimState, overflow: torch.Tensor):
        nxt = state._replace(round=state.round + 1)
        if _quiet(proto, state.round):
            return nxt, overflow
        visible = torch.where(alive_l[:, None], state.seen, 0)
        pulled, n_sent, n_over = exchange(
            visible, threefry.fold_in(state.key, state.round))
        pulled = torch.where(alive_l[:, None], pulled, 0)
        total, over = group.combine_f32(
            torch.stack([_mfac(proto) * n_sent, n_over]))
        return (nxt._replace(seen=state.seen | pulled,
                             msgs=state.msgs + total), overflow + over)

    return step


def sparse_topo_pull_round_reference(proto: ProtocolConfig, topo: Topology,
                                     p: int,
                                     fault: Optional[FaultConfig] = None,
                                     origin: int = 0,
                                     cap: Optional[int] = None,
                                     device=None):
    """The single-device twin of :func:`make_sparse_topo_pull_round`:
    the same trajectory, the capacity drops included (bucket ranks
    recomputed per source block in the same slot order)."""
    check_topo_sparse(proto, topo.implicit, fault)
    dev = resolve_device(device)
    k, n = proto.fanout, topo.n
    n_pad = pad_to_mesh(n, p)
    nl = n_pad // p
    s = nl * k
    cap = resolve_topo_cap(topo, p, k, cap)
    drop_prob = 0.0 if fault is None else fault.drop_prob
    nbrs = pad_rows(topo.nbrs.to(dev), n_pad, n)
    deg_slot = pad_rows(topo.deg.to(dev), n_pad, 0).repeat_interleave(k)
    alive_pad = sharded_alive(fault, n, n_pad, origin, dev)
    slot_gids = torch.arange(n_pad * k, dtype=torch.int64, device=dev)
    row_of_slot = slot_gids // k
    mfac = _mfac(proto)

    def step(state: SimState, overflow: torch.Tensor):
        seen, round_ = state.seen, state.round
        rkey = threefry.fold_in(state.key, round_)
        j = _slot_nbr_choice(rkey, slot_gids, deg_slot)
        gid = nbrs[row_of_slot, j].to(torch.int64)
        valid = (_slot_valid(rkey, slot_gids, drop_prob, alive_pad, k)
                 & (deg_slot > 0))
        dst_eff = torch.where(valid, gid // nl, p)
        pos = torch.cat([_bucket_rank(b, p) for b in dst_eff.reshape(p, s)])
        sent = valid & (pos < cap)
        visible = torch.where(alive_pad[:, None], seen, 0)
        got = torch.where(sent[:, None],
                          visible[torch.clamp(gid, 0, n_pad - 1)], 0)
        pulled = _or_reduce_k(got, n_pad, k)
        n_sent, n_over = f32(sent.sum()), f32((valid & ~sent).sum())
        if proto.mode == C.ANTI_ENTROPY:
            digest = torch.where(sent[:, None], visible[row_of_slot], 0)
            pulled = pulled | _scatter_merge_digests(sent, gid, digest,
                                                     n_pad, proto.rumors)
            if _quiet(proto, round_):
                pulled = torch.zeros_like(pulled)
                n_sent = n_over = torch.zeros((), dtype=torch.float32,
                                              device=dev)
        pulled = torch.where(alive_pad[:, None], pulled, 0)
        return (SimState(seen=seen | pulled, round=round_ + 1, key=state.key,
                         msgs=state.msgs + mfac * n_sent),
                overflow + n_over)

    return step


# -- the loops ------------------------------------------------------------

def _zero(group: Group) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=group.device)


def _recorder(label: str, proto: ProtocolConfig, n: int, run: RunConfig,
              group: Group, fault, meta: SparseMeta) -> SIRecorder:
    """The reference's ``_sparse_recorder``: the packed SI row, with the
    exchange's own per-device bytes (its :class:`SparseMeta`) and the
    msgs sum on exchange rounds, the msgs sum alone on quiescent
    anti-entropy rounds."""
    return SIRecorder(label, proto, n, group, fault, run.origin,
                      run.max_rounds,
                      exchange_bytes(proto, float(meta.sparse_bytes) + 4.0,
                                     0.0, off=4.0), packed=True)


def simulate_curve_sparse(proto: ProtocolConfig, n: int, run: RunConfig,
                          group: Group,
                          fault: Optional[FaultConfig] = None):
    """Exactly ``run.max_rounds`` rounds of the complete-graph sparse
    exchange.  Returns ``(coverage float32[T], msgs float32[T],
    final_state, SparseMeta)``."""
    state = init_sparse_state(run, proto, n, group)
    meta = _meta(proto, n, group)
    step, rec = instrumented(
        make_sparse_pull_round(proto, n, group, fault, run.origin), state,
        fault, lambda: _recorder("simulate_curve_sparse", proto, n, run,
                                 group, fault, meta))
    cov = Coverage(fault, n, run.origin, group, proto.rumors)
    covs, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(cov.compiled(state.seen))
        msgs.append(state.msgs)
    RM.deliver(rec and rec.m)
    return (np.asarray(covs, np.float32),
            np.asarray([float(m.item()) for m in msgs], np.float32), state,
            meta)


def simulate_until_sparse(proto: ProtocolConfig, n: int, run: RunConfig,
                          group: Group,
                          fault: Optional[FaultConfig] = None):
    """The complete-graph sparse exchange's while-loop to
    ``run.target_coverage`` or ``run.max_rounds``.  Returns ``(rounds,
    coverage, msgs, final_state, SparseMeta)``."""
    state = init_sparse_state(run, proto, n, group)
    meta = _meta(proto, n, group)
    step, rec = instrumented(
        make_sparse_pull_round(proto, n, group, fault, run.origin), state,
        fault, lambda: _recorder("simulate_until_sparse", proto, n, run,
                                 group, fault, meta))
    cov = Coverage(fault, n, run.origin, group, proto.rumors)
    out = run_until(step, state, cov, run)
    RM.deliver(rec and rec.m)
    return out + (meta,)


def _meta(proto: ProtocolConfig, n: int, group: Group,
          cap: Optional[int] = None) -> SparseMeta:
    n_pad = pad_to_mesh(n, group.size)
    w = n_words(proto.rumors)
    ae = proto.mode == C.ANTI_ENTROPY
    if cap is None:
        return sparse_meta(n_pad, group.size, proto.fanout, w, ae)
    return sparse_topo_meta(n_pad, group.size, proto.fanout, w, cap, ae)


def simulate_curve_topo_sparse(proto: ProtocolConfig, topo: Topology,
                               run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None,
                               cap: Optional[int] = None):
    """Exactly ``run.max_rounds`` rounds of the explicit-table sparse
    exchange.  Returns ``(coverage float32[T], msgs float32[T],
    final_state, SparseMeta, overflow float32[T])``."""
    cap = resolve_topo_cap(topo, group.size, proto.fanout, cap)
    step = make_sparse_topo_pull_round(proto, topo, group, fault,
                                       run.origin, cap)
    state = init_sparse_state(run, proto, topo.n, group)
    meta = _meta(proto, topo.n, group, cap)
    rec = None
    if RM.wanted():
        rec = _recorder("simulate_curve_topo_sparse", proto, topo.n, run,
                        group, fault, meta)
        rec.start(state)
    cov = Coverage(fault, topo.n, run.origin, group, proto.rumors)
    ovf = _zero(group)
    covs, msgs, ovfs = [], [], []
    for _ in range(run.max_rounds):
        s0 = state
        state, ovf = step(state, ovf)
        if rec is not None:
            rec(s0, state)
        covs.append(cov.compiled(state.seen))
        msgs.append(state.msgs)
        ovfs.append(ovf)
    RM.deliver(rec and rec.m)
    return (np.asarray(covs, np.float32),
            np.asarray([float(m.item()) for m in msgs], np.float32), state,
            meta, np.asarray([float(o.item()) for o in ovfs], np.float32))


def simulate_until_topo_sparse(proto: ProtocolConfig, topo: Topology,
                               run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None,
                               cap: Optional[int] = None):
    """The explicit-table sparse exchange's while-loop.  Returns
    ``(rounds, coverage, msgs, final_state, SparseMeta, overflow)``."""
    cap = resolve_topo_cap(topo, group.size, proto.fanout, cap)
    round_ = make_sparse_topo_pull_round(proto, topo, group, fault,
                                         run.origin, cap)
    ovf = [_zero(group)]

    def plain(state: SimState) -> SimState:
        state, ovf[0] = round_(state, ovf[0])
        return state

    state = init_sparse_state(run, proto, topo.n, group)
    meta = _meta(proto, topo.n, group, cap)
    step, rec = instrumented(
        plain, state, fault, lambda: _recorder(
            "simulate_until_topo_sparse", proto, topo.n, run, group, fault,
            meta))
    cov = Coverage(fault, topo.n, run.origin, group, proto.rumors)
    out = run_until(step, state, cov, run)
    RM.deliver(rec and rec.m)
    return out + (meta, float(ovf[0].item()))
