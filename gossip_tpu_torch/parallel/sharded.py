"""Node-dimension sharding of the SI rounds: the dense drivers.

The port of the JAX package's ``parallel/sharded.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`: each rank holds its
``[nl, R]`` rows of ``seen`` and draws every random number keyed by the
*global* node id (``gids = rank * nl + arange(nl)``), so the trajectory is
bitwise the single-device one whatever the mesh.  The reference's XLA
collectives become ``torch.distributed`` ones:

* **push**: each rank scatter-adds its outgoing rumors into an
  ``int32[n_pad, R]`` count table
  (:func:`~gossip_tpu_torch.ops.propagate.push_counts`), which a
  reduce-scatter brings to the owning rank; ``counts > 0`` is the OR;
* **pull / flood**: the visible table is all-gathered (``bool[n_pad, R]``)
  and each rank gathers its sampled rows locally;
* **anti-entropy**: pull, plus the reverse delta as a push of counts, on
  exchange rounds only (a quiescent round moves nothing);
* **counters**: the ranks' float32 ``msgs`` and ``lost`` partials are
  added in rank order (:meth:`Group.combine_f32`); coverage counts are
  integer sums (:meth:`Group.all_reduce_sum`).

Padding rows (node ids ``n .. n_pad - 1``) are dead: they never sample,
send or receive, and no coverage counts them, so the sharded coverage is
always the alive-weighted quotient.  Under an active run ledger the
drivers record the reference's round metrics (:class:`SIRecorder`,
:mod:`gossip_tpu_torch.ops.round_metrics`).  The reference's compiled loops see
that quotient's denominator as a constant, and multiply by its float32
reciprocal, only where the alive set is every real node (no deaths, no
fault program: :func:`sharded_folded`); its dense churn loop takes the
eventual alive set as an operand, and its in-trace sets with deaths or a
program are not folded either, so there the stop test divides.  The
reports' coverage is the eager quotient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import si as si_mod
from gossip_tpu_torch.models.state import (SimState, alive_mask,
                                           state_from_numpy, state_to_numpy)
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.bitpack import rumor_count_tensor
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.propagate import (flood_gather, pull_merge,
                                            push_counts)
from gossip_tpu_torch.ops.sampling import (apply_drop, drop_mask,
                                           sample_peers_complete,
                                           sample_peers_table)
from gossip_tpu_torch.parallel.group import Group, pad_rows
from gossip_tpu_torch.topology.generators import Topology


def sharded_alive(fault: Optional[FaultConfig], n: int, n_pad: int,
                  origin: int, device) -> torch.Tensor:
    """bool[n_pad]: the static alive mask (all real nodes without deaths)
    with the padding rows dead; the sharded rounds always mask."""
    alive = alive_mask(fault, n, origin, device)
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=device)
    return pad_rows(alive, n_pad, False)


def metric_alive_pad(fault: Optional[FaultConfig], n: int, n_pad: int,
                     origin: int, device) -> torch.Tensor:
    """bool[n_pad]: the coverage's alive set, padding rows dead: the
    static mask, or under a fault program the eventual alive set."""
    if NE.get(fault) is not None:
        return pad_rows(NE.eventual_alive(fault, n, origin, device), n_pad,
                        False)
    return sharded_alive(fault, n, n_pad, origin, device)


def sharded_folded(fault: Optional[FaultConfig]) -> bool:
    """Whether the reference's compiled sharded loops multiply by the
    reciprocal of the alive count (module doc): only where it is the
    plain node count, with no deaths and no fault program."""
    return fault is None or (fault.node_death_rate <= 0.0
                             and NE.get(fault) is None)


class _Rows:
    """What a sharded step needs of its rank: the row range, the global
    ids, the liveness (static or from the schedule) and the local
    neighbour rows."""

    def __init__(self, topo: Topology, group: Group,
                 fault: Optional[FaultConfig], origin: int,
                 schedule: Optional[NE.Schedule] = None):
        n = topo.n
        dev = group.device
        self.n_pad, self.nl, self.lo = group.rows(n)
        sl = slice(self.lo, self.lo + self.nl)
        self.sl = sl
        self.gids = torch.arange(self.lo, self.lo + self.nl,
                                 dtype=torch.int64, device=dev)
        if schedule is not None and NE.get(fault) is not None:
            # the caller's tables, read when the step runs
            self.sched = schedule
        else:
            self.sched = (NE.build(fault, n, self.n_pad, device=dev)
                          if NE.get(fault) is not None else None)
        self.drop_prob = 0.0 if fault is None else fault.drop_prob
        if self.sched is not None:
            self.base_pad = pad_rows(
                NE.base_alive_or_ones(fault, n, origin, dev), self.n_pad,
                False)
        else:
            self.static_full = sharded_alive(fault, n, self.n_pad, origin,
                                             dev)
            self.static_alive = self.static_full[sl]
        if topo.implicit:
            self.nbrs = self.deg = None
        else:
            self.nbrs = pad_rows(topo.nbrs.to(dev), self.n_pad, n)[sl]
            self.deg = pad_rows(topo.deg.to(dev), self.n_pad, 0)[sl]

    def at(self, round_: int):
        """``(alive_l, drop_prob, cut)`` of ``round_``."""
        if self.sched is None:
            return self.static_alive, self.drop_prob, None
        return (self.alive_full(round_)[self.sl],
                NE.drop_at(self.sched, round_), NE.cut_at(self.sched, round_))

    def alive_full(self, round_: int) -> torch.Tensor:
        """bool[n_pad]: every node's liveness in ``round_`` (replicated on
        every rank, padding rows dead)."""
        if self.sched is None:
            return self.static_full
        return NE.alive_rows(self.sched, self.base_pad, round_)

    def sample(self, key, topo: Topology, k: int, exclude_self: bool,
               rows: slice = slice(None)):
        """int64[nl, k] peers of this rank's rows (on the complete graph,
        of its ``rows`` alone), keyed by global id."""
        if self.nbrs is None:
            return sample_peers_complete(key, self.gids[rows], topo.n, k,
                                         exclude_self)
        return sample_peers_table(key, self.gids, self.nbrs, self.deg, k,
                                  sentinel=topo.n)


def make_sharded_si_round(proto: ProtocolConfig, topo: Topology,
                          group: Group,
                          fault: Optional[FaultConfig] = None,
                          origin: int = 0):
    """The sharded round step of this rank: semantically
    :func:`~gossip_tpu_torch.models.si.make_si_round` on ``state.seen`` of
    shape ``[nl, R]`` (:func:`init_sharded_state`).  ``SimState ->
    SimState``, or under a fault program ``SimState -> (SimState, lost)``
    with ``lost`` the float32 total over ranks."""
    n, k = topo.n, proto.fanout
    mode = proto.mode
    if mode == C.SWIM:
        raise ValueError("SWIM rounds are built by models/swim.py")
    if mode == C.RUMOR:
        raise ValueError("rumor-mongering rounds are built by "
                         "parallel/sharded_rumor.py (SIR state, not SI)")
    if mode == C.FLOOD and topo.implicit:
        raise ValueError("flood mode needs an explicit neighbor table")
    NE.check_supported(fault, engine="si-xla")
    rows = _Rows(topo, group, fault, origin)
    churn = rows.sched is not None
    n_pad, gids = rows.n_pad, rows.gids
    dev = group.device

    def step(state: SimState):
        rkey = threefry.fold_in(state.key, state.round)
        alive_l, dp, cut = rows.at(state.round)
        seen = state.seen
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lost = msgs_local = zero
        visible = seen & alive_l[:, None]
        delta = torch.zeros_like(seen)

        if mode in (C.PUSH, C.PUSH_PULL):
            pkey = threefry.fold_in(rkey, si_mod.PUSH_TAG)
            targets0 = rows.sample(pkey, topo, k, proto.exclude_self)
            targets = apply_drop(rkey, si_mod.PUSH_DROP_TAG, gids, targets0,
                                 dp, n, force=churn)
            if churn:
                targets = NE.partition_targets(cut, gids, targets, n)
            sender_active = visible.any(dim=1)
            valid = (targets < n) & sender_active[:, None]
            # invalid targets go to n_pad, the row push_counts cuts off
            counts = push_counts(n_pad, torch.where(valid, targets, n_pad),
                                 visible)
            delta = delta | (group.reduce_scatter_sum(counts) > 0)
            msgs_local = msgs_local + si_mod.f32(valid.sum())
            if churn:
                lost = lost + NE.lost_count(targets0, targets,
                                            sender_active, n)

        exchange = (mode != C.ANTI_ENTROPY or proto.period <= 1
                    or state.round % proto.period == 0)
        if mode in (C.PULL, C.PUSH_PULL, C.ANTI_ENTROPY) and exchange:
            seen_all = group.all_gather(visible)
            qkey = threefry.fold_in(rkey, si_mod.PULL_TAG)
            partners0 = rows.sample(qkey, topo, k, proto.exclude_self)
            partners = apply_drop(rkey, si_mod.PULL_DROP_TAG, gids,
                                  partners0, dp, n, force=churn)
            if churn:
                partners = NE.partition_targets(cut, gids, partners, n)
            pulled = pull_merge(seen_all, partners, n)
            partners = torch.where(alive_l[:, None], partners, n)
            n_req = si_mod.f32((partners < n).sum())
            if churn:
                lost = lost + NE.lost_count(partners0, partners, alive_l, n)
            if mode == C.ANTI_ENTROPY:
                # the initiator's state scatters back into the partner's row
                back = push_counts(n_pad, torch.where(partners < n, partners,
                                                      n_pad), visible)
                delta = delta | pulled | (group.reduce_scatter_sum(back) > 0)
                msgs_local = msgs_local + 3.0 * n_req
            else:
                delta = delta | pulled
                msgs_local = msgs_local + 2.0 * n_req

        if mode == C.FLOOD:
            seen_all = group.all_gather(visible)
            nbrs = rows.nbrs
            if churn or rows.drop_prob > 0.0:
                dropped = drop_mask(rkey, si_mod.FLOOD_DROP_TAG, gids,
                                    nbrs.shape[1], dp)
                nbrs = torch.where(dropped, n, nbrs)
            if churn:
                nbrs = NE.partition_targets(cut, gids, nbrs, n)
                # lost edge uses whose sender (the neighbour read) had
                # something to say
                act = seen_all.any(dim=1)
                live = (rows.nbrs < n) & act[torch.clamp(rows.nbrs, 0,
                                                         n - 1).long()]
                lost = lost + si_mod.f32((live & (nbrs >= n)).sum())
            delta = flood_gather(seen_all, nbrs, n)
            sender_active = visible.any(dim=1)
            msgs_local = msgs_local + si_mod.f32(
                torch.where(sender_active, rows.deg, 0).sum())

        delta = delta & alive_l[:, None]
        total, lost_all = group.combine_f32(torch.stack([msgs_local, lost]))
        out = SimState(seen=seen | delta, round=state.round + 1,
                       key=state.key, msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def init_sharded_state(run: RunConfig, proto: ProtocolConfig,
                       topo: Topology, group: Group) -> SimState:
    """This rank's rows of the initial state: rumor r starts at node
    ``(origin + r) % n``; the key is ``key(run.seed)``."""
    n_pad, nl, lo = group.rows(topo.n)
    dev = group.device
    r = proto.rumors
    seen = torch.zeros(nl, r, dtype=torch.bool, device=dev)
    for col in range(r):
        node = (run.origin + col) % topo.n
        if lo <= node < lo + nl:
            seen[node - lo, col] = True
    return SimState(seen=seen, round=0, key=threefry.key(run.seed, dev),
                    msgs=torch.zeros((), dtype=torch.float32, device=dev))


class Coverage:
    """The coverage of a sharded state as the reference computes it, from
    this rank's alive rows, the global alive count, and whether the
    compiled loops fold the division (:func:`sharded_folded`).  The state
    is ``bool[nl, R]``, or with ``packed_rumors`` packed words of that
    many rumors."""

    def __init__(self, fault: Optional[FaultConfig], n: int, origin: int,
                 group: Group, packed_rumors: Optional[int] = None):
        n_pad, nl, lo = group.rows(n)
        alive = metric_alive_pad(fault, n, n_pad, origin, group.device)
        self.alive_l = alive[lo:lo + nl]
        self.total = int(alive.sum())
        self.folded = sharded_folded(fault)
        self.group = group
        self.rumors = packed_rumors

    def count(self, seen_l: torch.Tensor) -> int:
        """The exact holders of the least-held rumor over every rank."""
        if self.rumors is None:
            local = (seen_l & self.alive_l[:, None]).sum(dim=0)
        else:
            local = rumor_count_tensor(seen_l, self.rumors, self.alive_l)
        return min(self.group.all_reduce_sum(local.to(torch.int64))
                   .tolist())

    def compiled(self, seen_l: torch.Tensor) -> float:
        """The value the reference's compiled loops compare."""
        frac = f32_mean if self.folded else f32_fraction
        return frac(self.count(seen_l), self.total)

    def eager(self, seen_l: torch.Tensor) -> float:
        """The value the reference's reports carry: the quotient."""
        return f32_fraction(self.count(seen_l), self.total)


def dense_round_bytes(proto: ProtocolConfig, n_pad: int, nl: int):
    """``round -> float32`` per-device egress of one dense round (the
    reference's ``_dense_round_bytes``): the push's count table
    ``4 * n_pad * R``, the pull's all_gather ``nl * R`` bool bytes, the
    msgs sum 4, and anti-entropy's reverse table on exchange rounds
    only."""
    r, mode = proto.rumors, proto.mode
    base = 4.0
    if mode in (C.PUSH, C.PUSH_PULL):
        base += 4.0 * n_pad * r
    if mode in (C.PULL, C.PUSH_PULL, C.ANTI_ENTROPY, C.FLOOD):
        base += 1.0 * nl * r
    return exchange_bytes(proto, base, 4.0 * n_pad * r)


def exchange_bytes(proto: ProtocolConfig, base: float, reverse: float,
                   off: Optional[float] = None):
    """``round -> float32``: ``base``, plus anti-entropy's ``reverse`` on
    its exchange rounds, in the reference's float32 arithmetic; with
    ``off`` the round's bytes are ``base + reverse`` on exchange rounds
    and ``off`` on quiescent ones (the sparse exchange's)."""
    def per_round(round_: int) -> np.float32:
        if off is not None:
            return np.float32(RM.gate_on_exchange_rounds(
                base, proto.period if proto.mode == C.ANTI_ENTROPY else 1,
                round_, off))
        b = np.float32(base)
        if proto.mode == C.ANTI_ENTROPY:
            b = b + np.float32(RM.gate_on_exchange_rounds(
                reverse, proto.period, round_))
        return b

    return per_round


class SIRecorder:
    """The in-loop metrics row of the node-sharded SI drivers: the
    reference's ``_dense_recorder`` on bool rows, and with ``packed`` its
    ``_packed_recorder`` and ``_sparse_recorder`` on packed words, with
    the churn observables (:func:`~gossip_tpu_torch.ops.nemesis.
    observables` and the step's ``lost``) under a fault program.  This
    rank's count and front column are device readouts of the rows after
    the step; the previous count rides as one tensor.  ``bytes_of`` maps
    the round to its float32 bytes."""

    def __init__(self, label: str, proto: ProtocolConfig, n: int,
                 group: Group, fault: Optional[FaultConfig], origin: int,
                 max_rounds: int, bytes_of, packed: bool = False,
                 n_shards: Optional[int] = None, alive_l=None,
                 per_msg: Optional[float] = None, **stack_kw):
        dev = group.device
        n_pad, nl, lo = group.rows(n)
        self.alive_l = (metric_alive_pad(fault, n, n_pad, origin,
                                         dev)[lo:lo + nl]
                        if alive_l is None else alive_l)
        self.packed = packed
        if per_msg is None:
            per_msg = proto.rumors * RM.payload_factor(proto.mode)
        self.offered = float(np.float32(per_msg))
        self.bytes_of = bytes_of
        self.sched = None
        if NE.get(fault) is not None:
            self.sched = NE.build(fault, n, n_pad, device=dev)
            self.base_pad = pad_rows(
                NE.base_alive_or_ones(fault, n, origin, dev), n_pad, False)
        self.m = RM.init(max_rounds, n_shards or group.size, label, dev,
                         nemesis=self.sched is not None, group=group,
                         local_shards=1, **stack_kw)
        self.prev = None

    def _count(self, seen):
        count = RM.count_packed if self.packed else RM.count_bool
        return count(seen, self.alive_l)

    def start(self, state: SimState) -> None:
        self.prev = self._count(state.seen)

    def nemesis(self, s0, lost) -> dict:
        """The churn observables of the round ``s0`` started."""
        if self.sched is None:
            return {}
        alive = NE.alive_rows(self.sched, self.base_pad, s0.round)
        a, pairs = NE.observables(self.sched, alive, s0.round)
        return dict(alive=a, cut_pairs=pairs, dropped=lost)

    def __call__(self, s0: SimState, s1: SimState, lost=None) -> None:
        count = self._count(s1.seen)
        msgs = s1.msgs - s0.msgs
        front = RM.front_packed if self.packed else RM.front_bool
        RM.record(self.m, newly=count - self.prev, msgs=msgs,
                  offered=msgs * self.offered, bytes=self.bytes_of(s0.round),
                  front=front(s1.seen, self.alive_l),
                  **self.nemesis(s0, lost))
        self.prev = count

    def wrap(self, step, churn: bool):
        """The step with the row recorded after it (returning the state
        alone, as :func:`~gossip_tpu_torch.ops.nemesis.drop_lost`)."""
        def recorded(s0, **kw):
            msgs0 = s0.msgs            # s0's buffers may be donated
            out = step(s0, **kw)
            s1, lost = out if churn else (out, None)
            self(s0._replace(msgs=msgs0), s1, lost)
            return s1

        return recorded


def instrumented(step, state: SimState, fault: Optional[FaultConfig],
                 make_recorder):
    """``(step, recorder or None)``: the driver's step with the round
    metrics recorded when they are wanted (``make_recorder()`` builds the
    :class:`SIRecorder`; its start count is read from ``state``), else
    with the fault program's ``lost`` dropped."""
    churn = NE.get(fault) is not None
    if not RM.wanted():
        return NE.drop_lost(step, NE.get(fault)), None
    rec = make_recorder()
    rec.start(state)
    return rec.wrap(step, churn), rec


def run_until(step, state: SimState, cov: Coverage, run: RunConfig):
    """The reference's while-loop: step while the compiled coverage is
    below the float32 target and the round below ``run.max_rounds``.
    Returns ``(rounds, coverage, msgs, final)``, the coverage eager."""
    target = np.float32(run.target_coverage)
    while (cov.compiled(state.seen) < target
           and state.round < run.max_rounds):
        state = step(state)
    return (state.round, cov.eager(state.seen), float(state.msgs.item()),
            state)


def simulate_curve_sharded(proto: ProtocolConfig, topo: Topology,
                           run: RunConfig, group: Group,
                           fault: Optional[FaultConfig] = None):
    """Exactly ``run.max_rounds`` rounds, recording the coverage (as the
    reference's scan computes it) and the cumulative msgs after each.
    Returns ``(coverage float32[T], msgs float32[T], final_state)``."""
    state = init_sharded_state(run, proto, topo, group)
    step, rec = instrumented(
        make_sharded_si_round(proto, topo, group, fault, run.origin), state,
        fault, lambda: _dense_recorder("simulate_curve_sharded", proto,
                                       topo.n, group, fault, run))
    cov = Coverage(fault, topo.n, run.origin, group)
    covs, msgs = [], []
    for _ in range(run.max_rounds):
        state = step(state)
        covs.append(cov.compiled(state.seen))
        msgs.append(state.msgs)
    msgs = [float(m.item()) for m in msgs]
    RM.deliver(rec and rec.m)
    return (np.asarray(covs, np.float32), np.asarray(msgs, np.float32),
            state)


def _dense_recorder(label: str, proto: ProtocolConfig, n: int, group: Group,
                    fault: Optional[FaultConfig], run: RunConfig):
    n_pad, nl, _ = group.rows(n)
    return SIRecorder(label, proto, n, group, fault, run.origin,
                      run.max_rounds, dense_round_bytes(proto, n_pad, nl))


def simulate_until_sharded(proto: ProtocolConfig, topo: Topology,
                           run: RunConfig, group: Group,
                           fault: Optional[FaultConfig] = None):
    """The sharded while-loop to ``run.target_coverage`` or
    ``run.max_rounds``.  Returns ``(rounds, coverage, msgs,
    final_state)``; ``final_state`` holds this rank's rows."""
    state = init_sharded_state(run, proto, topo, group)
    step, rec = instrumented(
        make_sharded_si_round(proto, topo, group, fault, run.origin), state,
        fault, lambda: _dense_recorder("simulate_until_sharded", proto,
                                       topo.n, group, fault, run))
    cov = Coverage(fault, topo.n, run.origin, group)
    out = run_until(step, state, cov, run)
    RM.deliver(rec and rec.m)
    return out


def state_to_rank(seen, round_, key_data, msgs, rank: int, size: int,
                  device=None) -> SimState:
    """The port's state of rank ``rank`` of ``size`` from the reference's
    sharded ``SimState`` as numpy values: ``seen`` padded to the mesh
    (``bool[n_pad, R]`` or packed ``uint32[n_pad, W]``), the round, the
    key's words and msgs."""
    seen = np.asarray(seen)
    nl = seen.shape[0] // size
    return state_from_numpy(seen[rank * nl:(rank + 1) * nl], round_,
                            key_data, msgs, device)


def state_from_ranks(states) -> tuple:
    """``(seen, round, key_data, msgs)`` as the reference's numpy values,
    ``seen`` padded to the mesh, from every rank's state in rank order."""
    parts = [state_to_numpy(s) for s in states]
    return (np.concatenate([p[0] for p in parts]),) + parts[0][1:]
