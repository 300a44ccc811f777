"""Node-dimension sharding of the payload rounds: CRDTs, and the pull
round the three payloads share.

The port of the JAX package's ``parallel/sharded_crdt.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`.  Each rank holds the
``[nl, S]`` rows of its global ids ``[lo, lo + nl)`` and draws every
random number keyed by the global id, so the trajectory is bitwise the
single-device one whatever the mesh.  One round, in the reference's
order:

1. the round's applied injections whose owner is one of the rank's
   nodes land in its rows (``Payload.inject`` with the window's ``lo``);
2. the rows are all-gathered into the whole ``[n_pad, S]`` table, the
   round's one collective beside the float32 ``msgs`` and ``lost``;
3. each rank pulls its nodes' partners' rows from the gathered table
   through the single-device round's own blocked exchange
   (:func:`~gossip_tpu_torch.models.crdt.blocked_exchange`), the table
   as the source and the rank's rows as the destinations.  The
   reference gathers the masked ``where(alive, val, 0)``; the port
   gathers the rows as they are and passes the round's replicated
   liveness as ``serve``, which zeroes a down partner's row in the
   gather exactly as the masked table does (and a down liar serves
   nothing, as its transform is gated by the same liveness), without a
   masked copy of the state;
4. ``msgs`` grows by the ranks' float32 ``2 * requests`` added in rank
   order (:meth:`Group.combine_f32`), and so does ``lost`` under a
   program.

Convergence is the integer count of eventual-alive nodes whose row
equals the truth, summed over the ranks and divided once on the host.

Memory: a rank holds its rows, the gathered table (the whole state), its
rows' successor and one block, so sharding a state over K ranks does not
bring a rank's share below one whole state (the reference's design).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (CrdtConfig, FaultConfig, ProtocolConfig,
                                     RunConfig)
from gossip_tpu_torch.models import crdt as M
from gossip_tpu_torch.models.si import PULL_DROP_TAG, PULL_TAG, f32
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.sampling import apply_drop
from gossip_tpu_torch.parallel.group import Group, pad_rows
from gossip_tpu_torch.parallel.sharded import SIRecorder, _Rows
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_pull_round(payload: M.Payload, proto: ProtocolConfig,
                            topo: Topology, group: Group,
                            fault: Optional[FaultConfig] = None,
                            origin: int = 0):
    """The sharded pull round of this rank (module doc) as ``step(state,
    donate=False)``: semantically
    :func:`~gossip_tpu_torch.models.crdt.make_pull_round` on the rank's
    rows.  Under a fault program it returns ``(state, lost)``, ``lost``
    the float32 total over ranks."""
    n, k = topo.n, proto.fanout
    rows = _Rows(topo, group, fault, origin)
    rows_per = CR.block_rows_for(payload.width, k)
    churn = rows.sched is not None
    gids = rows.gids

    def step(state, donate: bool = False):
        r = state.round
        rkey = threefry.fold_in(state.base_key, r)
        alive_l, dp, cut = rows.at(r)
        val = state.val
        if r in payload.inject_rounds:
            val = payload.inject(val if donate else val.clone(), r, rows.lo)
        src = group.all_gather(val)
        partners0 = rows.sample(threefry.fold_in(rkey, PULL_TAG), topo, k,
                                proto.exclude_self)
        partners = apply_drop(rkey, PULL_DROP_TAG, gids, partners0, dp, n,
                              force=churn)
        if churn:
            partners = NE.partition_targets(cut, gids, partners, n)
        new = M.blocked_exchange(payload, rows_per, src, val, partners,
                                 gids, r, alive_l, rows.alive_full(r))
        del src
        partners = torch.where(alive_l[:, None], partners, n)
        zero = torch.zeros((), dtype=torch.float32, device=group.device)
        lost = (NE.lost_count(partners0, partners, alive_l, n) if churn
                else zero)
        total, lost_all = group.combine_f32(torch.stack(
            [2.0 * f32((partners < n).sum()), lost]))
        out = state._replace(val=new, round=r + 1, msgs=state.msgs + total)
        return (out, lost_all) if churn else out

    return step


def zero_rows(state_cls, run: RunConfig, width: int, n: int, group: Group):
    """This rank's rows of a payload's all-zero initial state
    ``state_cls`` (``val`` ``int32[nl, width]``, the key
    ``key(run.seed)``): injections land in the round loop."""
    _, nl, _ = group.rows(n)
    dev = group.device
    return state_cls(val=torch.zeros((nl, width), dtype=torch.int32,
                                     device=dev),
                     round=0, base_key=threefry.key(run.seed, dev),
                     msgs=torch.zeros((), dtype=torch.float32, device=dev))


def eventual_rows(eventual: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's share of the eventual-alive set (padding rows out)."""
    n_pad, nl, lo = group.rows(eventual.shape[0])
    return pad_rows(eventual, n_pad, False)[lo:lo + nl]


class PayloadRecorder(SIRecorder):
    """The reference's ``_crdt_recorder``, ``sharded_log._log_recorder``
    and ``sharded_register._txn_recorder``: ``newly`` the growth of the
    payload's merged mass (``mass(rows, alive)``, exact: it only grows
    under the join), ``offered`` a pull's full-state response of
    ``width`` columns, ``bytes`` the state all_gather ``4 * nl * width``
    and the msgs sum, ``front`` each shard's eventual-alive nodes holding
    anything, and ``kind``'s converged fraction (with ``byz`` the honest
    one, ``(count_fn, honest mask)``) from this rank's converged counts,
    summed at the flush and divided by the total as the reference's
    compiled loop does: a product with the float32 reciprocal of its
    compile-time total.  A payload starts from all-zero rows: mass 0."""

    def __init__(self, label: str, kind: str, n: int, group: Group, fault,
                 origin: int, max_rounds: int, width: int, mass, truth,
                 eventual, byz=None):
        _, nl, _ = group.rows(n)
        b = np.float32(4.0 + 4.0 * nl * width)
        honest = None if byz is None else eventual & byz[1]
        super().__init__(
            label, ProtocolConfig(mode=C.PULL), n, group, fault, origin,
            max_rounds, lambda round_: b,
            alive_l=eventual_rows(eventual, group),
            per_msg=width * RM.payload_factor(C.PULL), **{kind: True},
            byz=byz is not None, conv_total=int(eventual.sum()),
            byz_total=0 if honest is None else int(honest.sum()),
            folded=True)
        self.mass, self.truth = mass, truth
        self.byz_count = None if byz is None else byz[0]
        self.honest_l = (None if honest is None
                         else eventual_rows(honest, group))
        self.prev = 0

    def __call__(self, s0, s1, lost=None) -> None:
        count = self.mass(s1.val, self.alive_l)
        msgs = s1.msgs - s0.msgs
        kw = {}
        if self.byz_count is not None:
            kw["byz"] = self.byz_count(s1.val, self.truth, self.honest_l)
        RM.record(self.m, newly=count - self.prev, msgs=msgs,
                  offered=msgs * self.offered, bytes=self.bytes_of(s0.round),
                  front=RM.front_packed(s1.val, self.alive_l),
                  conv=CR.converged_count(s1.val, self.truth, self.alive_l),
                  **kw, **self.nemesis(s0, lost))
        self.prev = count


def payload_step(step, fault, make_recorder):
    """``(step, recorder or None)``: a sharded payload round with the
    round metrics recorded when they are wanted
    (:func:`~gossip_tpu_torch.parallel.sharded.instrumented` for the
    payloads, whose rows start at zero)."""
    if not RM.wanted():
        return NE.drop_lost(step, NE.get(fault)), None
    rec = make_recorder()
    return rec.wrap(step, NE.get(fault) is not None), rec


def curve_loop(step, init, truth, eventual, run: RunConfig, group: Group,
               rec=None):
    """Exactly ``run.max_rounds`` sharded rounds: ``(conv float64[T],
    msgs float32[T], final_state)``, the converged counts summed over
    the ranks and divided once on the host; ``rec``'s stack goes to the
    chokepoint."""
    denom = max(1, int(eventual.sum()))
    counts, msgs, state = M.run_curve(step, init, truth,
                                      eventual_rows(eventual, group),
                                      run.max_rounds, group)
    RM.deliver(rec and rec.m)
    return counts / denom, msgs, state


def until_loop(step, init, truth, eventual, run: RunConfig, group: Group,
               rec=None):
    """Sharded rounds until the converged count over the ranks reaches
    the integer target or ``run.max_rounds``: ``(rounds, conv, msgs,
    final_state)``."""
    denom = max(1, int(eventual.sum()))
    state, count = M.run_until(step, init, truth,
                               eventual_rows(eventual, group),
                               M._conv_target_count(run, denom),
                               run.max_rounds, group)
    RM.deliver(rec and rec.m)
    return state.round, count / denom, float(state.msgs.item()), state


def make_sharded_crdt_round(cfg: CrdtConfig, proto: ProtocolConfig,
                            topo: Topology, group: Group,
                            fault: Optional[FaultConfig] = None,
                            origin: int = 0, defend: bool = False):
    """The sharded CRDT round (counters and sets, the liar program,
    ``defend``): :func:`make_sharded_pull_round` with the CRDT payload
    (:func:`~gossip_tpu_torch.models.crdt.crdt_payload`)."""
    return make_sharded_pull_round(
        M.crdt_payload(cfg, proto, topo, fault, origin, defend,
                       group.device), proto, topo, group, fault, origin)


def init_sharded_crdt_state(run: RunConfig, cfg: CrdtConfig, topo: Topology,
                            group: Group) -> M.CrdtState:
    """This rank's rows of the all-zero CRDT state."""
    return zero_rows(M.CrdtState, run, CR.state_width(cfg, topo.n), topo.n,
                     group)


def _setup(cfg, proto, topo, run, group, fault, defend, label):
    M.check_injections_reachable(cfg, run)
    dev, n = group.device, topo.n
    truth = CR.ground_truth(cfg, CR.inject_args(cfg, n, dev), fault, n,
                            run.origin, dev)
    eventual = CR.eventual_alive_crdt(fault, n, run.origin, dev)

    def recorder():
        byz = None
        if NE.get_byz(fault) is not None:
            honest = NE.honest_mask(fault, n, dev)
            comp = CR.honest_component_mask(cfg, n, run.origin, honest)
            byz = (lambda val, t, h: CR.byz_converged_tensor(cfg, val, t, h,
                                                             comp), honest)
        return PayloadRecorder(
            label, "crdt", n, group, fault, run.origin, run.max_rounds,
            CR.state_width(cfg, n),
            lambda val, alive: CR.payload_count(cfg, val, alive), truth,
            eventual, byz)

    step, rec = payload_step(
        make_sharded_crdt_round(cfg, proto, topo, group, fault, run.origin,
                                defend), fault, recorder)
    init = functools.partial(init_sharded_crdt_state, run, cfg, topo, group)
    return step, init, truth, eventual, rec


def simulate_curve_crdt_sharded(cfg: CrdtConfig, proto: ProtocolConfig,
                                topo: Topology, run: RunConfig, group: Group,
                                fault: Optional[FaultConfig] = None,
                                defend: bool = False):
    """Exactly ``run.max_rounds`` sharded rounds.  Returns ``(value_conv
    float64[T], msgs float32[T], final_state, truth_value)``, the state
    this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, defend,
        "simulate_curve_crdt_sharded")
    conv, msgs, state = curve_loop(step, init, truth, eventual, run, group,
                                   rec)
    return conv, msgs, state, M.truth_scalar(cfg, truth, topo.n)


def simulate_until_crdt_sharded(cfg: CrdtConfig, proto: ProtocolConfig,
                                topo: Topology, run: RunConfig, group: Group,
                                fault: Optional[FaultConfig] = None,
                                defend: bool = False):
    """Sharded rounds until the converged-node count reaches the integer
    target or ``run.max_rounds``.  Returns ``(rounds, value_conv, msgs,
    final_state, truth_value)``, the state this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, defend,
        "simulate_until_crdt_sharded")
    return until_loop(step, init, truth, eventual, run, group, rec) + (
        M.truth_scalar(cfg, truth, topo.n),)
