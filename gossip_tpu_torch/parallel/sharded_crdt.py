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

import torch

from gossip_tpu_torch.config import (CrdtConfig, FaultConfig, ProtocolConfig,
                                     RunConfig)
from gossip_tpu_torch.models import crdt as M
from gossip_tpu_torch.models.si import PULL_DROP_TAG, PULL_TAG, f32
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.sampling import apply_drop
from gossip_tpu_torch.parallel.group import Group, pad_rows
from gossip_tpu_torch.parallel.sharded import _Rows
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


def curve_loop(step, init, truth, eventual, run: RunConfig, group: Group):
    """Exactly ``run.max_rounds`` sharded rounds: ``(conv float64[T],
    msgs float32[T], final_state)``, the converged counts summed over
    the ranks and divided once on the host."""
    denom = max(1, int(eventual.sum()))
    counts, msgs, state = M.run_curve(step, init, truth,
                                      eventual_rows(eventual, group),
                                      run.max_rounds, group)
    return counts / denom, msgs, state


def until_loop(step, init, truth, eventual, run: RunConfig, group: Group):
    """Sharded rounds until the converged count over the ranks reaches
    the integer target or ``run.max_rounds``: ``(rounds, conv, msgs,
    final_state)``."""
    denom = max(1, int(eventual.sum()))
    state, count = M.run_until(step, init, truth,
                               eventual_rows(eventual, group),
                               M._conv_target_count(run, denom),
                               run.max_rounds, group)
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


def _setup(cfg, proto, topo, run, group, fault, defend):
    M.check_injections_reachable(cfg, run)
    dev, n = group.device, topo.n
    step = NE.drop_lost(make_sharded_crdt_round(cfg, proto, topo, group,
                                                fault, run.origin, defend),
                        NE.get(fault))
    truth = CR.ground_truth(cfg, CR.inject_args(cfg, n, dev), fault, n,
                            run.origin, dev)
    eventual = CR.eventual_alive_crdt(fault, n, run.origin, dev)
    init = functools.partial(init_sharded_crdt_state, run, cfg, topo, group)
    return step, init, truth, eventual


def simulate_curve_crdt_sharded(cfg: CrdtConfig, proto: ProtocolConfig,
                                topo: Topology, run: RunConfig, group: Group,
                                fault: Optional[FaultConfig] = None,
                                defend: bool = False):
    """Exactly ``run.max_rounds`` sharded rounds.  Returns ``(value_conv
    float64[T], msgs float32[T], final_state, truth_value)``, the state
    this rank's rows."""
    step, init, truth, eventual = _setup(cfg, proto, topo, run, group,
                                         fault, defend)
    conv, msgs, state = curve_loop(step, init, truth, eventual, run, group)
    return conv, msgs, state, M.truth_scalar(cfg, truth, topo.n)


def simulate_until_crdt_sharded(cfg: CrdtConfig, proto: ProtocolConfig,
                                topo: Topology, run: RunConfig, group: Group,
                                fault: Optional[FaultConfig] = None,
                                defend: bool = False):
    """Sharded rounds until the converged-node count reaches the integer
    target or ``run.max_rounds``.  Returns ``(rounds, value_conv, msgs,
    final_state, truth_value)``, the state this rank's rows."""
    step, init, truth, eventual = _setup(cfg, proto, topo, run, group,
                                         fault, defend)
    return until_loop(step, init, truth, eventual, run, group) + (
        M.truth_scalar(cfg, truth, topo.n),)
