"""CRDT gossip rounds: the pull exchange with a commutative-merge payload.

The port of the JAX package's ``models/crdt.py`` on one device.  The
payload replaces the infected bit; the fabric is the XLA engine's:
threefry partner draws (``PULL_TAG``), drop coins (``PULL_DROP_TAG``),
the nemesis schedule's liveness, drop probability and partition cut.
One round, in the reference's order:

1. the round's applied injections land in their owners' rows (an add
   gossips in its own round);
2. every node draws ``fanout`` partners, the drop coin and the cut send
   some to the sentinel;
3. each node merges its partners' rows (a partner that is down serves
   nothing; under a liar program the liars' rows are transformed, and
   with ``defend=True`` the defended admission filters them);
4. a node that is down neither asks nor receives; ``msgs`` grows by
   ``2 * float32(requests)`` (request and response).

A node that is down keeps its state and serves it again once it is
back.  Every field of :class:`CrdtState` equals the reference's bit for
bit.  The exchange works on blocks of destination rows
(:func:`~gossip_tpu_torch.ops.crdt.block_rows_for`), so a round holds the
state, its successor and one block.  Pull only: state-based merge is
the digest pull.  The three payloads (CRDTs, logs, registers) share the
round as a :class:`Payload`; the node-sharded round
(:mod:`gossip_tpu_torch.parallel.sharded_crdt`) shares its
:func:`blocked_exchange`, with the gathered table as the source.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (CrdtConfig, FaultConfig, ProtocolConfig,
                                     RunConfig)
from gossip_tpu_torch.models.si import (PULL_DROP_TAG, PULL_TAG, f32,
                                        round_schedule, topology_device)
from gossip_tpu_torch.models.state import alive_mask
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.ops.sampling import apply_drop, sample_peers
from gossip_tpu_torch.topology.generators import Topology


class CrdtState(NamedTuple):
    """``val`` is ``int32[N, S]`` counter shards or ``[N, 2W]`` packed
    set planes (the reference's uint32 bits as int32)."""

    val: torch.Tensor
    round: int
    base_key: torch.Tensor   # int64[2]: the key's threefry words
    msgs: torch.Tensor       # float32 0-d


def init_crdt_state(run: RunConfig, cfg: CrdtConfig, n: int,
                    device=None) -> CrdtState:
    """All-zero state: injections land in the round loop at their
    rounds."""
    dev = resolve_device(device)
    return CrdtState(
        val=torch.zeros((n, CR.state_width(cfg, n)), dtype=torch.int32,
                        device=dev),
        round=0, base_key=threefry.key(run.seed, dev),
        msgs=torch.zeros((), dtype=torch.float32, device=dev))


def check_injections_reachable(cfg, run: RunConfig) -> None:
    """Every scripted injection must fire inside the run, or the truth
    is unreachable by construction."""
    last = cfg.horizon() - 1
    if last >= run.max_rounds:
        raise ValueError(
            f"injection at round {last} can never fire: the run stops "
            f"after max_rounds={run.max_rounds} rounds, so ground "
            "truth would be unreachable by construction — raise "
            "--max-rounds past the last scripted round")


def check_crdt_mode(proto: ProtocolConfig) -> None:
    """Pull only, in the reference's words."""
    if proto.mode != C.PULL:
        raise ValueError(
            "CRDT rounds run the pull exchange only (state-based merge "
            f"IS the digest pull; got mode {proto.mode!r} — the push "
            "half would need a scatter-max/scatter-OR collective XLA "
            "does not have, the models/si_packed.py precedent)")


def check_byz_defendable(cfg, fault, fanout: int, defend: bool) -> None:
    """``defend=True`` needs a liar program, and a defended packed-set
    run needs ``fanout >= quorum`` (the reference's words)."""
    bz = NE.get_byz(fault)
    if defend and bz is None:
        raise ValueError(
            "defend=True without a byzantine program: the defended "
            "admission changes the exchange (owner-direct "
            "propagation), so there is nothing it would be defending "
            "against — script liars with --byz, or drop --defend")
    if (defend and bz is not None and cfg is not None
            and getattr(cfg, "kind", None) in C.CRDT_SET_KINDS
            and fanout < bz.quorum):
        raise ValueError(
            f"defended packed-set exchange with fanout={fanout} < "
            f"quorum={bz.quorum}: a bit echoed by fewer "
            "partners than are even sampled per round can never meet "
            "the quorum — raise --fanout or lower ByzConfig.quorum")


class Payload(NamedTuple):
    """What a payload brings to the shared pull round: ``join(a, b,
    out=None)``, its join (max, OR or the LWW join) of a receiver's row
    with what it pulled (the all-zero row when it is down);
    ``inject(val, r, lo)``, which merges round ``r``'s applied
    injections into ``val`` (the rows of the global ids ``[lo, lo +
    len(val))``) in place, called on the rounds in ``inject_rounds``
    only; ``pull(src, partners, gids, r, serve)``, the merge of the
    partners' rows of ``src`` for the destination rows of the global ids
    ``gids`` (``serve``: bool over ``src``'s rows, who serves, or None);
    and ``width``, the state's column count, which sizes the blocks."""

    join: object
    inject: object
    inject_rounds: frozenset
    pull: object
    width: int


def crdt_payload(cfg: CrdtConfig, proto: ProtocolConfig, topo: Topology,
                 fault: Optional[FaultConfig], origin: int, defend: bool,
                 dev) -> Payload:
    """The CRDT kinds' :class:`Payload` (the checks of
    :func:`make_crdt_round`, which the sharded round shares)."""
    check_crdt_mode(proto)
    n, k = topo.n, proto.fanout
    if cfg.kind == C.VCLOCK:
        raise ValueError("vclock has no exchange driver (merge kernel "
                         "+ tick only — ops/crdt); run gcounter/"
                         "pncounter/gset/orset")
    NE.check_supported(fault, engine="crdt-pull", byz=True)
    check_byz_defendable(cfg, fault, k, defend)
    kind = cfg.kind
    width = CR.state_width(cfg, n)
    bz = NE.get_byz(fault)
    inj = CR.inject_args(cfg, n, dev)
    alive_fn = CR.alive_at_fn(fault, n, origin, dev)
    eventual = CR.eventual_alive_crdt(fault, n, origin, dev)
    if bz is not None:
        byzt = NE.build_byz(fault, n, device=dev)
        set_tables = {} if kind not in C.CRDT_SET_KINDS else dict(
            own_words=CR.set_owner_words(cfg.elements, n, origin, dev),
            universe=CR._set_universe(cfg.elements, width, dev))

    def inject(val, r, lo):
        return CR.apply_injections(cfg, val, inj, r, n, origin, alive_fn,
                                   eventual, lo)

    def pull(src, partners, gids, r, serve):
        if bz is None:
            return CR.pull_merge_crdt(kind, src, partners, n, serve=serve)
        return CR.pull_merge_crdt_byz(
            cfg, src, partners, n, byz=byzt, round_=r, gids=gids, n=n,
            origin=origin, alive_fn=alive_fn, defend=defend, serve=serve,
            **set_tables)

    return Payload(functools.partial(CR.merge, kind), inject,
                   CR.injection_rounds(*CR.inject_round_operands(cfg, inj)),
                   pull, width)


def make_crdt_round(cfg: CrdtConfig, proto: ProtocolConfig, topo: Topology,
                    fault: Optional[FaultConfig] = None, origin: int = 0,
                    defend: bool = False, device=None):
    """The single-device round on ``device`` (default: the topology's
    table's, or CUDA): ``step(state, donate=False)`` returns the next
    :class:`CrdtState`, or under a fault program ``(state, lost)``.
    ``donate=True`` lets the step write the round's injections into
    ``state.val`` in place (the loops pass it; a caller that keeps the
    old state does not).  ``step.exchange``: the round's exchange alone
    (:func:`make_pull_round`)."""
    dev = topology_device(topo, device)
    return make_pull_round(
        crdt_payload(cfg, proto, topo, fault, origin, defend, dev), proto,
        topo, fault, origin, dev)


def blocked_exchange(payload: Payload, rows_per: int, src, dst, partners,
                     gids, r, alive, serve):
    """The exchange of a round: the successor of the destination rows
    ``dst`` (the global ids ``gids``), each joined with what it pulls
    from the source table ``src`` through ``partners`` (the final
    partners, one row a destination), on blocks of ``rows_per``
    destination rows (module doc).  ``alive`` (bool over the
    destinations, or None) zeroes what a node that is down receives;
    ``serve`` (bool over ``src``'s rows, or None) says who serves."""
    new = torch.empty_like(dst)
    nl = dst.shape[0]
    for a in range(0, nl, rows_per):
        b = min(nl, a + rows_per)
        pulled = payload.pull(src, partners[a:b], gids[a:b], r, serve)
        if alive is not None:     # a node that is down receives nothing
            pulled.masked_fill_(~alive[a:b, None], 0)
        payload.join(dst[a:b], pulled, out=new[a:b])
    return new


def make_pull_round(payload: Payload, proto: ProtocolConfig, topo: Topology,
                    fault: Optional[FaultConfig], origin: int, dev):
    """The single-device pull round the payloads share (module doc), as
    ``step(state, donate=False)``: the round's injections go into a copy
    of ``state.val`` (into ``state.val`` itself with ``donate``), then
    the :func:`blocked_exchange` over the whole state.  The state is any
    of the payloads' states (``val``, ``round``, ``base_key``,
    ``msgs``).

    ``step.exchange(val, partners, r, alive)`` is the step's own blocked
    exchange, the successor ``val`` from the final partners and the
    round's ``alive`` row (None: no liveness mask), so it can be timed
    alone."""
    n, k = topo.n, proto.fanout
    rows_per = CR.block_rows_for(payload.width, k)
    sched = round_schedule(fault, n, dev)
    churn = sched is not None
    drop_prob = 0.0 if fault is None else fault.drop_prob
    static_alive = (NE.base_alive_or_ones(fault, n, origin, dev) if churn
                    else alive_mask(fault, n, origin, dev))
    ids = torch.arange(n, dtype=torch.int64, device=dev)

    def exchange(val, partners, r, alive):
        # one table: the source is the state, and who is up serves
        return blocked_exchange(payload, rows_per, val, val, partners, ids,
                                r, alive, alive)

    def step(state, donate: bool = False):
        r = state.round
        rkey = threefry.fold_in(state.base_key, r)
        if churn:
            alive = NE.alive_rows(sched, static_alive, r)
            dp = NE.drop_at(sched, r)
            cut = NE.cut_at(sched, r)
        else:
            alive, dp = static_alive, drop_prob
        val = state.val
        if r in payload.inject_rounds:
            val = payload.inject(val if donate else val.clone(), r, 0)
        partners0 = sample_peers(threefry.fold_in(rkey, PULL_TAG), ids,
                                 topo, k, proto.exclude_self)
        partners = apply_drop(rkey, PULL_DROP_TAG, ids, partners0, dp, n,
                              force=churn)
        if churn:
            partners = NE.partition_targets(cut, ids, partners, n)
        new = exchange(val, partners, r, alive)
        if alive is not None:         # a node that is down asks nothing
            partners = torch.where(alive[:, None], partners, n)
        out = state._replace(val=new, round=r + 1,
                             msgs=state.msgs + 2.0 * f32((partners < n).sum()))
        if churn:
            return out, NE.lost_count(partners0, partners, alive, n)
        return out

    step.exchange = exchange
    return step


def run_curve(step, init, truth, eventual, rounds: int, group=None):
    """Exactly ``rounds`` rounds from ``init()``: ``(converged counts
    int64[T], msgs float32[T], final state)``, read from the device once
    at the end.  The loops make their first state themselves, so no
    caller's frame keeps it alive: a round holds only the state and its
    successor.  With a ``group`` the state is a rank's rows, ``eventual``
    their share of the eventual-alive set, and the counts are summed
    over the ranks once, at the end."""
    state = init()
    counts, msgs = [], []
    for _ in range(rounds):
        state = step(state, donate=True)
        counts.append(CR.converged_count(state.val, truth, eventual))
        msgs.append(state.msgs)
    counts = torch.stack(counts)
    if group is not None:
        counts = group.all_reduce_sum(counts)
    return (counts.cpu().numpy().astype(np.int64),
            torch.stack(msgs).cpu().numpy().astype(np.float32), state)


def run_until(step, init, truth, eventual, target: int, max_rounds: int,
              group=None):
    """Rounds from ``init()`` until the converged count reaches
    ``target`` or ``max_rounds``, one host read a round: ``(final state,
    count)``.  With a ``group``: as :func:`run_curve`, the count summed
    over the ranks every round."""
    def count(val):
        c = CR.converged_count(val, truth, eventual)
        return int(c if group is None else group.all_reduce_sum(c))

    state = init()
    total = count(state.val)
    while total < target and state.round < max_rounds:
        state = step(state, donate=True)
        total = count(state.val)
    return state, total


def _conv_target_count(run: RunConfig, eventual_total: int) -> int:
    """The integer stop target: the converged-node count that meets
    ``run.target_coverage`` of the eventual-alive total."""
    return min(eventual_total,
               math.ceil(run.target_coverage * eventual_total - 1e-9))


def truth_scalar(cfg: CrdtConfig, truth, n: int) -> int:
    """The readable truth: the counter value, or the member count."""
    truth = truth.detach().cpu().numpy().astype(np.int64)
    if cfg.kind in C.CRDT_COUNTER_KINDS:
        if cfg.kind == C.PNCOUNTER:
            return int(truth[:n].sum() - truth[n:].sum())
        return int(truth.sum())
    w = truth.shape[0] // 2
    members = (truth[:w] & ~truth[w:]) & 0xFFFFFFFF
    return int(sum(bin(int(x)).count("1") for x in members))


def _setup(cfg, proto, topo, run, fault, defend, device):
    check_injections_reachable(cfg, run)
    dev = topology_device(topo, device)
    step = NE.drop_lost(make_crdt_round(cfg, proto, topo, fault, run.origin,
                                        defend, dev),
                        NE.get(fault))
    n = topo.n
    truth = CR.ground_truth(cfg, CR.inject_args(cfg, n, dev), fault, n,
                            run.origin, dev)
    eventual = CR.eventual_alive_crdt(fault, n, run.origin, dev)
    denom = max(1, int(eventual.sum()))
    return (step, functools.partial(init_crdt_state, run, cfg, n, dev), truth,
            eventual, denom)


def simulate_curve_crdt(cfg: CrdtConfig, proto: ProtocolConfig,
                        topo: Topology, run: RunConfig,
                        fault: Optional[FaultConfig] = None,
                        defend: bool = False, device=None):
    """Exactly ``run.max_rounds`` rounds, recording the converged-node
    count and msgs after each.  Returns ``(value_conv float64[T],
    msgs float32[T], final_state, truth_value)``, the counts divided
    once on the host."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, defend, device)
    counts, msgs, state = run_curve(step, init, truth, eventual,
                                    run.max_rounds)
    return counts / denom, msgs, state, truth_scalar(cfg, truth, topo.n)


def simulate_until_crdt(cfg: CrdtConfig, proto: ProtocolConfig,
                        topo: Topology, run: RunConfig,
                        fault: Optional[FaultConfig] = None,
                        defend: bool = False, device=None):
    """Rounds until the converged-node count reaches the integer target
    (``target_coverage`` of the eventual-alive set) or
    ``run.max_rounds``.  Returns ``(rounds, value_conv, msgs,
    final_state, truth_value)``."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, defend, device)
    state, count = run_until(step, init, truth, eventual,
                             _conv_target_count(run, denom), run.max_rounds)
    return (state.round, count / denom, float(state.msgs.item()), state,
            truth_scalar(cfg, truth, topo.n))
