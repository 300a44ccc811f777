"""LWW-register gossip rounds: the pull exchange with the transaction
payload.

The port of the JAX package's ``models/register.py`` on one device: the
log round (:mod:`gossip_tpu_torch.models.log`) with the register payload
(:mod:`gossip_tpu_torch.ops.registers`) and the LWW join, through the
shared :func:`~gossip_tpu_torch.models.crdt.make_pull_round`.  One round,
in the reference's order: the round's applied writes are joined into
their owners' entries (a write gossips in its own round), every node
draws its partners (threefry, ``PULL_TAG``), the drop coin
(``PULL_DROP_TAG``) and the cut send some to the sentinel, each node
joins its partners' rows (a partner that is down serves nothing; under a
liar program the liars' rows are rendered, and ``defend=True`` admits
only owner-direct entries that claim no future round), and a node that
is down neither asks nor receives; ``msgs`` grows by
``2 * float32(requests)``.  A node that is down keeps its registers.
Every field of :class:`RegState` equals the reference's bit for bit.
Pull only, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TxnConfig)
from gossip_tpu_torch.models.crdt import (Payload, _conv_target_count,
                                          check_byz_defendable,
                                          make_pull_round, run_curve,
                                          run_until)
from gossip_tpu_torch.models.si import topology_device
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import registers as RG
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.topology.generators import Topology


class RegState(NamedTuple):
    """``val`` is the ``int32[N, 2K]`` value planes and timestamp
    planes."""

    val: torch.Tensor
    round: int
    base_key: torch.Tensor   # int64[2]: the key's threefry words
    msgs: torch.Tensor       # float32 0-d


def init_reg_state(run: RunConfig, cfg: TxnConfig, n: int,
                   device=None) -> RegState:
    """All-zero state: writes land in the round loop at their rounds."""
    dev = resolve_device(device)
    return RegState(
        val=torch.zeros((n, RG.state_width(cfg)), dtype=torch.int32,
                        device=dev),
        round=0, base_key=threefry.key(run.seed, dev),
        msgs=torch.zeros((), dtype=torch.float32, device=dev))


def check_writes_reachable(cfg: TxnConfig, run: RunConfig) -> None:
    """Every scripted write must fire inside the run, or the truth is
    unreachable by construction."""
    last = cfg.horizon() - 1
    if last >= run.max_rounds:
        raise ValueError(
            f"txn write at round {last} can never fire: the run "
            f"stops after max_rounds={run.max_rounds} rounds, so "
            "ground truth would be unreachable by construction — "
            "raise --max-rounds past the last scripted round")


def check_txn_mode(proto: ProtocolConfig) -> None:
    """Pull only, in the reference's words."""
    if proto.mode != C.PULL:
        raise ValueError(
            "LWW-register rounds run the pull exchange only "
            "(state-based merge IS the digest pull; got mode "
            f"{proto.mode!r} — the push half would need a "
            "scatter-argmax collective XLA does not have, the "
            "models/crdt and models/log precedent)")


def register_payload(cfg: TxnConfig, proto: ProtocolConfig, topo: Topology,
                     fault: Optional[FaultConfig], origin: int, defend: bool,
                     dev) -> Payload:
    """The registers' :class:`~gossip_tpu_torch.models.crdt.Payload` (the
    checks of :func:`make_register_round`, which the sharded round
    shares)."""
    check_txn_mode(proto)
    n, k = topo.n, proto.fanout
    NE.check_supported(fault, engine="txn-pull", byz=True)
    check_byz_defendable(None, fault, k, defend)
    inj = RG.inject_args(cfg, n, dev)
    bz = NE.get_byz(fault)
    if bz is not None:
        byzt = NE.build_byz(fault, n, device=dev)
        alive_fn = RG.alive_at_fn(fault, n, origin, dev)

    def inject(val, r, lo):
        return RG.apply_injections(cfg, val, inj, r, n, origin, fault, lo)

    def pull(src, partners, gids, r, serve):
        if bz is None:
            return RG.pull_merge_reg(src, partners, n, serve=serve)
        return RG.pull_merge_reg_byz(
            src, partners, n, byz=byzt, round_=r, gids=gids, n=n,
            alive_fn=alive_fn, defend=defend, serve=serve)

    return Payload(RG.merge_lww, inject, RG.injection_rounds(inj[2]), pull,
                   RG.state_width(cfg))


def make_register_round(cfg: TxnConfig, proto: ProtocolConfig,
                        topo: Topology, fault: Optional[FaultConfig] = None,
                        origin: int = 0, defend: bool = False, device=None):
    """The single-device round on ``device``: ``step(state,
    donate=False)`` returns the next :class:`RegState`, or under a fault
    program ``(state, lost)`` (``donate``: as
    :func:`~gossip_tpu_torch.models.crdt.make_crdt_round`).  Events,
    partition windows, drop ramps and liars run; ``defend=True`` needs a
    liar program.  ``step.exchange``: the round's exchange alone."""
    dev = topology_device(topo, device)
    return make_pull_round(
        register_payload(cfg, proto, topo, fault, origin, defend, dev),
        proto, topo, fault, origin, dev)


def _setup(cfg, proto, topo, run, fault, defend, device):
    check_writes_reachable(cfg, run)
    dev = topology_device(topo, device)
    step = NE.drop_lost(make_register_round(cfg, proto, topo, fault,
                                            run.origin, defend, dev),
                        NE.get(fault))
    n = topo.n
    truth = RG.ground_truth(cfg, RG.inject_args(cfg, n, dev), fault, n,
                            run.origin)
    eventual = RG.eventual_alive_crdt(fault, n, run.origin, dev)
    denom = max(1, int(eventual.sum()))
    return (step, functools.partial(init_reg_state, run, cfg, n, dev), truth,
            eventual, denom)


def simulate_curve_txn(cfg: TxnConfig, proto: ProtocolConfig,
                       topo: Topology, run: RunConfig,
                       fault: Optional[FaultConfig] = None,
                       defend: bool = False, device=None):
    """Exactly ``run.max_rounds`` rounds, recording the converged-node
    count and msgs after each.  Returns ``(txn_conv float64[T], msgs
    float32[T], final_state, truth_summary)``, the counts divided once
    on the host."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, defend, device)
    counts, msgs, state = run_curve(step, init, truth, eventual,
                                    run.max_rounds)
    return (counts / denom, msgs, state,
            RG.truth_summary(cfg, truth, topo.n))


def simulate_until_txn(cfg: TxnConfig, proto: ProtocolConfig,
                       topo: Topology, run: RunConfig,
                       fault: Optional[FaultConfig] = None,
                       defend: bool = False, device=None):
    """Rounds until the converged-node count reaches the integer target
    (``target_coverage`` of the eventual-alive set) or
    ``run.max_rounds``.  Returns ``(rounds, txn_conv, msgs, final_state,
    truth_summary)``."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, defend, device)
    state, count = run_until(step, init, truth, eventual,
                             _conv_target_count(run, denom), run.max_rounds)
    return (state.round, count / denom, float(state.msgs.item()), state,
            RG.truth_summary(cfg, truth, topo.n))
