"""Replicated-log gossip rounds: the pull exchange with an ordered per-key
offset payload.

The port of the JAX package's ``models/log.py`` on one device: the CRDT
round (:mod:`gossip_tpu_torch.models.crdt`) with the log payload
(:mod:`gossip_tpu_torch.ops.logs`) and the max join.  One round, in the
reference's order: the round's applied sends and commits land in their
owners' rows, every node draws its partners (threefry, ``PULL_TAG``),
the drop coin and the cut send some to the sentinel, each node merges
its partners' rows (a partner that is down serves nothing), and a node
that is down neither asks nor receives; ``msgs`` grows by
``2 * float32(requests)``.  A node that is down keeps its log.  Every
field of :class:`LogState` equals the reference's bit for bit.  Liar
programs are refused: only the CRDT and register exchanges run them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (FaultConfig, LogConfig, ProtocolConfig,
                                     RunConfig)
from gossip_tpu_torch.models.crdt import (Payload, _conv_target_count,
                                          make_pull_round, run_curve,
                                          run_until)
from gossip_tpu_torch.models.si import topology_device
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import logs as LG
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.topology.generators import Topology


class LogState(NamedTuple):
    """``val`` is the ``int32[N, K*(C+1)]`` entry planes and committed
    vector."""

    val: torch.Tensor
    round: int
    base_key: torch.Tensor   # int64[2]: the key's threefry words
    msgs: torch.Tensor       # float32 0-d


def init_log_state(run: RunConfig, cfg: LogConfig, n: int,
                   device=None) -> LogState:
    """All-zero state: sends and commits land in the round loop."""
    dev = resolve_device(device)
    return LogState(
        val=torch.zeros((n, LG.state_width(cfg)), dtype=torch.int32,
                        device=dev),
        round=0, base_key=threefry.key(run.seed, dev),
        msgs=torch.zeros((), dtype=torch.float32, device=dev))


def check_injections_reachable(cfg: LogConfig, run: RunConfig) -> None:
    """Every scripted send and commit must fire inside the run."""
    last = cfg.horizon() - 1
    if last >= run.max_rounds:
        raise ValueError(
            f"log send/commit at round {last} can never fire: the run "
            f"stops after max_rounds={run.max_rounds} rounds, so "
            "ground truth would be unreachable by construction — "
            "raise --max-rounds past the last scripted round")


def check_log_mode(proto: ProtocolConfig) -> None:
    """Pull only, in the reference's words."""
    if proto.mode != C.PULL:
        raise ValueError(
            "replicated-log rounds run the pull exchange only "
            "(state-based merge IS the digest pull; got mode "
            f"{proto.mode!r} — the push half would need a scatter-max "
            "collective XLA does not have, the models/crdt precedent)")


def log_payload(cfg: LogConfig, proto: ProtocolConfig, topo: Topology,
                fault: Optional[FaultConfig], origin: int, dev) -> Payload:
    """The log's :class:`~gossip_tpu_torch.models.crdt.Payload` (the
    checks of :func:`make_log_round`, which the sharded round shares)."""
    check_log_mode(proto)
    n = topo.n
    NE.check_supported(fault, engine="log-pull")
    inj = LG.inject_args(cfg, n, dev)

    def inject(val, r, lo):
        return LG.apply_injections(cfg, val, inj, r, n, origin, fault, lo)

    def pull(src, partners, gids, r, serve):
        return LG.pull_merge_log(src, partners, n, serve=serve)

    return Payload(CR.merge_max, inject,
                   CR.injection_rounds(inj[2], inj[6]), pull,
                   LG.state_width(cfg))


def make_log_round(cfg: LogConfig, proto: ProtocolConfig, topo: Topology,
                   fault: Optional[FaultConfig] = None, origin: int = 0,
                   device=None):
    """The single-device round on ``device``: ``step(state,
    donate=False)`` returns the next :class:`LogState`, or under a fault
    program ``(state, lost)`` (``donate``: as
    :func:`~gossip_tpu_torch.models.crdt.make_crdt_round`)."""
    dev = topology_device(topo, device)
    return make_pull_round(log_payload(cfg, proto, topo, fault, origin, dev),
                           proto, topo, fault, origin, dev)


def _setup(cfg, proto, topo, run, fault, device):
    check_injections_reachable(cfg, run)
    dev = topology_device(topo, device)
    step = NE.drop_lost(make_log_round(cfg, proto, topo, fault, run.origin,
                                       dev), NE.get(fault))
    n = topo.n
    truth = LG.ground_truth(cfg, LG.inject_args(cfg, n, dev), fault, n,
                            run.origin)
    eventual = LG.eventual_alive_crdt(fault, n, run.origin, dev)
    denom = max(1, int(eventual.sum()))
    return (step, functools.partial(init_log_state, run, cfg, n, dev), truth,
            eventual, denom)


def simulate_curve_log(cfg: LogConfig, proto: ProtocolConfig,
                       topo: Topology, run: RunConfig,
                       fault: Optional[FaultConfig] = None, device=None):
    """Exactly ``run.max_rounds`` rounds.  Returns ``(log_conv
    float64[T], msgs float32[T], final_state, truth_summary)``."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, device)
    counts, msgs, state = run_curve(step, init, truth, eventual,
                                    run.max_rounds)
    return counts / denom, msgs, state, LG.truth_summary(cfg, truth)


def simulate_until_log(cfg: LogConfig, proto: ProtocolConfig,
                       topo: Topology, run: RunConfig,
                       fault: Optional[FaultConfig] = None, device=None):
    """Rounds until the converged-node count reaches the integer target
    or ``run.max_rounds``.  Returns ``(rounds, log_conv, msgs,
    final_state, truth_summary)``."""
    step, init, truth, eventual, denom = _setup(
        cfg, proto, topo, run, fault, device)
    state, count = run_until(step, init, truth, eventual,
                             _conv_target_count(run, denom), run.max_rounds)
    return (state.round, count / denom, float(state.msgs.item()), state,
            LG.truth_summary(cfg, truth))
