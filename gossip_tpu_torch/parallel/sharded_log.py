"""Node-dimension sharding of the replicated-log rounds.

The port of the JAX package's ``parallel/sharded_log.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`: the sharded pull round
(:func:`~gossip_tpu_torch.parallel.sharded_crdt.make_sharded_pull_round`)
with the log payload (:func:`~gossip_tpu_torch.models.log.log_payload`:
the sends and commits of the rank's nodes, the max join).  The round's
collective is the all_gather of the ``int32[n_pad, K*(C+1)]`` table,
beside the float32 ``msgs`` and ``lost``; convergence is the integer
converged count summed over the ranks and divided once on the host.
"""

from __future__ import annotations

import functools
from typing import Optional

from gossip_tpu_torch.config import (FaultConfig, LogConfig, ProtocolConfig,
                                     RunConfig)
from gossip_tpu_torch.models import log as M
from gossip_tpu_torch.ops import logs as LG
from gossip_tpu_torch.parallel import sharded_crdt as SC
from gossip_tpu_torch.parallel.group import Group
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_log_round(cfg: LogConfig, proto: ProtocolConfig,
                           topo: Topology, group: Group,
                           fault: Optional[FaultConfig] = None,
                           origin: int = 0):
    """The sharded log round of this rank: ``step(state, donate=False)``,
    or under a fault program ``(state, lost)``."""
    return SC.make_sharded_pull_round(
        M.log_payload(cfg, proto, topo, fault, origin, group.device), proto,
        topo, group, fault, origin)


def init_sharded_log_state(run: RunConfig, cfg: LogConfig, topo: Topology,
                           group: Group) -> M.LogState:
    """This rank's rows of the all-zero log state."""
    return SC.zero_rows(M.LogState, run, LG.state_width(cfg), topo.n, group)


def _setup(cfg, proto, topo, run, group, fault, label):
    M.check_injections_reachable(cfg, run)
    dev, n = group.device, topo.n
    truth = LG.ground_truth(cfg, LG.inject_args(cfg, n, dev), fault, n,
                            run.origin)
    eventual = LG.eventual_alive_crdt(fault, n, run.origin, dev)
    step, rec = SC.payload_step(
        make_sharded_log_round(cfg, proto, topo, group, fault, run.origin),
        fault, lambda: SC.PayloadRecorder(
            label, "log", n, group, fault, run.origin, run.max_rounds,
            LG.state_width(cfg),
            lambda val, alive: LG.payload_count(cfg, val, alive), truth,
            eventual))
    init = functools.partial(init_sharded_log_state, run, cfg, topo, group)
    return step, init, truth, eventual, rec


def simulate_curve_log_sharded(cfg: LogConfig, proto: ProtocolConfig,
                               topo: Topology, run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None):
    """Exactly ``run.max_rounds`` sharded rounds.  Returns ``(log_conv
    float64[T], msgs float32[T], final_state, truth_summary)``, the
    state this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, "simulate_curve_log_sharded")
    conv, msgs, state = SC.curve_loop(step, init, truth, eventual, run,
                                      group, rec)
    return conv, msgs, state, LG.truth_summary(cfg, truth)


def simulate_until_log_sharded(cfg: LogConfig, proto: ProtocolConfig,
                               topo: Topology, run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None):
    """Sharded rounds until the converged count reaches the integer
    target or ``run.max_rounds``.  Returns ``(rounds, log_conv, msgs,
    final_state, truth_summary)``, the state this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, "simulate_until_log_sharded")
    return SC.until_loop(step, init, truth, eventual, run, group, rec) + (
        LG.truth_summary(cfg, truth),)
