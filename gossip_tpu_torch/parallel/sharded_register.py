"""Node-dimension sharding of the LWW-register rounds (the txn workload).

The port of the JAX package's ``parallel/sharded_register.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`: the sharded pull round
(:func:`~gossip_tpu_torch.parallel.sharded_crdt.make_sharded_pull_round`)
with the register payload
(:func:`~gossip_tpu_torch.models.register.register_payload`: the writes
of the rank's nodes, the LWW join, the register liar kinds and the
owner/clamp ``defend``).  The round's collective is the all_gather of
the ``int32[n_pad, 2K]`` table, beside the float32 ``msgs`` and
``lost``; convergence is the integer converged count summed over the
ranks and divided once on the host.
"""

from __future__ import annotations

import functools
from typing import Optional

from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TxnConfig)
from gossip_tpu_torch.models import register as M
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import registers as RG
from gossip_tpu_torch.parallel import sharded_crdt as SC
from gossip_tpu_torch.parallel.group import Group
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_register_round(cfg: TxnConfig, proto: ProtocolConfig,
                                topo: Topology, group: Group,
                                fault: Optional[FaultConfig] = None,
                                origin: int = 0, defend: bool = False):
    """The sharded register round of this rank: ``step(state,
    donate=False)``, or under a fault program ``(state, lost)``."""
    return SC.make_sharded_pull_round(
        M.register_payload(cfg, proto, topo, fault, origin, defend,
                           group.device), proto, topo, group, fault, origin)


def init_sharded_reg_state(run: RunConfig, cfg: TxnConfig, topo: Topology,
                           group: Group) -> M.RegState:
    """This rank's rows of the all-zero register state."""
    return SC.zero_rows(M.RegState, run, RG.state_width(cfg), topo.n, group)


def _setup(cfg, proto, topo, run, group, fault, defend, label):
    M.check_writes_reachable(cfg, run)
    dev, n = group.device, topo.n
    inj = RG.inject_args(cfg, n, dev)
    truth = RG.ground_truth(cfg, inj, fault, n, run.origin)
    eventual = RG.eventual_alive_crdt(fault, n, run.origin, dev)

    def recorder():
        byz = None
        if NE.get_byz(fault) is not None:
            honest = NE.honest_mask(fault, n, dev)
            km = RG.honest_key_mask(cfg, inj, fault, n, run.origin, honest)
            byz = (lambda val, t, h: RG.byz_converged_tensor(cfg, val, t, h,
                                                             km), honest)
        return SC.PayloadRecorder(
            label, "txn", n, group, fault, run.origin, run.max_rounds,
            RG.state_width(cfg),
            lambda val, alive: RG.payload_count(cfg, val, alive), truth,
            eventual, byz)

    step, rec = SC.payload_step(
        make_sharded_register_round(cfg, proto, topo, group, fault,
                                    run.origin, defend), fault, recorder)
    init = functools.partial(init_sharded_reg_state, run, cfg, topo, group)
    return step, init, truth, eventual, rec


def simulate_curve_txn_sharded(cfg: TxnConfig, proto: ProtocolConfig,
                               topo: Topology, run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None,
                               defend: bool = False):
    """Exactly ``run.max_rounds`` sharded rounds.  Returns ``(txn_conv
    float64[T], msgs float32[T], final_state, truth_summary)``, the
    state this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, defend,
        "simulate_curve_txn_sharded")
    conv, msgs, state = SC.curve_loop(step, init, truth, eventual, run,
                                      group, rec)
    return conv, msgs, state, RG.truth_summary(cfg, truth, topo.n)


def simulate_until_txn_sharded(cfg: TxnConfig, proto: ProtocolConfig,
                               topo: Topology, run: RunConfig, group: Group,
                               fault: Optional[FaultConfig] = None,
                               defend: bool = False):
    """Sharded rounds until the converged count reaches the integer
    target or ``run.max_rounds``.  Returns ``(rounds, txn_conv, msgs,
    final_state, truth_summary)``, the state this rank's rows."""
    step, init, truth, eventual, rec = _setup(
        cfg, proto, topo, run, group, fault, defend,
        "simulate_until_txn_sharded")
    return SC.until_loop(step, init, truth, eventual, run, group, rec) + (
        RG.truth_summary(cfg, truth, topo.n),)
