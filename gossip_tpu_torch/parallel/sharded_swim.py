"""Node-dimension sharding of SWIM failure detection.

The port of the JAX package's ``parallel/sharded_swim.py`` over a
:class:`~gossip_tpu_torch.parallel.group.Group`: semantically
:func:`~gossip_tpu_torch.models.swim.make_swim_round` on the ``[nl, S]``
rows of the rank's global ids, every draw keyed by the global id.  The
only structural difference is dissemination: each rank max-merges its
senders' wire rows into a whole ``int32[n_pad, S]`` table
(:func:`~gossip_tpu_torch.models.swim.disseminate_max` with ``num_rows =
n_pad``, any of its three lowerings), the table is reduced with an
all-reduce ``max`` over the ranks (:meth:`Group.all_reduce_max`, the
reference's ``pmax``: the monotone wire makes max exactly the SWIM
merge), and each rank keeps its own rows.  Dead and padding senders aim
at ``n_pad``, which the merge drops (the sentinel ``n`` would land on a
padding row when ``n < n_pad``).  The liveness of every node, of the
window's subjects and of the proxies is an O(N) buffer replicated on
every rank, as in the reference; ``msgs`` is the ranks' float32 partials
added in rank order (:meth:`Group.combine_f32`).  Partition windows
stay refused, as on one device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig
from gossip_tpu_torch.models import swim as SW
from gossip_tpu_torch.models.si import f32
from gossip_tpu_torch.models.swim import DEAD_WIRE, SwimState
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.sampling import (sample_peers_complete,
                                           sample_peers_table)
from gossip_tpu_torch.parallel.group import Group, pad_rows
from gossip_tpu_torch.topology.generators import Topology


def make_sharded_swim_round(proto: ProtocolConfig, n: int, group: Group,
                            dead_nodes: Tuple[int, ...] = (),
                            fail_round: int = 0,
                            fault: Optional[FaultConfig] = None,
                            topo: Optional[Topology] = None,
                            max_rounds=None):
    """The sharded SWIM round of this rank, ``SwimState -> SwimState`` on
    the rank's rows (:func:`init_sharded_swim_state`).  ``topo`` (default
    the complete graph) restricts the dissemination's peers only;
    ``max_rounds`` is read by the ``pack`` lowering only."""
    s_count = proto.swim_subjects
    if s_count > n:
        raise ValueError(
            f"swim_subjects={s_count} exceeds cluster size n={n}; the "
            "subject window cannot be wider than the membership")
    proxies, t_confirm, fanout = (proto.swim_proxies,
                                  proto.swim_suspect_rounds, proto.fanout)
    rotate = proto.swim_rotate
    epoch_rounds = SW.resolve_epoch_rounds(proto, n)
    drop_prob = 0.0 if fault is None else fault.drop_prob
    NE.check_supported(fault, engine="swim", partitions=False)
    dev = group.device
    n_pad, nl, lo = group.rows(n)
    gids = torch.arange(lo, lo + nl, dtype=torch.int64, device=dev)
    ch = NE.get(fault)
    sched = NE.build(fault, n, n_pad, device=dev) if ch is not None else None
    ramped = ch is not None and ch.ramp is not None
    if topo is None or topo.implicit:
        nbrs = deg = None
    else:
        nbrs = pad_rows(topo.nbrs.to(dev), n_pad, n)[lo:lo + nl]
        deg = pad_rows(topo.deg.to(dev), n_pad, 0)[lo:lo + nl]
    alive_base = pad_rows(SW.base_alive(n, dead_nodes, fault, dev), n_pad,
                          False)
    everyone = pad_rows(torch.ones(n, dtype=torch.bool, device=dev), n_pad,
                        False)

    def step(state: SwimState) -> SwimState:
        r = state.round
        rkey = threefry.fold_in(state.base_key, r)
        alive_full = alive_base if r >= fail_round else everyone
        dp = drop_prob
        if ch is not None:
            # churn: down for die <= r < rec
            alive_full = NE.alive_rows(sched, alive_full, r)
            if ramped:
                dp = NE.drop_at(sched, r)
        alive_l = alive_full[lo:lo + nl]
        subj_gids = SW.subject_window(r, s_count, n, rotate, epoch_rounds,
                                      dev)
        subj_alive = alive_full[subj_gids]
        if rotate and r > 0 and r % epoch_rounds == 0:
            # an epoch boundary: fresh views of the new window
            wire_prev = torch.zeros_like(state.wire)
            timer_prev = torch.zeros_like(state.timer)
        else:
            wire_prev, timer_prev = state.wire, state.timer

        # 1-2: probe and suspect (draws keyed by global id)
        if proto.swim_rng == "packed":
            (subj, d_drop, proxy_ids, to_p, p_to_s,
             targets) = SW.packed_round_draws(
                rkey, gids, s_count, n, proxies, fanout, dp, nbrs=nbrs,
                deg=deg, sentinel=n, force=ramped)
        else:
            subj, d_drop, proxy_ids, to_p, p_to_s = SW.probe_draws(
                rkey, gids, s_count, n, proxies, dp, force=ramped)
            targets = None
        subj_ok = subj_alive[subj]
        direct_ok = subj_ok & ~d_drop
        proxy_ok = (alive_full[proxy_ids] & ~to_p & ~p_to_s
                    & subj_ok[:, None])
        fail = alive_l & ~direct_ok & ~proxy_ok.any(dim=1)
        slots = torch.arange(s_count, dtype=torch.int64, device=dev)
        suspectable = ((wire_prev < DEAD_WIRE)
                       & (subj[:, None] == slots[None, :]) & fail[:, None])
        wire1 = torch.where(suspectable, wire_prev | 1, wire_prev)
        msgs_local = (f32((alive_l & direct_ok).sum()) * 2.0
                      + f32((alive_l & ~direct_ok).sum())
                      * (1.0 + 4.0 * proxies))

        # 3: dissemination, a local max-merge reduced by max over ranks
        if targets is None:
            dkey = threefry.fold_in(rkey, SW._DISS_TAG)
            targets = (sample_peers_complete(dkey, gids, n, fanout, True)
                       if nbrs is None else
                       sample_peers_table(dkey, gids, nbrs, deg, fanout,
                                          sentinel=n))
        msgs_local = msgs_local + f32(((targets < n)
                                       & alive_l[:, None]).sum())
        # silent senders (dead, padding) aim at n_pad: the merge drops them
        targets = torch.where(alive_l[:, None], targets, n_pad)
        contrib = SW.disseminate_max(targets, wire1, n_pad, proto.swim_diss,
                                     max_rounds)
        recv = group.all_reduce_max(contrib)[lo:lo + nl]
        wire2 = torch.maximum(wire1, recv)

        # 4: refutation, on the rows whose id is an alive subject
        sel = (gids[:, None] == subj_gids[None, :]) & alive_l[:, None]
        odd = (wire2 % 2 == 1) & (wire2 < DEAD_WIRE)
        wire3 = torch.where(
            sel & odd, (torch.div(wire2, 2, rounding_mode="floor") + 1) * 2,
            wire2)

        # 5: suspicion timers and confirmation
        is_susp = (wire3 % 2 == 1) & (wire3 < DEAD_WIRE)
        held = is_susp & (wire3 == wire_prev)
        timer = torch.where(held, timer_prev + 1, is_susp.to(torch.int32))
        confirm = timer >= t_confirm
        wire4 = torch.where(confirm, DEAD_WIRE, wire3)
        timer = torch.where(confirm, 0, timer)

        live = alive_l[:, None]
        return SwimState(wire=torch.where(live, wire4, wire_prev),
                         timer=torch.where(live, timer, timer_prev),
                         round=r + 1, base_key=state.base_key,
                         msgs=state.msgs + group.combine_f32(msgs_local))

    return step


def init_sharded_swim_state(n: int, proto: ProtocolConfig, group: Group,
                            seed: int = 0) -> SwimState:
    """This rank's rows of the initial state (everyone ALIVE at
    incarnation 0, key ``key(seed)``)."""
    _, nl, _ = group.rows(n)
    return SW.init_swim_state(nl, proto.swim_subjects, seed, group.device)


def observer_rows(n: int, dead_nodes, fault: Optional[FaultConfig],
                  group: Group) -> torch.Tensor:
    """bool[nl]: this rank's share of the detection metric's observers
    (the reference's ``_swim_obs_pad``: padding rows never observe)."""
    n_pad, nl, lo = group.rows(n)
    obs = SW.observer_alive(n, tuple(dead_nodes), fault, group.device)
    return pad_rows(obs, n_pad, False)[lo:lo + nl]


def restore_sharded_swim_state(state: SwimState, group: Group) -> SwimState:
    """This rank's rows of a loaded checkpoint: the file holds the padded
    rows (the run's configuration fingerprint pins the mesh size, so the
    row count matches), and the rank takes its slice onto its device."""
    from gossip_tpu_torch.utils.checkpoint import rank_share
    return rank_share(state, group)
