"""SWIM failure detection (suspect, confirm, refute) on the XLA engine.

The port of the JAX package's ``models/swim.py`` on one device.  Every
node watches a window of S subjects and holds its view of each as one
monotone int32, the *wire*::

    wire = incarnation * 2 + (1 if SUSPECT else 0)      ALIVE / SUSPECT
    wire = DEAD_WIRE (1 << 30)                          DEAD, absorbing

so every SWIM merge (dissemination, suspicion, confirmation) is a max.
One round:

  1. every alive node probes one uniform subject of the window; when the
     direct probe fails it asks ``swim_proxies`` random proxies;
  2. a total failure sets the SUSPECT bit at the viewed incarnation;
  3. every alive node pushes its wire row to ``fanout`` peers (the
     topology's neighbours, or anyone on the complete graph); receivers
     merge by max (:func:`disseminate_max`);
  4. an alive subject that sees itself suspected refutes: its own view
     becomes ALIVE at incarnation + 1;
  5. a view held at the same SUSPECT wire for ``swim_suspect_rounds``
     rounds is confirmed DEAD.

Dead nodes neither probe, push nor update their views.  The window is
``0..S-1`` (fixed), or with ``swim_rotate`` moves by S every epoch, when
wires and timers start afresh.  The draws are the reference's threefry
draws (same tags, same per-node keys, same shapes), and ``msgs`` a
float32 scalar grown in the reference's order, so every field of
:class:`SwimState` equals the reference's bit for bit.

Ground truth: all nodes are alive before ``fail_round``; from it on the
``dead_nodes`` and the static death draw are down.  Under a fault program
(``fault.churn``) the churn events take nodes down and up and a drop ramp
sets the round's drop probability; a partition window is refused, as the
reference refuses it (SWIM probes ride the complete membership overlay).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig
from gossip_tpu_torch.models.si import f32, topology_device
from gossip_tpu_torch.models.state import static_death_draw
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import f32_fraction, resolve_device
from gossip_tpu_torch.ops.sampling import (drop_mask, node_keys,
                                           sample_peers,
                                           shift_excluding_self,
                                           table_lookup_or_sentinel)
from gossip_tpu_torch.topology.generators import Topology, complete

ALIVE, SUSPECT, DEAD = 0, 1, 2
DEAD_WIRE = 1 << 30

# fold_in tags (the reference's; disjoint from the SI rounds' 1..5)
_SUBJ_TAG, _PROXY_TAG, _DISS_TAG = 10, 11, 12
_DIRECT_DROP_TAG, _TO_PROXY_DROP_TAG, _PROXY_SUBJ_DROP_TAG = 13, 14, 15
_PACKED_TAG = 16


class SwimState(NamedTuple):
    """``wire[i, s]``: node i's view of window slot s; ``timer[i, s]``:
    rounds the same SUSPECT wire has been held."""

    wire: torch.Tensor       # int32[N, S]
    timer: torch.Tensor      # int32[N, S]
    round: int
    base_key: torch.Tensor   # int64[2]: the key's threefry words
    msgs: torch.Tensor       # float32 scalar


def suggested_suspect_rounds(n: int, fanout: int = 2) -> int:
    """A suspicion timeout long enough for a refutation's round trip: two
    epidemic legs of ``log_{1+fanout}(n)`` rounds, plus slack."""
    leg = math.log(max(n, 2)) / math.log(1 + max(fanout, 1))
    return max(6, int(math.ceil(2 * leg)) + 6)


def suggested_epoch_rounds(n: int, fanout: int, suspect_rounds: int) -> int:
    """The rotating window's epoch: probe, one dissemination leg, the
    suspicion timeout, and slack for the confirmation to spread."""
    leg = math.log(max(n, 2)) / math.log(1 + max(fanout, 1))
    return suspect_rounds + int(math.ceil(leg)) + 8


def resolve_epoch_rounds(proto: ProtocolConfig, n: int) -> int:
    """The epoch a configuration runs with (``swim_epoch_rounds`` 0 is
    :func:`suggested_epoch_rounds`)."""
    return proto.swim_epoch_rounds or suggested_epoch_rounds(
        n, proto.fanout, proto.swim_suspect_rounds)


def subject_window(round_: int, s_count: int, n: int, rotate: bool,
                   epoch_rounds: int, device=None) -> torch.Tensor:
    """int64[S]: the global ids watched during ``round_``: ``0..S-1``, or
    rotating, ``(epoch * S + j) % n`` in epoch ``round_ // epoch_rounds``
    (floor division, as the reference's int32 ``//``)."""
    slot = torch.arange(s_count, dtype=torch.int64, device=device)
    if not rotate:
        return slot
    return ((int(round_) // epoch_rounds) * s_count + slot) % n


def decode_status(wire: torch.Tensor) -> torch.Tensor:
    """wire -> ALIVE / SUSPECT / DEAD."""
    return torch.where(wire >= DEAD_WIRE, DEAD,
                       torch.where(wire % 2 == 1, SUSPECT, ALIVE))


def init_swim_state(n: int, n_subjects: int, seed: int = 0,
                    device=None) -> SwimState:
    """Everyone ALIVE at incarnation 0, key ``key(seed)``."""
    dev = resolve_device(device)
    zeros = torch.zeros(n, n_subjects, dtype=torch.int32, device=dev)
    return SwimState(wire=zeros, timer=zeros.clone(), round=0,
                     base_key=threefry.key(seed, dev),
                     msgs=torch.zeros((), dtype=torch.float32, device=dev))


def base_alive(n: int, dead_nodes: Tuple[int, ...],
               fault: Optional[FaultConfig], device=None) -> torch.Tensor:
    """bool[n]: who stays alive after ``fail_round``: not a scripted
    death and not in the static death draw (with no origin pinned).
    Churn events are not in it: the round applies them."""
    dev = resolve_device(device)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    if dead_nodes:
        alive[list(dead_nodes)] = False
    drawn = static_death_draw(fault, n, dev)
    return alive if drawn is None else alive & drawn


def observer_alive(n: int, dead_nodes: Tuple[int, ...],
                   fault: Optional[FaultConfig], device=None) -> torch.Tensor:
    """bool[n]: the detection metric's observers, :func:`base_alive` less
    the program's permanent deaths (a node that recovers observes)."""
    alive = base_alive(n, dead_nodes, fault, device)
    dead = NE.permanent_dead_ids(NE.get(fault))
    if dead:
        alive[list(dead)] = False
    return alive


def detection_targets(dead_nodes: Tuple[int, ...],
                      fault: Optional[FaultConfig]) -> Tuple[int, ...]:
    """Global ids the metric must see confirmed: the scripted deaths and
    the program's permanent deaths, sorted."""
    return tuple(sorted(set(tuple(dead_nodes))
                        | set(NE.permanent_dead_ids(NE.get(fault)))))


def pack_width(max_rounds) -> int:
    """Transport-lane bits of the ``pack`` lowering: 8 or 16 when every
    live wire of a ``max_rounds`` run (at most ``2 * rounds + 1``) stays
    below the lane's cap with a margin of 2, else 0 (``sort`` instead)."""
    if max_rounds is None:
        return 0
    bound = 2 * int(max_rounds) + 3
    if bound < 0xFF:
        return 8
    if bound < 0xFFFF:
        return 16
    return 0


def effective_diss(impl: str, max_rounds) -> str:
    """The lowering :func:`disseminate_max` runs: ``pack`` without a lane
    width is ``sort``."""
    if impl == "pack" and not pack_width(max_rounds):
        return "sort"
    return impl


def _max_into_rows(recv: torch.Tensor, values: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """int32[num_rows, S]: row r is the max of the ``values`` rows whose
    receiver ``recv`` is r, 0 where there is none; receivers outside
    ``[0, num_rows)`` land in a row that is cut off."""
    idx = torch.where((recv >= 0) & (recv < num_rows), recv, num_rows)
    out = torch.zeros(num_rows + 1, values.shape[1], dtype=values.dtype,
                      device=values.device)
    out.scatter_reduce_(0, idx[:, None].expand(-1, values.shape[1]), values,
                        "amax", include_self=True)
    return out[:num_rows]


def disseminate_max(targets: torch.Tensor, wire: torch.Tensor,
                    num_rows: int, impl: str = "scatter",
                    max_rounds=None) -> torch.Tensor:
    """int32[num_rows, S]: row r is the max of every wire row pushed to r
    (sender i pushes ``wire[i]`` to each of ``targets[i]``), 0 where
    nobody pushed; targets outside ``[0, num_rows)`` are dropped.

    Three lowerings with equal results (max does not depend on order):

    * ``scatter``: one scatter-max of the ``N * fanout`` pushed rows;
    * ``sort``: the pushes sorted by receiver, the rows gathered in that
      order, then a max over each receiver's run;
    * ``pack``: ``sort`` with the gathered rows packed into 8- or 16-bit
      transport codes, 4 or 2 to an int32 word: ``min(wire, cap)`` keeps
      the order of every wire a ``max_rounds`` run can hold
      (:func:`pack_width`), and ``cap`` goes back to ``DEAD_WIRE`` after
      the max.  Without a width it is ``sort``.
    """
    fanout, s_count = targets.shape[1], wire.shape[1]
    flat_t = targets.reshape(-1).to(torch.int64)
    if impl == "scatter":
        pushed = wire[:, None, :].expand(-1, fanout, -1).reshape(-1, s_count)
        return _max_into_rows(flat_t, pushed, num_rows)
    order = torch.argsort(flat_t)
    recv_sorted = flat_t[order]
    sender = torch.div(order, fanout, rounding_mode="floor")
    width = pack_width(max_rounds) if impl == "pack" else 0
    if not width:
        return _max_into_rows(recv_sorted, wire[sender], num_rows)
    lanes, cap = 32 // width, (1 << width) - 1
    code = torch.clamp(wire, max=cap)
    pad = (-s_count) % lanes
    if pad:
        code = torch.nn.functional.pad(code, (0, pad))
    grouped = code.reshape(code.shape[0], -1, lanes)
    packed = grouped[:, :, 0]
    for lane in range(1, lanes):
        packed = packed | (grouped[:, :, lane] << (width * lane))
    g = packed[sender]                      # the gather, in packed words
    codes = torch.stack([(g >> (width * lane)) & cap
                         for lane in range(lanes)], dim=-1)
    codes = codes.reshape(g.shape[0], -1)[:, :s_count]
    recv = _max_into_rows(recv_sorted, codes, num_rows)
    return torch.where(recv == cap, DEAD_WIRE, recv)


def probe_draws(rkey: torch.Tensor, gids: torch.Tensor, s_count: int,
                n: int, proxies: int, drop_prob, force: bool = False):
    """Steps 1-2's draws on the ``split`` rng: each node's probed slot
    (int64[N]), direct-probe drop (bool[N]), proxies (int64[N, K]) and
    the two per-proxy hop drops (bool[N, K]).  A zero rate draws no coins
    unless ``force`` (a ramp's per-round probability, a float32 0-d
    tensor)."""
    subj = threefry.randint(node_keys(threefry.fold_in(rkey, _SUBJ_TAG),
                                      gids), (), 0, s_count)
    proxy_ids = threefry.randint(
        node_keys(threefry.fold_in(rkey, _PROXY_TAG), gids), (proxies,), 0,
        n)
    m = gids.shape[0]
    if force or drop_prob > 0.0:
        d_drop = drop_mask(rkey, _DIRECT_DROP_TAG, gids, 1, drop_prob)[:, 0]
        to_p = drop_mask(rkey, _TO_PROXY_DROP_TAG, gids, proxies, drop_prob)
        p_to_s = drop_mask(rkey, _PROXY_SUBJ_DROP_TAG, gids, proxies,
                           drop_prob)
    else:
        d_drop = torch.zeros(m, dtype=torch.bool, device=gids.device)
        to_p = p_to_s = torch.zeros(m, proxies, dtype=torch.bool,
                                    device=gids.device)
    return subj, d_drop, proxy_ids, to_p, p_to_s


def packed_threshold(drop_prob, force: bool) -> torch.Tensor:
    """The ``packed`` rng's coin threshold as an int64 in ``[0, 2^32)``.
    Static: ``min(int(p * 2^32), 2^32 - 1)`` in Python.  Forced (a
    float32 0-d tensor): ``min(p * 2^32, 4294967040.0)`` in float32,
    truncated, and all ones from ``p >= 1``, as the reference converts."""
    if not force:
        return torch.tensor(min(int(drop_prob * 2 ** 32), 2 ** 32 - 1),
                            dtype=torch.int64)
    dp = drop_prob.to(torch.float32)
    scaled = torch.minimum(dp * torch.tensor(4294967296.0,
                                             dtype=torch.float32,
                                             device=dp.device),
                           torch.tensor(4294967040.0, dtype=torch.float32,
                                        device=dp.device))
    return torch.where(dp >= 1.0, 0xFFFFFFFF, scaled.to(torch.int64))


def packed_round_draws(rkey: torch.Tensor, gids: torch.Tensor,
                       s_count: int, n: int, proxies: int, fanout: int,
                       drop_prob, nbrs=None, deg=None,
                       sentinel: Optional[int] = None, force: bool = False):
    """Every draw of a round from one per-node key and one ``uint32[W]``
    draw (``swim_rng='packed'``): word 0 the probed slot (mod S), the
    next ``proxies`` words the proxies (mod n), the next ``fanout`` the
    dissemination peers (complete: mod n-1 and the self-shift; a table:
    mod the degree), then with drops one direct and ``2 * proxies`` hop
    coins, each ``word < threshold`` (:func:`packed_threshold`).
    Returns :func:`probe_draws`' tuple and the peers (int64[N, fanout])."""
    have_drop = force or drop_prob > 0.0
    w = 1 + proxies + fanout + (1 + 2 * proxies if have_drop else 0)
    keys = node_keys(threefry.fold_in(rkey, _PACKED_TAG), gids)
    words = threefry.random_bits(keys, (w,))          # int64 in [0, 2^32)
    subj = words[:, 0] % s_count
    proxy_ids = words[:, 1:1 + proxies] % n
    peer_w = words[:, 1 + proxies:1 + proxies + fanout]
    if nbrs is None:
        r = peer_w % max(n - 1, 1)
        targets = shift_excluding_self(r, gids.to(torch.int64)[:, None])
    else:
        d = deg.to(torch.int64)[:, None]
        targets = table_lookup_or_sentinel(peer_w % torch.clamp(d, min=1),
                                           nbrs, d, sentinel)
    m = gids.shape[0]
    if have_drop:
        thresh = packed_threshold(drop_prob, force).to(words.device)
        base = 1 + proxies + fanout
        d_drop = words[:, base] < thresh
        to_p = words[:, base + 1:base + 1 + proxies] < thresh
        p_to_s = words[:, base + 1 + proxies:base + 1 + 2 * proxies] < thresh
    else:
        d_drop = torch.zeros(m, dtype=torch.bool, device=gids.device)
        to_p = p_to_s = torch.zeros(m, proxies, dtype=torch.bool,
                                    device=gids.device)
    return subj, d_drop, proxy_ids, to_p, p_to_s, targets


def make_swim_round(proto: ProtocolConfig, n: int,
                    dead_nodes: Tuple[int, ...] = (), fail_round: int = 0,
                    fault: Optional[FaultConfig] = None,
                    topo: Optional[Topology] = None, max_rounds=None,
                    device=None):
    """The single-device round ``SwimState -> SwimState`` on ``device``
    (default: the topology's table's, or CUDA).  ``topo`` (default the
    complete graph) restricts the dissemination's peers only: probes go
    to the subject directly.  ``max_rounds`` is the run's round budget,
    which only the ``pack`` lowering reads (:func:`pack_width`)."""
    s_count = proto.swim_subjects
    if s_count > n:
        raise ValueError(
            f"swim_subjects={s_count} exceeds cluster size n={n}; the "
            "subject window cannot be wider than the membership")
    proxies, t_confirm, fanout = (proto.swim_proxies,
                                  proto.swim_suspect_rounds, proto.fanout)
    rotate = proto.swim_rotate
    epoch_rounds = resolve_epoch_rounds(proto, n)
    drop_prob = 0.0 if fault is None else fault.drop_prob
    NE.check_supported(fault, engine="swim", partitions=False)
    topo = complete(n) if topo is None else topo
    dev = topology_device(topo, device)
    ch = NE.get(fault)
    sched = NE.build(fault, n, device=dev) if ch is not None else None
    ramped = ch is not None and ch.ramp is not None
    nbrs = None if topo.implicit else topo.nbrs
    deg = None if topo.implicit else topo.deg
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    slots = torch.arange(s_count, dtype=torch.int64, device=dev)
    alive_base = base_alive(n, dead_nodes, fault, dev)
    everyone = torch.ones(n, dtype=torch.bool, device=dev)

    def step(state: SwimState) -> SwimState:
        r = state.round
        rkey = threefry.fold_in(state.base_key, r)
        alive_now = alive_base if r >= fail_round else everyone
        dp = drop_prob
        if ch is not None:
            # churn: down for die <= r < rec
            alive_now = NE.alive_rows(sched, alive_now, r)
            if ramped:
                dp = NE.drop_at(sched, r)
        subj_gids = subject_window(r, s_count, n, rotate, epoch_rounds, dev)
        subj_alive = alive_now[subj_gids]
        if rotate and r > 0 and r % epoch_rounds == 0:
            # an epoch boundary: fresh views of the new window
            wire_prev = torch.zeros_like(state.wire)
            timer_prev = torch.zeros_like(state.timer)
        else:
            wire_prev, timer_prev = state.wire, state.timer

        # 1-2: probe and suspect
        if proto.swim_rng == "packed":
            (subj, d_drop, proxy_ids, to_p, p_to_s,
             targets) = packed_round_draws(rkey, ids, s_count, n, proxies,
                                           fanout, dp, nbrs=nbrs, deg=deg,
                                           sentinel=n, force=ramped)
        else:
            subj, d_drop, proxy_ids, to_p, p_to_s = probe_draws(
                rkey, ids, s_count, n, proxies, dp, force=ramped)
            targets = None
        subj_ok = subj_alive[subj]
        direct_ok = subj_ok & ~d_drop
        proxy_ok = (alive_now[proxy_ids] & ~to_p & ~p_to_s
                    & subj_ok[:, None])
        fail = alive_now & ~direct_ok & ~proxy_ok.any(dim=1)
        suspectable = ((wire_prev < DEAD_WIRE)
                       & (subj[:, None] == slots[None, :]) & fail[:, None])
        wire1 = torch.where(suspectable, wire_prev | 1, wire_prev)
        # a direct ping and its ack; on a direct failure, four messages
        # per proxy path (the ping-req chain)
        msgs_probe = (f32((alive_now & direct_ok).sum()) * 2.0
                      + f32((alive_now & ~direct_ok).sum())
                      * (1.0 + 4.0 * proxies))

        # 3: dissemination, a max-merge of the pushed wire rows
        if targets is None:
            targets = sample_peers(threefry.fold_in(rkey, _DISS_TAG), ids,
                                   topo, fanout, exclude_self=True)
        targets = torch.where(alive_now[:, None], targets, n)
        recv = disseminate_max(targets, wire1, n, proto.swim_diss,
                               max_rounds)
        wire2 = torch.maximum(wire1, recv)
        msgs_diss = f32((targets < n).sum())

        # 4: refutation, an alive subject over its own suspicion
        self_view = wire2[subj_gids, slots]
        refuted = torch.where(
            subj_alive & (self_view % 2 == 1) & (self_view < DEAD_WIRE),
            (torch.div(self_view, 2, rounding_mode="floor") + 1) * 2,
            self_view)
        wire3 = wire2.index_put((subj_gids, slots), refuted)

        # 5: suspicion timers and confirmation
        is_susp = (wire3 % 2 == 1) & (wire3 < DEAD_WIRE)
        held = is_susp & (wire3 == wire_prev)
        timer = torch.where(held, timer_prev + 1, is_susp.to(torch.int32))
        confirm = timer >= t_confirm
        wire4 = torch.where(confirm, DEAD_WIRE, wire3)
        timer = torch.where(confirm, 0, timer)

        # dead observers keep their views of this epoch
        live = alive_now[:, None]
        return SwimState(wire=torch.where(live, wire4, wire_prev),
                         timer=torch.where(live, timer, timer_prev),
                         round=r + 1, base_key=state.base_key,
                         msgs=state.msgs + msgs_probe + msgs_diss)

    return step


def detection_counts(wire: torch.Tensor, dead_subjects, alive_now,
                     subj_gids: torch.Tensor):
    """(confirmed, pairs) as 0-d int64 tensors on the wire's device:
    the (alive observer, dead subject in the window) pairs held DEAD, and
    all such pairs."""
    dead = _dead_slots(wire, dead_subjects, subj_gids)
    obs = (wire >= DEAD_WIRE) & dead[None, :] & alive_now[:, None]
    return obs.sum(), alive_now.sum() * dead.sum()


def _dead_slots(wire, dead_subjects, subj_gids) -> torch.Tensor:
    """bool[S]: the window slots that watch a dead subject."""
    dead_arr = torch.as_tensor(tuple(dead_subjects), dtype=torch.int64,
                               device=wire.device)
    return (subj_gids[:, None] == dead_arr[None, :]).any(dim=1)


def detection_fraction(state: SwimState, dead_subjects, alive_now=None,
                       subj_gids=None) -> float:
    """Fraction of (alive observer, dead subject) pairs confirmed DEAD,
    in the reference's float32 quotient.  ``dead_subjects`` are global
    ids; ``subj_gids`` maps window slots to them (default the fixed
    window, where a dead id outside it is an error).  Without
    ``alive_now`` every row observes, over ``n * max(dead, 1)`` pairs;
    with it the quotient's denominator is ``max(pairs, 1)``."""
    wire = state.wire
    n_rows, s_count = wire.shape
    if subj_gids is None:
        if any(s >= s_count for s in dead_subjects):
            raise ValueError(
                f"dead_subjects {tuple(dead_subjects)} out of range: the "
                f"fixed window tracks nodes 0..{s_count - 1} only "
                "(set proto.swim_rotate for full-membership coverage)")
        subj_gids = torch.arange(s_count, dtype=torch.int64,
                                 device=wire.device)
    if alive_now is None:
        dead = _dead_slots(wire, dead_subjects, subj_gids)
        count = ((wire >= DEAD_WIRE) & dead[None, :]).sum()
        return f32_fraction(int(count), n_rows * max(int(dead.sum()), 1))
    return detection_quotient(*detection_counts(wire, dead_subjects,
                                                alive_now, subj_gids))


def detection_quotient(confirmed, pairs) -> float:
    """``float32(confirmed) / float32(max(pairs, 1))``: the reference's
    quotient, which its compiled loops compute too (the denominator is
    not folded into a reciprocal there)."""
    return f32_fraction(int(confirmed), max(int(pairs), 1))
