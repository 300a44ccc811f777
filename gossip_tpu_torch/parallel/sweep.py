"""Sweeps: seed ensembles, scenario batches and config grids as a
leading batch axis.

The port of the JAX package's ``parallel/sweep.py``.  The reference runs
a batch of trajectories as one ``vmap`` axis of one compiled scan; here
the batch is a leading axis ``S`` of every tensor of one round
(:func:`~gossip_tpu_torch.models.si.make_si_round_batched`,
:func:`_sweep_round_delta`), so a round of the whole batch costs the
launches of one round, not S of them.  Point s of any batch is its solo
run, bit for bit: its draws are keyed ``fold_in(fold_in(key(seed_s),
round), node)``, and its push scatter counts into its own block of one
table (:mod:`gossip_tpu_torch.ops.propagate`).

* :func:`ensemble_curves`: S seeds of one configuration (faults and
  fault programs included), ``run.max_rounds`` rounds, the reference's
  fixed-length scan;
* :func:`churn_sweep_curves`: K fault programs of one configuration
  (:func:`~gossip_tpu_torch.ops.nemesis.build_stack`), each scenario's
  liveness, drop probability and cut its own; the exact per-round
  ``dropped`` count;
* :func:`fused_churn_sweep_curves`: K programs through the fused rumor
  planes (:mod:`gossip_tpu_torch.parallel.sharded_fused`), one scenario
  after another, as the reference's does;
* :func:`config_sweep_curves`: distinct points (:class:`SweepPoint`:
  mode, fanout, drop, period, seed, topology, rumors) in one batch.  The
  mode flags, fanout (a column mask under one ``k_max``-wide draw),
  drop probability, period and seed are per-point tensors; explicit
  tables of several families stack as ``int32[F, n_max, D_max]``;
  mixed n pads with phantom rows (explicit) or bounds each point's draw
  by its own n (complete graph); mixed rumor counts pad with phantom
  columns.  :func:`config_sweep_curves_partitioned` runs one batch per
  mode bucket, :func:`config_sweep_curves_2d` shards configs over one
  axis of a hybrid mesh and nodes over the other;
* :func:`request_sweep_curves`: K serving requests
  (:class:`RequestSpec`) in one batch, the admission batcher's
  megabatch: each request's mode, period, seed, origin, target, n
  within a power-of-two bucket, rumors, static deaths and fault program
  are per-lane tensors under one shared draw width;
* :func:`ensemble_rumor_curves`, :func:`ensemble_swim_curves`: seed
  ensembles of rumor mongering and SWIM on their own batched rounds
  (:func:`~gossip_tpu_torch.models.rumor.make_rumor_round_batched`,
  :func:`~gossip_tpu_torch.models.swim.make_swim_round_batched`).

**Coverage**, per batch kind the reference's chooser: the ensembles'
scan divides by a compile-time count where its alive set is built from
constants (``ops/nemesis.folded_denominator``, the solo loops' rule);
the churn sweep reads an exact integer count and divides once on the
host (true division); the config sweep multiplies by ``float32(1 /
n)`` (each point's own n when the batch is ragged), and divides by the
alive count under static deaths; the pod sweep divides.  Every count is
an integer on the device, turned into a fraction once at the end.

**msgs** add in the solo round's order (the push term, then the pull
term, each a float32 add); the reference's config sweep adds the two
terms first.  Both are exact, and equal, wherever a round's sum is
exact in float32 (:mod:`gossip_tpu_torch.ops.common`).

**Sharding.**  With a ``group`` (:mod:`gossip_tpu_torch.parallel.group`)
each rank runs its contiguous slice of the points and one ``all_gather``
assembles the curves, msgs and counts in point order: value-invariant,
since points never read each other.  The pod sweep
(:func:`config_sweep_curves_2d`) takes a
:class:`~gossip_tpu_torch.parallel.multislice.HybridMesh`.

**Memory.**  The threefry draw works on int64 temporaries (about 128
bytes an element of a draw), so a batch peaks near S times its solo
round.  Where a batch would pass :data:`BATCH_BYTES`, the drivers run
it in chunks of points, one after another (value-invariant);
``meta['batch_chunks']`` says how many.

The reference's sweep-end cache gauges (its ``sweep.py``
``_emit_pod_sweep_cache_telemetry``: the pod-sweep scan memo's entries,
hits and evictions) report a memo of compiled scans that this module
does not keep: a batch here is plain torch rounds, built again each
call.  So no gauge is written for them; the batches' ``driver_timing``
events come from the chokepoint
(:func:`~gossip_tpu_torch.utils.timing.steady_timed`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.models import si as si_mod
from gossip_tpu_torch.models.state import SimState, alive_mask, init_state
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.ops.propagate import pull_merge, push_counts
from gossip_tpu_torch.ops.sampling import (drop_mask, node_keys,
                                           sample_peers_complete,
                                           sample_peers_table)
from gossip_tpu_torch.topology.generators import Topology

# A batch whose estimated peak passes this runs in chunks of points.
BATCH_BYTES = 60 << 30
# Bytes an element of a threefry draw holds at its peak (PERF.md §6: a
# bare 10M draw peaks at 1,280,000,512 B).
DRAW_BYTES = 128


def _rounds_to_target(curves: np.ndarray, target: float) -> np.ndarray:
    """First 1-based round index reaching target per row; -1 if never."""
    hit = np.full(curves.shape[0], -1, np.int64)
    reached = curves >= target
    any_hit = reached.any(axis=1)
    hit[any_hit] = reached[any_hit].argmax(axis=1) + 1
    return hit


@dataclasses.dataclass
class EnsembleResult:
    curves: np.ndarray            # float32[S, T] coverage per seed per round
    msgs: np.ndarray              # float32[S, T]
    rounds_to_target: np.ndarray  # int[S], -1 where never reached
    target: float
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def converged(self) -> np.ndarray:
        return self.rounds_to_target >= 0

    def summary(self) -> dict:
        r = self.rounds_to_target[self.converged]
        return {
            "seeds": int(len(self.rounds_to_target)),
            "converged": int(self.converged.sum()),
            "rounds_mean": float(r.mean()) if len(r) else None,
            "rounds_std": float(r.std()) if len(r) else None,
            "rounds_p50": float(np.median(r)) if len(r) else None,
            "rounds_p95": float(np.percentile(r, 95)) if len(r) else None,
            "final_coverage_mean": float(self.curves[:, -1].mean()),
            "msgs_mean": float(self.msgs[:, -1].mean()),
            "target": self.target,
        }


def _scenario(f: FaultConfig) -> dict:
    ch = f.churn
    return {"events": list(map(list, ch.events)),
            "partitions": list(map(list, ch.partitions)),
            "ramp": list(ch.ramp) if ch.ramp else None,
            "drop_prob": f.drop_prob}


@dataclasses.dataclass
class ChurnSweepResult:
    """K fault programs through one batch (:func:`churn_sweep_curves`):
    per-scenario per-round curves and msgs, ``dropped``, the exact
    count of messages the drop coins and the open cut destroyed, and
    ``counts``, the exact holders of the least-held rumor the curves
    divide."""
    faults: tuple                 # the FaultConfigs, batch order
    curves: np.ndarray            # float32[K, T]
    msgs: np.ndarray              # float32[K, T]
    dropped: np.ndarray           # float32[K, T]
    rounds_to_target: np.ndarray  # int[K], -1 where never reached
    target: float
    counts: Optional[np.ndarray] = None   # int64[K, T]: the exact counts
    meta: dict = dataclasses.field(default_factory=dict)

    def summaries(self):
        return [{"scenario": _scenario(f),
                 "rounds_to_target": int(self.rounds_to_target[i]),
                 "converged": bool(self.rounds_to_target[i] >= 0),
                 "final_coverage": float(self.curves[i, -1]),
                 "msgs_total": float(self.msgs[i, -1]),
                 "dropped_total": float(self.dropped[i].sum())}
                for i, f in enumerate(self.faults)]


@dataclasses.dataclass
class FusedChurnSweepResult:
    """K fault programs through the fused rumor planes
    (:func:`fused_churn_sweep_curves`).  ``msgs`` is the fused closed
    form, ``2 * fanout * n`` a round; the kernel resolves the drop coin
    inside, so there is no ``dropped`` count."""
    faults: tuple
    curves: np.ndarray            # float32[K, T]
    msgs: np.ndarray              # float32[K, T]
    rounds_to_target: np.ndarray
    target: float

    def summaries(self):
        return [{"scenario": _scenario(f),
                 "rounds_to_target": int(self.rounds_to_target[i]),
                 "converged": bool(self.rounds_to_target[i] >= 0),
                 "final_coverage": float(self.curves[i, -1]),
                 "msgs_total": float(self.msgs[i, -1])}
                for i, f in enumerate(self.faults)]


# -- the batch machinery ----------------------------------------------------

def _check_divides(count: int, group, what: str, axis: str) -> None:
    if group is not None and count % group.size:
        # the reference's words (_shard_ensemble, config_sweep_curves)
        if what == "seeds":
            raise ValueError(
                f"{count} seeds do not divide over the {axis} mesh axis of "
                f"size {group.size}; pad the seed list or change the mesh")
        raise ValueError(
            f"{count} {what} do not divide over the {axis} mesh axis of "
            f"size {group.size}; pad the batch (duplicate a point) or "
            "change the mesh")


def _local(items, group):
    """This rank's contiguous slice of the points (all without a
    group)."""
    items = list(items)
    if group is None:
        return items
    per = len(items) // group.size
    return items[group.rank * per:(group.rank + 1) * per]


def _gather(group, *arrays):
    """Every rank's ``[S_local, ...]`` numpy arrays as ``[S, ...]`` in
    point order, on every rank (one all_gather each)."""
    if group is None:
        return arrays
    return tuple(group.all_gather(torch.from_numpy(np.ascontiguousarray(a))
                                  .to(group.device)).cpu().numpy()
                 for a in arrays)


def _chunks(count: int, point_bytes: int):
    """Slices of at most as many points as fit :data:`BATCH_BYTES`."""
    per = max(1, int(BATCH_BYTES // max(point_bytes, 1)))
    return [slice(i, min(i + per, count)) for i in range(0, count, per)]


def _fractions(counts: np.ndarray, totals, folded) -> np.ndarray:
    """float32 ``count / total`` per point and round: ``folded`` the
    product with ``float32(1 / total)`` (a compiled division by a
    constant), else the quotient."""
    c = counts.astype(np.float32)
    t = np.maximum(np.asarray(totals, np.float32), np.float32(1))
    t = t.reshape(-1, 1) if t.ndim else t
    return c * (np.float32(1) / t) if folded else c / t


def _min_count(seen: torch.Tensor, weight: Optional[torch.Tensor],
               real_cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64[S]: each point's holders of its least-held rumor, counting
    rows where ``weight`` (``[N]`` or ``[S, N]``) holds and columns where
    ``real_cols`` (``[S, R]``) does."""
    held = seen if weight is None else seen & weight[..., None]
    cnt = held.sum(dim=-2, dtype=torch.int64)
    if real_cols is not None:
        cnt = torch.where(real_cols, cnt, torch.iinfo(torch.int64).max)
    return cnt.min(dim=-1).values


def _keys(seeds, dev) -> torch.Tensor:
    return torch.stack([threefry.key(int(s), dev) for s in seeds])


def _batch_state(seen0: torch.Tensor, keys: torch.Tensor) -> SimState:
    s = keys.shape[0]
    seen = seen0.expand((s,) + tuple(seen0.shape[-2:])).clone() \
        if seen0.dim() == 2 else seen0
    return SimState(seen=seen, round=0, key=keys,
                    msgs=torch.zeros(s, dtype=torch.float32,
                                     device=keys.device))


def _scan(step, state: SimState, rounds: int, count, lost: bool = False):
    """``rounds`` steps of the batch, each round's per-point counts and
    msgs (and ``lost``) kept on the device and read once at the end:
    ``(counts int64[S, T], msgs float32[S, T], lost or None, state)``."""
    s, dev = state.msgs.shape[0], state.msgs.device
    cnts = torch.zeros(rounds, s, dtype=torch.int64, device=dev)
    msgs = torch.zeros(rounds, s, dtype=torch.float32, device=dev)
    losts = torch.zeros(rounds, s, dtype=torch.float32, device=dev)
    for r in range(rounds):
        out = step(state)
        if lost:
            state, losts[r] = out
        else:
            state = out
        cnts[r] = count(state.seen)
        msgs[r] = state.msgs
    return (cnts.T.cpu().numpy(), msgs.T.cpu().numpy(),
            losts.T.cpu().numpy() if lost else None, state)


def _device(topo: Topology, group, device) -> torch.device:
    return si_mod.topology_device(topo, group.device if group is not None
                                  else device)


# -- ensembles and the churn sweep -----------------------------------------

def ensemble_readout(fault: Optional[FaultConfig], n: int, origin: int,
                     device=None):
    """``(alive, total, folded)``: an ensemble's coverage set (None:
    every node), its size, and whether the reference's scan multiplies
    by its reciprocal (the solo loops' rule: no alive set, or one built
    from constants, ``ops/nemesis.folded_denominator``)."""
    alive = NE.metric_alive(fault, n, origin, device)
    total = n if alive is None else int(alive.sum())
    return alive, total, alive is None or NE.folded_denominator(fault)


def ensemble_curves(proto: ProtocolConfig, topo: Topology, run: RunConfig,
                    seeds: Sequence[int],
                    fault: Optional[FaultConfig] = None, group=None,
                    device=None) -> EnsembleResult:
    """|seeds| trajectories of one configuration as one batch, exactly
    ``run.max_rounds`` rounds.  Seed s's curve and msgs are its solo
    ``simulate_curve``'s, bit for bit.  ``group``: each rank runs its
    slice of the seeds (value-invariant)."""
    seeds = list(seeds)
    if not seeds:
        raise ValueError("need at least one seed (pass seeds or count)")
    _check_divides(len(seeds), group, "seeds", "seed")
    dev = _device(topo, group, device)
    mine = _local(seeds, group)
    step = NE.drop_lost(si_mod.make_si_round_batched(
        proto, topo, fault, run.origin, dev), NE.get(fault))
    base = init_state(run, proto, topo.n, dev)
    alive, total, folded = ensemble_readout(fault, topo.n, run.origin, dev)
    point = topo.n * (proto.fanout * DRAW_BYTES + 8 * proto.rumors)
    chunks = _chunks(len(mine), point)
    cnts, msgs = [], []
    for sl in chunks:
        c, m, _, _ = _scan(step, _batch_state(base.seen,
                                              _keys(mine[sl], dev)),
                           run.max_rounds,
                           lambda seen: _min_count(seen, alive))
        cnts.append(c)
        msgs.append(m)
    curves = _fractions(np.concatenate(cnts), total, folded)
    curves, msgs = _gather(group, curves, np.concatenate(msgs))
    return EnsembleResult(curves=curves, msgs=msgs,
                          rounds_to_target=_rounds_to_target(
                              curves, run.target_coverage),
                          target=run.target_coverage,
                          meta={"batch_chunks": len(chunks)})


def _static_structure(faults, engine_note: str) -> None:
    statics = {dataclasses.replace(f, churn=None, drop_prob=0.0)
               for f in faults}
    if len(statics) > 1:
        # the reference's words
        raise ValueError(
            "churn sweep scenarios must share the STATIC fault "
            f"structure (node_death_rate/seed/dead_nodes {engine_note}); "
            "vary the churn schedule and drop_prob only")


def churn_sweep_curves(proto: ProtocolConfig, topo: Topology,
                       run: RunConfig, faults, group=None,
                       device=None) -> ChurnSweepResult:
    """K fault programs over one configuration as one batch: the
    stacked schedule (:func:`~gossip_tpu_torch.ops.nemesis.build_stack`)
    gives scenario k its own liveness, drop probability and cut each
    round.  Every fault carries a program and the same static structure
    (``drop_prob`` may vary).  Scenario k's trajectory is the solo
    ``simulate_curve(..., fault=faults[k])``'s, bit for bit; its
    coverage is the exact count over its eventual alive set, divided
    once on the host (true division, the reference's readout).
    ``group``: each rank runs its slice of the scenarios."""
    faults = tuple(faults)
    if not faults:
        raise ValueError("need at least one churn FaultConfig")
    _static_structure(faults, "are baked into the one compiled step")
    _check_divides(len(faults), group, "scenarios", "scenario")
    dev = _device(topo, group, device)
    n = topo.n
    stack = NE.build_stack(faults, n, device=dev)        # validates too
    mine = _local(range(len(faults)), group)
    base = init_state(run, proto, n, dev)
    alive_all = torch.stack([NE.eventual_alive(f, n, run.origin, dev)
                             for f in faults])
    point = n * (proto.fanout * DRAW_BYTES * 2 + 8 * proto.rumors)
    chunks = _chunks(len(mine), point)
    cnts, msgs, lost = [], [], []
    for sl in chunks:
        idx = torch.as_tensor(mine[sl], device=dev)
        sub = NE.Schedule(*(t[idx] for t in stack))
        step = si_mod.make_si_round_batched(proto, topo, faults[0],
                                            run.origin, dev, schedule=sub)
        alive = alive_all[idx]
        c, m, lo, _ = _scan(step, _batch_state(
            base.seen, _keys([run.seed] * len(idx), dev)), run.max_rounds,
            lambda seen: _min_count(seen, alive), lost=True)
        cnts.append(c)
        msgs.append(m)
        lost.append(lo)
    totals = alive_all.sum(dim=1).cpu().numpy()[mine]
    counts = np.concatenate(cnts)
    curves = _fractions(counts, totals, folded=False)
    curves, msgs, lost, counts = _gather(group, curves, np.concatenate(msgs),
                                         np.concatenate(lost), counts)
    return ChurnSweepResult(faults=faults, curves=curves, msgs=msgs,
                            dropped=lost, counts=counts,
                            rounds_to_target=_rounds_to_target(
                                curves, run.target_coverage),
                            target=run.target_coverage,
                            meta={"batch_chunks": len(chunks)})


def fused_churn_sweep_curves(n: int, rumors: int, run: RunConfig, faults,
                             group, fanout: int = 1) -> FusedChurnSweepResult:
    """K fault programs through the fused rumor planes, one scenario
    after another: scenario k's curve is
    ``simulate_curve_sharded_fused(..., fault=faults[k])``'s, by
    construction (each rank launches ``fused_mr_round`` once a local
    plane a round a scenario).  Every fault carries a program and the
    same static structure; ``group`` is the plane mesh."""
    from gossip_tpu_torch.parallel.sharded_fused import \
        simulate_curve_sharded_fused
    faults = tuple(faults)
    if not faults:
        raise ValueError("need at least one churn FaultConfig")
    for f in faults:
        if NE.get(f) is None:
            # the reference's words
            raise ValueError(
                "fused churn sweep scenarios must each carry a churn "
                "schedule (static-only faults run the plain fused "
                "curve driver)")
        NE.check_supported(f, engine="fused-planes")
    _static_structure(faults, "select the mask operand layout")
    curves = np.stack([np.asarray(simulate_curve_sharded_fused(
        n, rumors, run, group, fanout, fault=f)[0], np.float32)
        for f in faults])
    per_round = 2.0 * fanout * n
    msgs = np.broadcast_to(
        per_round * np.arange(1, run.max_rounds + 1, dtype=np.float32),
        curves.shape).copy()
    return FusedChurnSweepResult(
        faults=faults, curves=curves, msgs=msgs,
        rounds_to_target=_rounds_to_target(curves, run.target_coverage),
        target=run.target_coverage)


# -- the config sweep --------------------------------------------------------

# mode -> (do_push, do_pull); anti-entropy is a period-gated bidirectional
# exchange (pull + reverse delta, models/si.py semantics).
_MODE_FLAGS = {C.PUSH: (True, False), C.PULL: (False, True),
               C.PUSH_PULL: (True, True), C.ANTI_ENTROPY: (False, True)}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One point of a config sweep.  ``topo_idx`` picks the point's
    topology when :func:`config_sweep_curves` is given a sequence of
    them; ``rumors`` 0 is the batch's default."""
    mode: str = C.PUSH
    fanout: int = 1
    drop_prob: float = 0.0
    period: int = 1          # anti-entropy cadence (1 = every round)
    seed: int = 0
    topo_idx: int = 0
    rumors: int = 0

    def __post_init__(self):
        # the reference's words
        if self.mode not in _MODE_FLAGS:
            raise ValueError(
                f"config sweep supports {sorted(_MODE_FLAGS)}; got "
                f"{self.mode!r} (flood/swim change the round structure)")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if self.period < 1:
            raise ValueError("period must be >= 1")
        if self.period > 1 and self.mode != C.ANTI_ENTROPY:
            raise ValueError("period > 1 is the anti-entropy cadence; solo "
                             f"{self.mode!r} rounds ignore period, so a "
                             "batched point must not silently differ")
        if self.topo_idx < 0:
            raise ValueError("topo_idx must be >= 0")
        if self.rumors < 0:
            raise ValueError("rumors must be >= 0 (0 = batch default)")


@dataclasses.dataclass
class ConfigSweepResult:
    points: tuple                 # the SweepPoints, batch order
    curves: np.ndarray            # float32[C, T]
    msgs: np.ndarray              # float32[C, T]
    rounds_to_target: np.ndarray  # int[C], -1 where never reached
    target: float
    meta: dict = dataclasses.field(default_factory=dict)

    def summaries(self):
        return [{"point": dataclasses.asdict(pt),
                 "rounds_to_target": int(self.rounds_to_target[i]),
                 "converged": bool(self.rounds_to_target[i] >= 0),
                 "final_coverage": float(self.curves[i, -1]),
                 "msgs_total": float(self.msgs[i, -1])}
                for i, pt in enumerate(self.points)]


class _Flags:
    """The per-point operands of a config batch, ``[S]`` tensors."""

    def __init__(self, points, dev):
        def t(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)
        self.do_push = t([_MODE_FLAGS[p.mode][0] for p in points],
                         torch.bool)
        self.do_pull = t([_MODE_FLAGS[p.mode][1] for p in points],
                         torch.bool)
        self.do_ae = t([p.mode == C.ANTI_ENTROPY for p in points],
                       torch.bool)
        self.fanout = t([p.fanout for p in points], torch.int64)
        self.drop = t([np.float32(p.drop_prob) for p in points],
                      torch.float32)
        self.period = t([p.period for p in points], torch.int64)
        self.any_drop = any(p.drop_prob > 0.0 for p in points)


def _b(x: torch.Tensor) -> torch.Tensor:
    """A per-point ``[S]`` tensor shaped ``[S, 1, 1]``."""
    return x[:, None, None]


def _sweep_round_delta(rkey, round_: int, gids, visible, alive, peers,
                       k_max: int, fl: _Flags, n: int, have_ae: bool,
                       scatter_n: int, count_reduce, gather,
                       need_push: bool = True, need_pull: bool = True,
                       cut: Optional[torch.Tensor] = None,
                       want_lost: bool = False):
    """One config-sweep round of a row block: ``(delta, msgs_push,
    msgs_pull)``, ``delta`` ``bool[S, nl, R]`` and the two msgs terms
    ``float32[S]``.  Shared by the single-device batch, the pod sweep
    and the request megabatch, which differ in how scatter counts reduce
    (``count_reduce``), how the digest table is assembled (``gather``),
    the scatter's node range (``scatter_n``) and the partner draw
    (``peers``: the request megabatch bounds each point's draw on the
    complete graph by its own n, the reference's ``peer_bound``).

    Both halves are computed and masked by the points' mode flags;
    ``need_push`` / ``need_pull`` / ``have_ae`` leave out a half no
    point runs (its draws are tagged apart, so leaving it out changes
    nothing else).  Each point draws ``k_max`` columns and masks those
    at or past its fanout; the drop coins are drawn at each point's own
    probability (not at all where every point's is 0: the mask would be
    all False).

    ``cut`` (``int32[S]``, -1 closed): each point's partition cut this
    round, applied after the drop coins, in the solo churn round's
    order.  ``want_lost`` adds a fourth output, ``float32[S]``: the
    messages the drop coins and the open cut destroyed, counted as the
    solo churn round counts them."""
    col = torch.arange(k_max, dtype=torch.int64, device=visible.device)
    fan = _b(fl.fanout)
    delta = torch.zeros_like(visible)
    zero = torch.zeros(visible.shape[0], dtype=torch.float32,
                       device=visible.device)
    msgs_push = msgs_pull = lost = zero

    def drawn(tag, dtag):
        t0 = peers(threefry.fold_in(rkey, tag))
        t0 = torch.where(col < fan, t0, n)
        t = t0
        if fl.any_drop:
            dropped = drop_mask(rkey, dtag, gids, k_max, _b(fl.drop))
            t = torch.where(dropped, n, t)
        if cut is not None:
            t = NE.partition_targets(_b(cut), gids, t, n)
        return t0, t

    if need_push:
        targets0, targets = drawn(si_mod.PUSH_TAG, si_mod.PUSH_DROP_TAG)
        sender_active = visible.any(dim=-1)
        valid = (targets < n) & sender_active[..., None]
        counts = push_counts(scatter_n,
                             torch.where(valid, targets, scatter_n), visible)
        delta = (count_reduce(counts) > 0) & _b(fl.do_push)
        msgs_push = torch.where(fl.do_push,
                                si_mod.f32(valid.sum(dim=(-2, -1))), zero)
        if want_lost:
            lost = lost + torch.where(fl.do_push, NE.lost_count(
                targets0, targets, sender_active, n), zero)

    if need_pull:
        seen_all = gather(visible)
        partners0, partners = drawn(si_mod.PULL_TAG, si_mod.PULL_DROP_TAG)
        pulled = pull_merge(seen_all, partners, n)
        partners = torch.where(alive[..., None], partners, n)
        n_req = si_mod.f32((partners < n).sum(dim=(-2, -1)))
        on = fl.do_pull & (round_ % fl.period == 0)
        if want_lost:
            lost = lost + torch.where(on, NE.lost_count(
                partners0, partners, alive, n), zero)
        delta = delta | (pulled & _b(on))
        if have_ae:
            back = push_counts(scatter_n, torch.where(partners < n, partners,
                                                      scatter_n), visible)
            delta = delta | ((count_reduce(back) > 0) & _b(on & fl.do_ae))
        mfac = torch.where(fl.do_ae, 3.0, 2.0)
        msgs_pull = torch.where(on, mfac * n_req, zero)
    out = delta & alive[..., None], msgs_push, msgs_pull
    return out + (lost,) if want_lost else out


def _normalize_topos(topo, points):
    """(topos, multi, topo0) from a Topology-or-sequence argument, with
    the one topo_idx range check the sweeps share."""
    topos = tuple(topo) if isinstance(topo, (list, tuple)) else (topo,)
    if any(pt.topo_idx >= len(topos) for pt in points):
        raise ValueError(
            f"a point's topo_idx is past the {len(topos)} supplied "
            "topolog(ies)")
    return topos, len(topos) > 1, topos[0]


def _stack_topologies(topos, dev):
    """Explicit topologies -> (nbrs int32[F, n_max, D_max], deg
    int32[F, n_max]): neighbour columns padded with the sentinel n_max,
    and smaller graphs padded with phantom rows (degree 0, sentinel
    neighbours).  Sampling draws indices below a row's degree, so it
    never reads a pad: a point's trajectory is its own graph's."""
    n_max = max(t.n for t in topos)
    for t in topos:
        if t.implicit:
            # the reference's words
            raise ValueError(
                "a topology sweep needs explicit neighbor tables for "
                "every entry (the implicit complete graph has no table "
                "to stack, and its partner draw is bounded by a static "
                "n); sweep it as its own batch")
    d_max = max(t.nbrs.shape[1] for t in topos)
    nbrs = torch.full((len(topos), n_max, d_max), n_max, dtype=torch.int32,
                      device=dev)
    deg = torch.zeros((len(topos), n_max), dtype=torch.int32, device=dev)
    for i, t in enumerate(topos):
        nbrs[i, :t.n, :t.nbrs.shape[1]] = t.nbrs.to(dev)
        deg[i, :t.n] = t.deg.to(dev)
    return nbrs, deg


def _stack_peers(key, ids, nbrs, deg_p, tidx, k: int, sentinel: int):
    """k uniform neighbours a node from each point's family of the
    stacked tables (:func:`~gossip_tpu_torch.ops.sampling.sample_peers_table`
    with the table read through ``tidx``)."""
    d = deg_p.to(torch.int64)[..., None]
    idx = threefry.randint(node_keys(key, ids), (k,), 0,
                           torch.clamp(d, min=1))
    t = nbrs[tidx[:, None, None], ids[None, :, None], idx].to(torch.int64)
    return torch.where(d > 0, t, sentinel)


def _check_grid(points, fault):
    """The checks both config sweeps make first, in the reference's
    words."""
    points = tuple(points)
    if not points:
        raise ValueError("need at least one SweepPoint")
    if fault is not None and fault.drop_prob > 0.0:
        raise ValueError("per-config loss goes through SweepPoint.drop_prob;"
                         " FaultConfig.drop_prob would be ambiguous here")
    # the grid round has no churn path: refuse a program, never run it
    # static-only
    NE.check_supported(fault, engine="config-sweep", events=False,
                       partitions=False, ramp=False)
    return points


def config_sweep_curves(points, topo, run: RunConfig,
                        fault: Optional[FaultConfig] = None,
                        k_max: Optional[int] = None, rumors: int = 1,
                        group=None, device=None,
                        _force_both: bool = False) -> ConfigSweepResult:
    """C distinct config points as one batch, exactly ``run.max_rounds``
    rounds (module doc).  ``topo`` is one Topology or a sequence of
    explicit ones (each point's ``topo_idx`` picks its own; sizes may
    differ, padded with phantom rows), or of complete graphs of several
    sizes (each point's draw bounded by its own n).  ``fault`` gives
    only the static deaths; per-point loss is ``SweepPoint.drop_prob``.

    A point whose fanout equals ``k_max`` (default: the batch's largest)
    is its solo run, bit for bit; one of a smaller fanout draws the
    first columns of the ``k_max``-wide draw, which are its solo f-wide
    draw, so it is its solo run too.  ``group``: each rank runs its
    slice of the points (value-invariant).  ``_force_both`` builds both
    halves whatever the modes (a test hook)."""
    points = _check_grid(points, fault)
    _check_divides(len(points), group, "configs", "sweep")
    topos, multi, topo0 = _normalize_topos(topo, points)
    all_implicit = all(t.implicit for t in topos)
    if multi and not all_implicit and any(t.implicit for t in topos):
        raise ValueError(
            "a topology batch mixes implicit (complete) and explicit "
            "entries; the stacked-table operand and the traced-bound "
            "draw are different programs — batch them separately")
    n = max(t.n for t in topos)
    ragged = multi and any(t.n != n for t in topos)
    if ragged:
        if fault is not None:
            raise ValueError(
                "a mixed-n sweep takes no FaultConfig: the static death "
                "draw is shaped by each point's own n in a solo run, so "
                "a shared draw would silently change trajectories; run "
                "faulted points as a same-n batch")
        min_n = min(t.n for t in topos)
        worst_r = max((pt.rumors or rumors) for pt in points)
        if run.origin + worst_r > min_n:
            raise ValueError(
                f"origin {run.origin} + rumors {worst_r} exceeds the "
                f"smallest n ({min_n}) in the batch: rumor r seeds node "
                "(origin + r) % n, which would differ from the solo run "
                "on the smaller graphs")
        if all_implicit and min_n < 2:
            raise ValueError("mixed-n complete batches need every "
                             "n >= 2 (the traced self-exclusion bound)")
    k_max = k_max or max(pt.fanout for pt in points)
    if any(pt.fanout > k_max for pt in points):
        raise ValueError("k_max smaller than a point's fanout")
    dev = _device(topo0, group, device)
    stacked = multi and not all_implicit
    tables = _stack_topologies(topos, dev) if stacked else None
    eff_rumors = [pt.rumors or rumors for pt in points]
    r_max = max(eff_rumors)
    mixed_rumors = len(set(eff_rumors)) > 1
    have_ae = any(pt.mode == C.ANTI_ENTROPY for pt in points)
    need_push = _force_both or any(_MODE_FLAGS[pt.mode][0] for pt in points)
    need_pull = _force_both or any(_MODE_FLAGS[pt.mode][1] for pt in points)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    static_alive = alive_mask(fault, n, run.origin, dev)
    base = init_state(run, ProtocolConfig(mode=C.PUSH, rumors=r_max), n,
                      dev)
    order = _local(range(len(points)), group)
    chunks = _chunks(len(order), n * (k_max * DRAW_BYTES + 8 * r_max))
    cnts, msgs = [], []
    for sl in chunks:
        sel = order[sl]
        pts = [points[i] for i in sel]
        fl = _Flags(pts, dev)
        n_pt = torch.tensor([topos[p.topo_idx].n for p in pts],
                            dtype=torch.int64, device=dev)
        r_pt = torch.tensor([eff_rumors[i] for i in sel],
                            dtype=torch.int64, device=dev)
        tidx = torch.tensor([p.topo_idx for p in pts], dtype=torch.int64,
                            device=dev)
        if ragged:
            alive = ids[None, :] < n_pt[:, None]
        elif static_alive is not None:
            alive = static_alive[None]
        else:
            alive = torch.ones(1, n, dtype=torch.bool, device=dev)
        if stacked:
            deg_p = tables[1][tidx]

            def peers(key, deg_p=deg_p, tidx=tidx):
                return _stack_peers(key, ids, tables[0], deg_p,
                                    tidx, k_max, n)
        elif all_implicit:
            bound = _b(n_pt) if ragged else n

            def peers(key, bound=bound):
                return sample_peers_complete(key, ids, bound,
                                             k_max, True)
        else:
            def peers(key):
                return sample_peers_table(key, ids, topo0.nbrs,
                                          topo0.deg, k_max, n)

        def step(state, fl=fl, alive=alive, peers=peers):
            rkey = threefry.fold_in(state.key, state.round)
            visible = state.seen & alive[..., None]
            delta, mp, mq = _sweep_round_delta(
                rkey[:, None], state.round, ids, visible, alive, peers,
                k_max, fl, n, have_ae, n, lambda c: c, lambda v: v,
                need_push, need_pull)
            return SimState(seen=state.seen | delta, round=state.round + 1,
                            key=state.key, msgs=(state.msgs + mp) + mq)

        seen0 = base.seen
        if mixed_rumors:
            seen0 = base.seen[None] & (torch.arange(r_max, device=dev)
                                       < r_pt[:, None])[:, None, :]
        real = (torch.arange(r_max, device=dev)[None] < r_pt[:, None]
                if mixed_rumors else None)
        weight = alive if (ragged or static_alive is not None) else None
        c, m, _, _ = _scan(step, _batch_state(seen0, _keys(
            [p.seed for p in pts], dev)), run.max_rounds,
            lambda seen, w=weight, real=real: _min_count(seen, w, real))
        cnts.append(c)
        msgs.append(m)
    counts = np.concatenate(cnts)
    if ragged:
        totals = np.asarray([topos[points[i].topo_idx].n for i in order])
    elif static_alive is not None:
        totals = int(static_alive.sum())
    else:
        totals = n
    curves = _fractions(counts, totals, folded=static_alive is None)
    curves, msgs = _gather(group, curves, np.concatenate(msgs))
    return ConfigSweepResult(points=points, curves=curves, msgs=msgs,
                             rounds_to_target=_rounds_to_target(
                                 curves, run.target_coverage),
                             target=run.target_coverage,
                             meta={"batch_chunks": len(chunks)})


def config_sweep_curves_partitioned(points, topo, run: RunConfig,
                                    fault: Optional[FaultConfig] = None,
                                    k_max: Optional[int] = None,
                                    rumors: int = 1,
                                    device=None) -> ConfigSweepResult:
    """A mixed grid as one batch a mode bucket (push only, pull only,
    both), so a pure bucket never builds the other half; one shared
    ``k_max``, results in the caller's point order, the same
    trajectories as the single batch.  One device only (bucket sizes
    rarely divide a mesh)."""
    points = tuple(points)
    if not points:
        raise ValueError("need at least one SweepPoint")
    k_max = k_max or max(pt.fanout for pt in points)
    buckets: dict = {}
    for i, pt in enumerate(points):
        buckets.setdefault(_MODE_FLAGS[pt.mode], []).append(i)
    if len(buckets) == 1:
        return config_sweep_curves(points, topo, run, fault, k_max, rumors,
                                   device=device)
    curves = np.zeros((len(points), run.max_rounds), np.float32)
    msgs = np.zeros_like(curves)
    chunks = 0
    for idxs in buckets.values():
        sub = config_sweep_curves([points[i] for i in idxs], topo, run,
                                  fault, k_max, rumors, device=device)
        curves[idxs] = sub.curves
        msgs[idxs] = sub.msgs
        chunks += sub.meta["batch_chunks"]
    return ConfigSweepResult(points=points, curves=curves, msgs=msgs,
                             rounds_to_target=_rounds_to_target(
                                 curves, run.target_coverage),
                             target=run.target_coverage,
                             meta={"batch_chunks": chunks,
                                   "mode_buckets": len(buckets)})


# -- the request megabatch (the serving batcher's driver) -------------------

@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One serving request, megabatch-shaped: everything but
    ``proto.fanout`` (the shared draw width), ``proto.exclude_self``,
    ``run.max_rounds`` and the topology or n-bucket is a per-lane
    operand of one batched round (mode flags, period, seed, origin,
    target, n within the bucket, rumors within the rumor bucket, drop
    table, static deaths, the whole fault program)."""
    proto: ProtocolConfig
    run: RunConfig
    fault: Optional[FaultConfig]
    n: int

    def __post_init__(self):
        # the reference's words
        if self.proto.mode not in _MODE_FLAGS:
            raise ValueError(
                f"request batching supports {sorted(_MODE_FLAGS)}; got "
                f"{self.proto.mode!r} (flood/swim/rumor change the round "
                "structure — dispatch them solo)")
        if not self.proto.exclude_self:
            raise ValueError("request batching samples with the shared "
                             "exclude_self=True contract")
        if self.proto.period > 1 and self.proto.mode != C.ANTI_ENTROPY:
            raise ValueError("period > 1 is the anti-entropy cadence")
        if self.n < 2:
            raise ValueError("request batching needs n >= 2 (the traced "
                             "peer bound's self-exclusion shift)")


@dataclasses.dataclass
class RequestSweepResult:
    """K requests through one batch: ``curves`` / ``msgs`` / ``dropped``
    ``float32[K, T]``, ``counts`` the exact integers behind the curves,
    and ``state_digests``, the sha256 of each request's final
    ``seen[:n, :rumors]`` as C-contiguous numpy bool bytes (the bytes the
    reference hashes)."""
    specs: tuple
    curves: np.ndarray
    msgs: np.ndarray
    dropped: np.ndarray
    rounds_to_target: np.ndarray
    state_digests: tuple
    counts: Optional[np.ndarray] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def metrics_rows(self):
        """Each request's round metrics as plain lists (the reference's
        rows)."""
        return [{"mode": spec.proto.mode, "n": spec.n,
                 "rounds": int(self.curves.shape[1]),
                 "coverage": [float(c) for c in self.curves[i]],
                 "msgs": [float(m) for m in self.msgs[i]],
                 "dropped": [float(d) for d in self.dropped[i]],
                 "dropped_total": float(self.dropped[i].sum()),
                 "rounds_to_target": int(self.rounds_to_target[i])}
                for i, spec in enumerate(self.specs)]


def _pow2_at_least(x: int, lo: int = 1) -> int:
    """The smallest power of two >= max(x, lo): the serving buckets
    (n, rumors, lanes)."""
    x = max(int(x), lo)
    return 1 << (x - 1).bit_length()


def state_digest(seen: torch.Tensor, n: int, rumors: int) -> str:
    """sha256 of ``seen[:n, :rumors]`` as C-contiguous numpy bool bytes:
    a request's final state, comparable across packages."""
    block = np.ascontiguousarray(seen[:n, :rumors].cpu().numpy())
    return hashlib.sha256(block.tobytes()).hexdigest()


class _RequestFlags(_Flags):
    """A request batch's per-lane operands: the config sweep's flags
    with the shared fanout, and a drop probability that the round sets
    from each lane's table."""

    def __init__(self, specs, pad: int, k: int, any_drop: bool, dev):
        def t(vals, dummy, dtype):
            return torch.tensor(list(vals) + [dummy] * pad, dtype=dtype,
                                device=dev)
        modes = [sp.proto.mode for sp in specs]
        self.do_push = t((_MODE_FLAGS[m][0] for m in modes), False,
                         torch.bool)
        self.do_pull = t((_MODE_FLAGS[m][1] for m in modes), False,
                         torch.bool)
        self.do_ae = t((m == C.ANTI_ENTROPY for m in modes), False,
                       torch.bool)
        self.fanout = t((k for _ in specs), k, torch.int64)
        self.period = t((sp.proto.period for sp in specs), 1, torch.int64)
        self.drop = None
        self.any_drop = any_drop


def _request_batch(specs, pad: int, n_pad: int, r_max: int, k: int,
                   rounds: int, topo: Optional[Topology], need_push: bool,
                   need_pull: bool, have_ae: bool, dev):
    """One chunk of lanes through ``rounds`` batched rounds:
    ``(counts, msgs, lost, final seen)``, the first three ``[S, T]``
    numpy."""
    lanes = len(specs) + pad
    ids = torch.arange(n_pad, dtype=torch.int64, device=dev)
    seen0 = torch.zeros(lanes, n_pad, r_max, dtype=torch.bool, device=dev)
    base_alive = torch.zeros(lanes, n_pad, dtype=torch.bool, device=dev)
    weight = torch.zeros(lanes, n_pad, dtype=torch.bool, device=dev)
    for i, sp in enumerate(specs):
        cols = torch.arange(sp.proto.rumors, device=dev)
        seen0[i, (sp.run.origin + cols) % sp.n, cols] = True
        am = alive_mask(sp.fault, sp.n, sp.run.origin, dev)
        base_alive[i, :sp.n] = True if am is None else am
        ma = NE.metric_alive(sp.fault, sp.n, sp.run.origin, dev)
        weight[i, :sp.n] = True if ma is None else ma
    sched = NE.build_request_stack([sp.fault for sp in specs],
                                   [sp.n for sp in specs], n_pad, dev)
    if pad:
        die = torch.full((pad, n_pad), NE.NEVER, dtype=torch.int32,
                         device=dev)
        t_pad = sched.cut_tbl.shape[1]
        sched = NE.Schedule(
            torch.cat([sched.die, die]), torch.cat([sched.rec, die]),
            torch.cat([sched.cut_tbl, torch.full(
                (pad, t_pad), -1, dtype=torch.int32, device=dev)]),
            torch.cat([sched.drop_tbl, torch.zeros(
                (pad, t_pad), dtype=torch.float32, device=dev)]))
    fl = _RequestFlags(specs, pad, k,
                       bool((sched.drop_tbl > 0).any()), dev)
    real = (torch.arange(r_max, device=dev)[None]
            < torch.tensor([sp.proto.rumors for sp in specs] + [1] * pad,
                           device=dev)[:, None])
    if topo is not None:
        nbrs, deg = topo.nbrs.to(dev), topo.deg.to(dev)

        def peers(key):
            return sample_peers_table(key, ids, nbrs, deg, k, n_pad)
    else:
        bound = _b(torch.tensor([sp.n for sp in specs] + [2] * pad,
                                dtype=torch.int64, device=dev))

        def peers(key):
            return sample_peers_complete(key, ids, bound, k, True)

    def step(state):
        r = state.round
        alive = base_alive & ~((sched.die <= r) & (sched.rec > r))
        fl.drop = NE.drop_at(sched, r)
        rkey = threefry.fold_in(state.key, r)
        delta, mp, mq, lost = _sweep_round_delta(
            rkey[:, None], r, ids, alive[..., None] & state.seen, alive,
            peers, k, fl, n_pad, have_ae, n_pad, lambda c: c, lambda v: v,
            need_push, need_pull, cut=NE.cut_at(sched, r), want_lost=True)
        return SimState(seen=state.seen | delta, round=r + 1, key=state.key,
                        msgs=(state.msgs + mp) + mq), lost

    seeds = [sp.run.seed for sp in specs] + [0] * pad
    counts, msgs, lost, final = _scan(
        step, _batch_state(seen0, _keys(seeds, dev)), rounds,
        lambda seen: _min_count(seen, weight, real), lost=True)
    return counts, msgs, lost, final.seen


def request_sweep_curves(specs, topo: Optional[Topology] = None,
                         n_pad: Optional[int] = None, group=None,
                         lanes: Optional[int] = None,
                         timing: Optional[dict] = None,
                         device=None) -> RequestSweepResult:
    """K heterogeneous serving requests as one batch, exactly
    ``max_rounds`` rounds (the admission batcher's megabatch,
    :mod:`gossip_tpu_torch.rpc.batcher`).  Request i's curve, msgs,
    rounds to its target and final state are its solo
    ``runtime/simulator.simulate_curve``'s, bit for bit: its draws are
    keyed by global node id (so the bucket's padding rows are inert),
    its drop coins and cut come in the solo round's order, and its msgs
    add in the solo order (the push term, then the pull term).

    ``topo`` None is the implicit complete graph (requests may differ in
    n within the pow2 ``n_pad`` bucket, each draw bounded by its own n);
    a :class:`Topology` is one shared explicit table (every request's n
    must be its n).  ``lanes`` pads the batch with inert lanes (no mode
    flag set, every node dead) to that many (default: the request
    count, no inert lane).  The push, pull and anti-entropy halves are
    built only where some request's mode runs them.  The reference pads
    to a power of two and keeps every half on (its ``full``) to hold one
    XLA executable a batch key; the port compiles nothing, so it pays
    for neither (ROADMAP queue 3).

    Coverage leaves the device as an exact integer count per lane and
    round, read once, and becomes a fraction on the host as the solo
    loops make it: the product with ``float32(1 / n)`` without an alive
    set, the quotient under static deaths, and under a fault program
    without random deaths the product with the reciprocal of the
    eventual alive count (``ops/nemesis.folded_denominator``).  The
    reference's megabatch divides in that last case, which its own solo
    run does not (ROADMAP queue 3); ``counts`` holds the integers.

    ``group`` (:mod:`gossip_tpu_torch.parallel.group`, the reference's
    request-axis ``mesh``): the lanes split over the ranks, rank r taking
    the contiguous slice ``[r * lanes / K, (r + 1) * lanes / K)``, so
    ``lanes`` must divide by K (the reference's words).  Each rank runs
    its slice's requests (its inert lanes are read nowhere and are not
    run), takes its own lanes' state digests, and one all_gather per
    output (counts, msgs, dropped, digests) puts every lane back in lane
    order on every rank: value-invariant, since lanes never read each
    other.  A rank whose whole slice is inert still takes part in every
    all_gather, with zero rows.  ``timing`` gets ``steady_s``, the
    batch's device time, the gathers included
    (:func:`~gossip_tpu_torch.utils.timing.steady_timed`, which writes
    its ``driver_timing`` event)."""
    from gossip_tpu_torch.utils.timing import steady_timed
    specs = tuple(specs)
    if not specs:
        raise ValueError("need at least one RequestSpec")
    # the reference's words
    kset = {sp.proto.fanout for sp in specs}
    if len(kset) > 1:
        raise ValueError(
            f"request batch mixes fanouts {sorted(kset)}: the draw "
            "width is the one static the solo-bitwise contract pins "
            "(group by fanout in the batch key)")
    k = kset.pop()
    mrset = {sp.run.max_rounds for sp in specs}
    if len(mrset) > 1:
        raise ValueError(
            f"request batch mixes max_rounds {sorted(mrset)}: the scan "
            "length is static (group by max_rounds in the batch key)")
    max_rounds = mrset.pop()
    if topo is not None:
        bad = [sp.n for sp in specs if sp.n != topo.n]
        if bad:
            raise ValueError(
                f"explicit-table requests must match the shared "
                f"topology's n={topo.n}; got {bad}")
        if n_pad is not None and n_pad != topo.n:
            raise ValueError("explicit-table batches keep n_pad == n")
        n_pad = topo.n
    else:
        want = _pow2_at_least(max(sp.n for sp in specs), 2)
        n_pad = want if n_pad is None else n_pad
        if n_pad < want:
            raise ValueError(f"n_pad={n_pad} below the batch's pow2 "
                             f"bucket {want}")
    r_max = _pow2_at_least(max(sp.proto.rumors for sp in specs))
    kn = len(specs)
    lanes = kn if lanes is None else lanes
    if lanes < kn:
        raise ValueError(f"lanes={lanes} below the batch size {kn}")
    if group is not None and lanes % group.size:
        # the reference's words
        raise ValueError(
            f"{lanes} request lanes do not divide over the request mesh "
            f"axis of size {group.size}")
    need_push = any(_MODE_FLAGS[sp.proto.mode][0] for sp in specs)
    need_pull = any(_MODE_FLAGS[sp.proto.mode][1] for sp in specs)
    have_ae = any(sp.proto.mode == C.ANTI_ENTROPY for sp in specs)
    if group is None:
        dev = (si_mod.topology_device(topo, device) if topo is not None
               else resolve_device(device))
        # every lane here; the padding lanes run inert in their chunk
        mine, pad_lanes = specs, lanes - kn
    else:
        dev = group.device
        per = lanes // group.size
        mine, pad_lanes = specs[group.rank * per:(group.rank + 1) * per], 0

    def run_chunks():
        point = n_pad * (k * DRAW_BYTES * 2 + 8 * r_max)
        outs = []
        for sl in _chunks(len(mine) + pad_lanes, point):
            chunk = mine[sl.start:min(sl.stop, len(mine))]
            if not chunk:
                break                 # inert lanes only: nothing to read
            pad = (sl.stop - sl.start) - len(chunk)
            outs.append(_request_batch(chunk, pad, n_pad, r_max, k,
                                       max_rounds, topo, need_push,
                                       need_pull, have_ae, dev))
        return outs

    def run_gathered():
        outs = run_chunks()
        digests = [state_digest(seen, sp.n, sp.proto.rumors)
                   for seen, sp in zip((s for o in outs for s in o[3]),
                                       mine)]
        local = [_rows(np.concatenate([o[j] for o in outs]) if outs
                       else None, per, max_rounds, dtype)
                 for j, dtype in ((0, np.int64), (1, np.float32),
                                  (2, np.float32))]
        local.append(_rows(np.array([np.frombuffer(d.encode(), np.uint8)
                                     for d in digests], np.uint8)
                           .reshape(len(digests), 64), per, 64, np.uint8))
        c, m, lo, dg = _gather(group, *local)
        return ([(c, m, lo)], [bytes(row).decode() for row in dg[:kn]],
                len(outs))

    if group is None:
        outs, steady = steady_timed(dev, run_chunks)
        finals = [s for o in outs for s in o[3]][:kn]
        chunks = len(outs)
    else:
        (outs, digests, chunks), steady = steady_timed(dev, run_gathered)
    if timing is not None:
        timing["steady_s"] = steady
    counts = np.concatenate([o[0] for o in outs])[:kn]
    msgs = np.concatenate([o[1] for o in outs])[:kn]
    lost = np.concatenate([o[2] for o in outs])[:kn]
    curves = np.empty(counts.shape, np.float32)
    rtt = np.full(kn, -1, np.int64)
    for i, sp in enumerate(specs):
        _, total, folded = ensemble_readout(sp.fault, sp.n, sp.run.origin,
                                            dev)
        curves[i] = _fractions(counts[i], total, folded)
        rtt[i] = _rounds_to_target(curves[i:i + 1],
                                   sp.run.target_coverage)[0]
    if group is None:
        digests = [state_digest(seen, sp.n, sp.proto.rumors)
                   for seen, sp in zip(finals, specs)]
    meta = {"lanes": lanes, "n_pad": n_pad, "rumor_bucket": r_max,
            "batch_chunks": chunks}
    if group is not None:
        meta["devices"] = group.size
    return RequestSweepResult(specs=specs, curves=curves, msgs=msgs,
                              dropped=lost, rounds_to_target=rtt,
                              state_digests=tuple(digests), counts=counts,
                              meta=meta)


def _rows(a: Optional[np.ndarray], rows: int, width: int,
          dtype) -> np.ndarray:
    """``a`` (``[r, width]``, r <= rows; None: no rows) padded with zero
    rows to ``[rows, width]``: a rank's share of a request batch's
    gather, its inert lanes zero."""
    out = np.zeros((rows, width), dtype)
    if a is not None and len(a):
        out[:len(a)] = a
    return out


def config_sweep_curves_2d(points, topo, run: RunConfig, mesh,
                           fault: Optional[FaultConfig] = None,
                           k_max: Optional[int] = None,
                           rumors: int = 1) -> ConfigSweepResult:
    """The pod sweep: configs split over the outer axis of a hybrid mesh
    (:func:`~gossip_tpu_torch.parallel.multislice.make_hybrid_mesh`, one
    row of ranks a slice of the configs), every config's nodes over the
    inner axis with the dense exchange's collectives (an all_gather of
    the visible rows, a reduce-scatter of the push counts, the msgs
    partials added in rank order).  Same trajectories as
    :func:`config_sweep_curves`; the coverage divides by the alive count
    (the reference's ``psum`` quotient).  ``topo`` may be a sequence of
    same-n explicit topologies; every rank returns every config's
    curves."""
    from gossip_tpu_torch.parallel.group import pad_rows
    from gossip_tpu_torch.parallel.sharded import sharded_alive
    points = _check_grid(points, fault)
    if mesh.coords is None:
        raise ValueError("this rank is outside the hybrid mesh")
    topos, multi, topo0 = _normalize_topos(topo, points)
    if multi and any(t.n != topo0.n for t in topos):
        raise ValueError(
            "the 2-D pod sweep shards ONE node dimension; mixed-n "
            "phantom batching is the 1-D config_sweep_curves path — "
            "run the pod sweep per n")
    eff = {pt.rumors or rumors for pt in points}
    if len(eff) > 1:
        raise ValueError(
            "the 2-D pod sweep carries ONE rumor axis; mixed-rumor "
            "phantom batching is the 1-D config_sweep_curves path — "
            "run the pod sweep per rumor count")
    rumors = eff.pop()
    outer, inner = mesh.outer, mesh.inner
    if len(points) % outer.size:
        raise ValueError(f"{len(points)} configs do not divide over the "
                         f"sweep axis of size {outer.size}")
    k_max = k_max or max(pt.fanout for pt in points)
    if any(pt.fanout > k_max for pt in points):
        raise ValueError("k_max smaller than a point's fanout")
    dev = inner.device
    n = topo0.n
    n_pad, nl, lo = inner.rows(n)
    gids = torch.arange(lo, lo + nl, dtype=torch.int64, device=dev)
    alive_full = sharded_alive(fault, n, n_pad, run.origin, dev)
    alive = alive_full[lo:lo + nl][None]
    total = int(alive_full.sum())
    pts = _local(points, outer)
    fl = _Flags(pts, dev)
    have_ae = any(pt.mode == C.ANTI_ENTROPY for pt in points)
    need_push = any(_MODE_FLAGS[pt.mode][0] for pt in points)
    need_pull = any(_MODE_FLAGS[pt.mode][1] for pt in points)
    if multi or not topo0.implicit:
        nbrs, deg = _stack_topologies(topos, dev)
        nbrs = torch.cat([nbrs, torch.full(
            (nbrs.shape[0], n_pad - n, nbrs.shape[2]), n,
            dtype=nbrs.dtype, device=dev)], dim=1)[:, lo:lo + nl]
        deg = torch.cat([deg, torch.zeros((deg.shape[0], n_pad - n),
                                          dtype=deg.dtype, device=dev)],
                        dim=1)[:, lo:lo + nl]
        tidx = torch.tensor([p.topo_idx for p in pts], dtype=torch.int64,
                            device=dev)
        deg_p = deg[tidx]
        local_ids = torch.arange(nl, dtype=torch.int64, device=dev)

        def peers(key):
            # keyed by global id, read from this rank's rows
            d = deg_p.to(torch.int64)[..., None]
            idx = threefry.randint(node_keys(key, gids), (k_max,),
                                   0, torch.clamp(d, min=1))
            t = nbrs[tidx[:, None, None], local_ids[None, :, None],
                     idx].to(torch.int64)
            return torch.where(d > 0, t, n)
    else:
        def peers(key):
            return sample_peers_complete(key, gids, n, k_max, True)

    def node_major(x):
        return x.transpose(0, 1).contiguous()

    def gather(v):               # [S, nl, R] -> [S, n_pad, R]
        return inner.all_gather(node_major(v)).transpose(0, 1)

    def count_reduce(c):         # [S, n_pad, R] -> this rank's [S, nl, R]
        return inner.reduce_scatter_sum(node_major(c)).transpose(0, 1)

    seen0 = pad_rows(init_state(run, ProtocolConfig(mode=C.PUSH,
                                                    rumors=rumors), n,
                                dev).seen, n_pad, False)[lo:lo + nl]

    def step(state):
        rkey = threefry.fold_in(state.key, state.round)
        visible = state.seen & alive[..., None]
        delta, mp, mq = _sweep_round_delta(
            rkey[:, None], state.round, gids, visible, alive, peers, k_max,
            fl, n, have_ae, n_pad, count_reduce, gather, need_push,
            need_pull)
        total_msgs = inner.combine_f32(mp + mq)
        return SimState(seen=state.seen | delta, round=state.round + 1,
                        key=state.key, msgs=state.msgs + total_msgs)

    def count(seen):
        held = (seen & alive[..., None]).sum(dim=-2, dtype=torch.int64)
        return inner.all_reduce_sum(held).min(dim=-1).values

    cnts, msgs, _, _ = _scan(step, _batch_state(seen0, _keys(
        [p.seed for p in pts], dev)), run.max_rounds, count)
    curves = _fractions(cnts, total, folded=False)
    curves, msgs = _gather(outer, curves, msgs)
    return ConfigSweepResult(points=points, curves=curves, msgs=msgs,
                             rounds_to_target=_rounds_to_target(
                                 curves, run.target_coverage),
                             target=run.target_coverage,
                             meta={"batch_chunks": 1})


# -- rumor-mongering and SWIM ensembles ------------------------------------

@dataclasses.dataclass
class RumorEnsembleResult:
    curves: np.ndarray             # float32[S, T] coverage per seed/round
    hot: np.ndarray                # float32[S, T] infective fraction
    msgs: np.ndarray               # float32[S, T]
    target: float
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def extinction_rounds(self) -> np.ndarray:
        """int[S]: first round with no hot pair (+1), -1 if none."""
        out = np.full(self.hot.shape[0], -1, np.int64)
        for i, h in enumerate(self.hot):
            idx = np.nonzero(h == 0.0)[0]
            if len(idx):
                out[i] = idx[0] + 1
        return out

    @property
    def residues(self) -> np.ndarray:
        return 1.0 - self.curves[:, -1]

    def summary(self) -> dict:
        ext = self.extinction_rounds
        done = ext >= 0
        # an at-extinction statistic: seeds still hot at max_rounds are
        # left out, like the extinction stats
        res = self.residues[done]
        return {
            "seeds": int(len(ext)),
            "terminated": int(done.sum()),
            "extinction_rounds_mean": (float(ext[done].mean())
                                       if done.any() else None),
            "extinction_rounds_p95": (float(np.percentile(ext[done], 95))
                                      if done.any() else None),
            "residue_mean": float(res.mean()) if len(res) else None,
            "residue_p50": float(np.median(res)) if len(res) else None,
            "residue_p95": (float(np.percentile(res, 95))
                            if len(res) else None),
            "residue_max": float(res.max()) if len(res) else None,
            "coverage_mean": float(self.curves[:, -1].mean()),
            "msgs_mean": float(self.msgs[:, -1].mean()),
            "target": self.target,
        }


def ensemble_rumor_curves(proto: ProtocolConfig, topo: Topology,
                          run: RunConfig, seeds: Sequence[int],
                          fault: Optional[FaultConfig] = None, group=None,
                          device=None) -> RumorEnsembleResult:
    """|seeds| rumor-mongering trajectories as one batch
    (:func:`~gossip_tpu_torch.models.rumor.make_rumor_round_batched`),
    exactly ``run.max_rounds`` rounds; each seed's coverage, hot share
    and msgs are its solo ``simulate_curve_rumor``'s (the solo loop's
    chooser).  ``group``: each rank runs its slice of the seeds."""
    from gossip_tpu_torch.models import rumor as RU
    seeds = list(seeds)
    if not seeds:
        raise ValueError("need at least one seed (pass seeds or count)")
    _check_divides(len(seeds), group, "seeds", "seed")
    dev = _device(topo, group, device)
    mine = _local(seeds, group)
    step = NE.drop_lost(RU.make_rumor_round_batched(
        proto, topo, fault, run.origin, dev), NE.get(fault))
    base = RU.init_rumor_state(run, proto, topo.n, dev)
    alive, total, folded = ensemble_readout(fault, topo.n, run.origin, dev)
    chunks = _chunks(len(mine), topo.n * (proto.fanout * DRAW_BYTES
                                          + 16 * proto.rumors))
    covs, hots, msgs = [], [], []
    for sl in chunks:
        s = len(mine[sl])

        def rows(x):
            return x.expand((s,) + tuple(x.shape)).clone()
        state = RU.RumorState(
            seen=rows(base.seen), hot=rows(base.hot), cnt=rows(base.cnt),
            round=0, base_key=_keys(mine[sl], dev),
            msgs=torch.zeros(s, dtype=torch.float32, device=dev))
        cnt = torch.zeros(run.max_rounds, 2, s, dtype=torch.int64,
                          device=dev)
        msg = torch.zeros(run.max_rounds, s, dtype=torch.float32,
                          device=dev)
        for r in range(run.max_rounds):
            state = step(state)
            cnt[r, 0] = _min_count(state.seen, alive)
            hot_any = state.hot.any(dim=-1)
            if alive is not None:
                hot_any = hot_any & alive
            cnt[r, 1] = hot_any.sum(dim=-1)
            msg[r] = state.msgs
        cnt = cnt.cpu().numpy()
        covs.append(_fractions(cnt[:, 0].T, total, folded))
        hots.append(_fractions(cnt[:, 1].T, total, folded))
        msgs.append(msg.T.cpu().numpy())
    covs, hots, msgs = _gather(group, *(np.concatenate(x)
                                        for x in (covs, hots, msgs)))
    return RumorEnsembleResult(curves=covs, hot=hots, msgs=msgs,
                               target=run.target_coverage,
                               meta={"batch_chunks": len(chunks)})


def ensemble_swim_curves(proto: ProtocolConfig, n: int, run: RunConfig,
                         seeds: Sequence[int], dead_nodes=(),
                         fail_round: int = 0,
                         fault: Optional[FaultConfig] = None,
                         topo: Optional[Topology] = None, group=None,
                         device=None) -> EnsembleResult:
    """|seeds| SWIM failure-detection trajectories of one scenario as one
    batch (:func:`~gossip_tpu_torch.models.swim.make_swim_round_batched`):
    ``curves`` is each round's detection fraction (the solo
    ``simulate_swim_curve``'s quotient), so ``rounds_to_target`` is
    rounds-to-detection.  ``group``: each rank runs its slice of the
    seeds."""
    from gossip_tpu_torch.models import swim as SW
    from gossip_tpu_torch.topology.generators import complete
    seeds = list(seeds)
    if not seeds:
        raise ValueError("need at least one seed (pass seeds or count)")
    _check_divides(len(seeds), group, "seeds", "seed")
    dev = _device(complete(n) if topo is None else topo, group, device)
    mine = _local(seeds, group)
    rounds, s_count = run.max_rounds, proto.swim_subjects
    dead = tuple(dead_nodes)
    step = SW.make_swim_round_batched(proto, n, dead, fail_round, fault,
                                      topo, max_rounds=rounds, device=dev)
    observers = SW.observer_alive(n, dead, fault, dev)
    targets = SW.detection_targets(dead, fault)
    epoch_rounds = SW.resolve_epoch_rounds(proto, n)
    chunks = _chunks(len(mine), n * (proto.fanout * DRAW_BYTES
                                     + 64 * s_count))
    curves, msgs = [], []
    for sl in chunks:
        s = len(mine[sl])
        zeros = torch.zeros(s, n, s_count, dtype=torch.int32, device=dev)
        state = SW.SwimState(wire=zeros, timer=zeros.clone(), round=0,
                             base_key=_keys(mine[sl], dev),
                             msgs=torch.zeros(s, dtype=torch.float32,
                                              device=dev))
        table = torch.zeros(rounds, 2, s, dtype=torch.int64, device=dev)
        msg = torch.zeros(rounds, s, dtype=torch.float32, device=dev)
        for r in range(rounds):
            state = step(state)
            if targets:
                # the solo loops' detection counts, a point each
                window = SW.subject_window(r, s_count, n, proto.swim_rotate,
                                           epoch_rounds, dev)
                slots = SW._dead_slots(state.wire, targets, window)
                table[r, 0] = ((state.wire >= SW.DEAD_WIRE) & slots
                               & observers[:, None]).sum(dim=(-2, -1))
                table[r, 1] = observers.sum() * slots.sum()
            msg[r] = state.msgs
        table = table.cpu().tolist()
        curves.append(np.asarray(
            [[SW.detection_quotient(c, p) for c, p in zip(*row)]
             for row in table] if targets else np.zeros((rounds, s)),
            np.float32).T.reshape(s, rounds))
        msgs.append(msg.T.cpu().numpy())
    curves, msgs = _gather(group, np.concatenate(curves),
                           np.concatenate(msgs))
    return EnsembleResult(curves=curves, msgs=msgs,
                          rounds_to_target=_rounds_to_target(
                              curves, run.target_coverage),
                          target=run.target_coverage,
                          meta={"batch_chunks": len(chunks)})
