"""The nemesis: fault programs over rounds, consumed inside the round loops.

The port of the single-device part of the JAX package's
``ops/nemesis.py``.  A :class:`~gossip_tpu_torch.config.ChurnConfig`
(crash/recover events, partition windows, a drop-rate ramp) is lowered
once, on the host, into a :class:`Schedule` of four tensors on the run's
device:

* ``die`` / ``rec``: ``int32[n_pad]``, the round each node goes down and
  comes back (:data:`NEVER` where unscripted); node ``i`` is down during
  ``die[i] <= r < rec[i]``;
* ``cut_tbl``: ``int32[T]``, the partition cut of each round (-1: no
  window open);
* ``drop_tbl``: ``float32[T]``, the link drop probability of each round.

``T`` is :func:`canonical_horizon`: the round after which the program is
constant, rounded up to a power-of-two bucket by repeating the final row.
That row is the steady state, so the clamped lookup ``tbl[min(r, T-1)]``
is exact at every round.  The round steps index the tables with their
round counter; a schedule stays a set of tensors on the device, so the
rounds read no schedule value on the host.

Semantics (the reference's): a node that is down neither sends, answers
nor receives; a message across an open cut is lost for that round only
and is sent again in a later one; the drop coin of round ``r`` is the
static path's coin (same tags, same per-node keys) at probability
``drop_tbl[r]``, and a round at probability 0 draws an all-False mask.
The coverage denominator is the eventual alive set (:func:`eventual_alive`):
a node that recovers stays in it.

The fused rumor planes (:mod:`gossip_tpu_torch.parallel.sharded_fused`)
take the same program in the fused one-word-per-node layout:
:func:`fused_sched_tables` (each round's cut and 20-bit drop threshold),
:func:`fused_base_words`, :func:`fused_word_tables` (die and recover
rounds a word), :func:`fused_alive_words_at` and
:func:`fused_eventual_words`.

The byzantine half: a :class:`~gossip_tpu_torch.config.ByzConfig` (liars
that serve forged state) is lowered by :func:`build_byz` into a
:class:`ByzSchedule` of per-node tables, which only the CRDT and the
LWW-register exchanges read
(:func:`~gossip_tpu_torch.ops.crdt.pull_merge_crdt_byz`,
:func:`~gossip_tpu_torch.ops.registers.pull_merge_reg_byz`); every other
engine refuses a liar program through :func:`check_supported`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch.config import (BYZ_CORRUPT, BYZ_EQUIVOCATE,
                                     BYZ_INFLATE, BYZ_REPLAY, ByzConfig,
                                     ChurnConfig, FaultConfig)
from gossip_tpu_torch.ops.common import resolve_device

# "Never": far beyond any run, safely below int32 overflow under +1.
NEVER = 1 << 29

# Minimum canonical table length: every horizon <= 32 shares one shape.
SCHED_T_MIN = 32


def get(fault: Optional[FaultConfig]) -> Optional[ChurnConfig]:
    """The fault program of ``fault``, or None (an empty one is None
    already: ``FaultConfig`` normalizes it)."""
    return fault.churn if fault is not None else None


def get_byz(fault: Optional[FaultConfig]) -> Optional[ByzConfig]:
    """The liar program of ``fault``, or None (an empty one is None
    already: ``FaultConfig`` normalizes it)."""
    return fault.byz if fault is not None else None


class Schedule(NamedTuple):
    """A lowered fault program (module doc): four tensors on one
    device."""

    die: torch.Tensor        # int32[n_pad]
    rec: torch.Tensor        # int32[n_pad]
    cut_tbl: torch.Tensor    # int32[T]
    drop_tbl: torch.Tensor   # float32[T]


def _event_tables(ch: ChurnConfig, size: int, device):
    """die/rec int32[size] from the event list (rec < 0 -> NEVER;
    unscripted rows NEVER), built in numpy and copied once."""
    die = np.full((size,), NEVER, np.int32)
    rec = np.full((size,), NEVER, np.int32)
    if ch.events:
        nodes = np.asarray([e[0] for e in ch.events], np.int64)
        die[nodes] = [e[1] for e in ch.events]
        rec[nodes] = [e[2] if e[2] >= 0 else NEVER for e in ch.events]
    return (torch.from_numpy(die).to(device),
            torch.from_numpy(rec).to(device))


def canonical_horizon(ch: ChurnConfig) -> int:
    """The table length T: ``horizon()`` rounded up to a power of two,
    at least :data:`SCHED_T_MIN`."""
    t = ch.horizon()
    return max(SCHED_T_MIN, 1 << (t - 1).bit_length())


def _cut_drop_rows(fault: FaultConfig, t_pad: Optional[int] = None):
    """(cut rows, drop-probability rows) as Python lists padded to
    ``t_pad`` (default :func:`canonical_horizon`) by repeating the final
    row.  The ramp is interpolated in Python floats, as the reference
    does; :func:`build` casts the list to float32 once."""
    ch = fault.churn
    t = ch.horizon()
    cut = [-1] * t
    for start, end, c in ch.partitions:
        for r in range(start, min(end, t)):
            cut[r] = c
    drop = [float(fault.drop_prob)] * t
    if ch.ramp is not None:
        start, end, p0, p1 = ch.ramp
        for r in range(start, t):
            frac = min((r - start) / max(end - start, 1), 1.0)
            drop[r] = p0 + (p1 - p0) * frac
    t_pad = canonical_horizon(ch) if t_pad is None else t_pad
    if t_pad < t:
        raise ValueError(f"t_pad={t_pad} below the schedule horizon {t}")
    cut += [cut[-1]] * (t_pad - t)
    drop += [drop[-1]] * (t_pad - t)
    return cut, drop


def validate_events(fault: FaultConfig, n: int) -> None:
    """Scripted events and cuts must name real node ids: an event past
    ``n`` would kill nobody, and a cut at or past ``n`` leaves one side
    empty."""
    ch = get(fault)
    if ch is None:
        return
    bad = [e for e in ch.events if e[0] >= n]
    if bad:
        raise ValueError(f"churn events reference node ids >= n={n}: "
                         f"{bad}")
    badc = [w for w in ch.partitions if w[2] >= n]
    if badc:
        raise ValueError(f"partition cuts >= n={n} leave one side "
                         f"empty: {badc}")


def build(fault: FaultConfig, n: int, n_pad: Optional[int] = None,
          t_pad: Optional[int] = None, device=None) -> Schedule:
    """Lower ``fault.churn`` to a :class:`Schedule` on ``device``
    (default CUDA).  ``n_pad`` sizes die/rec (padding rows NEVER);
    ``t_pad >= horizon()`` sizes the tables."""
    ch = get(fault)
    if ch is None:
        raise ValueError("build() needs a FaultConfig with a churn "
                         "schedule (gate on nemesis.get(fault) first)")
    validate_events(fault, n)
    dev = resolve_device(device)
    die, rec = _event_tables(ch, n if n_pad is None else n_pad, dev)
    cut, drop = _cut_drop_rows(fault, t_pad)
    return Schedule(
        die=die, rec=rec,
        cut_tbl=torch.from_numpy(np.asarray(cut, np.int32)).to(dev),
        drop_tbl=torch.from_numpy(np.asarray(drop, np.float32)).to(dev))


def build_stack(faults, n: int, n_pad: Optional[int] = None,
                device=None) -> Schedule:
    """K fault programs as one :class:`Schedule` with a leading scenario
    axis (die/rec ``int32[K, n_pad]``, cut/drop ``[K, T]``), every table
    padded to the stack's largest canonical horizon (exact: the final
    row is the steady state).  The operand of the churn sweep
    (:func:`gossip_tpu_torch.parallel.sweep.churn_sweep_curves`); the
    static structure each entry shares (deaths, scripted dead nodes) is
    the sweep's to check."""
    faults = tuple(faults)
    if not faults:
        raise ValueError("build_stack needs at least one FaultConfig")
    missing = [i for i, f in enumerate(faults) if get(f) is None]
    if missing:
        # the reference's words
        raise ValueError(
            f"scenario stack entries {missing} carry no churn schedule; "
            "a churn sweep batches fault PROGRAMS (static-only points "
            "belong in the plain ensemble/config sweeps)")
    t_pad = max(canonical_horizon(f.churn) for f in faults)
    scheds = [build(f, n, n_pad, t_pad=t_pad, device=device)
              for f in faults]
    return Schedule(*(torch.stack([s[i] for s in scheds])
                      for i in range(4)))


def build_or_static(fault: Optional[FaultConfig], n: int,
                    n_pad: Optional[int] = None,
                    t_pad: Optional[int] = None, device=None) -> Schedule:
    """A :class:`Schedule` for any fault: without a program, the steady
    tables (die/rec NEVER, every window closed, the drop table flat at
    the static ``drop_prob``).  A step run under these tables follows the
    static step's trajectory bit for bit."""
    if get(fault) is not None:
        return build(fault, n, n_pad, t_pad, device)
    dev = resolve_device(device)
    n_pad = n if n_pad is None else n_pad
    t_pad = SCHED_T_MIN if t_pad is None else t_pad
    dp = 0.0 if fault is None else float(fault.drop_prob)
    never = torch.full((n_pad,), NEVER, dtype=torch.int32, device=dev)
    return Schedule(
        die=never, rec=never.clone(),
        cut_tbl=torch.full((t_pad,), -1, dtype=torch.int32, device=dev),
        drop_tbl=torch.full((t_pad,), float(np.float32(dp)),
                            dtype=torch.float32, device=dev))


def _idx(tbl: torch.Tensor, round_: int) -> torch.Tensor:
    """The clamped lookup on the last axis (exact past the horizon: the
    last row is the steady state): a 0-d tensor, or one a scenario of a
    stacked table (:func:`build_stack`)."""
    return tbl[..., min(max(int(round_), 0), tbl.shape[-1] - 1)]


def alive_rows(sched: Schedule, base_alive: torch.Tensor,
               round_: int) -> torch.Tensor:
    """bool[n_pad] liveness at ``round_``: the static mask less the nodes
    that are down (``die <= r < rec``)."""
    r = int(round_)
    return base_alive & ~((sched.die <= r) & (sched.rec > r))


def drop_at(sched: Schedule, round_: int) -> torch.Tensor:
    """The round's drop probability, a float32 0-d tensor."""
    return _idx(sched.drop_tbl, round_)


def cut_at(sched: Schedule, round_: int) -> torch.Tensor:
    """The round's partition cut, an int32 0-d tensor (-1: closed)."""
    return _idx(sched.cut_tbl, round_)


def same_side(cut: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """True where a message ``a -> b`` is allowed: no window open, or
    both ends on one side of the cut.  Sentinel targets (``>= n``) land
    on the high side; the rounds' own masks drop them either way."""
    return (cut < 0) | ((a >= cut) == (b >= cut))


def partition_targets(cut: torch.Tensor, src_gids: torch.Tensor,
                      targets: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Targets across the open cut become the sentinel, in the targets'
    dtype (lost for this round only).  ``src_gids`` ``[m]`` broadcasts
    against ``targets`` ``[m, k]`` (or a batch's ``[S, m, k]``)."""
    src = (src_gids[:, None] if targets.dim() > src_gids.dim()
           else src_gids)
    return torch.where(same_side(cut, src, targets), targets, sentinel)


def _f32_count(mask: torch.Tensor) -> torch.Tensor:
    """The count over the last two axes (a batch point's), as float32."""
    return mask.sum(dim=(-2, -1)).to(torch.float32)


def lost_count(pre: torch.Tensor, post: torch.Tensor, active: torch.Tensor,
               n: int) -> torch.Tensor:
    """float32: messages the nemesis destroyed this round, the real
    targets (``< n``) of ``active`` senders before the drop coin and the
    cut, less those still real after; 0-d, or one a point of a batch
    (``[S, N, k]`` targets).  Counted in integers and rounded once, where
    the reference sums float32 (the same below 2^24)."""
    a = active[..., None]
    return _f32_count((pre < n) & a) - _f32_count((post < n) & a)


def base_alive_or_ones(fault: Optional[FaultConfig], n: int, origin: int,
                       device=None) -> torch.Tensor:
    """The static alive mask as a tensor (all True without deaths): the
    churn rounds always mask."""
    from gossip_tpu_torch.models.state import alive_mask
    dev = resolve_device(device)
    alive = alive_mask(fault, n, origin, dev)
    return (torch.ones(n, dtype=torch.bool, device=dev) if alive is None
            else alive)


def permanent_dead_ids(ch: Optional[ChurnConfig]) -> tuple:
    """Node ids the program kills forever (``recover_round < 0``)."""
    if ch is None:
        return ()
    return tuple(e[0] for e in ch.events if e[2] < 0)


def eventual_alive(fault: FaultConfig, n: int, origin: int,
                   device=None) -> torch.Tensor:
    """bool[n] steady-state liveness: the static mask less the permanent
    deaths, the coverage denominator under a program (a node that is
    down for a while stays in it: it recovers and must converge)."""
    alive = base_alive_or_ones(fault, n, origin, device)
    dead = permanent_dead_ids(get(fault))
    if dead:
        alive[list(dead)] = False
    return alive


def metric_alive(fault: Optional[FaultConfig], n: int, origin: int,
                 device=None) -> Optional[torch.Tensor]:
    """The coverage denominator of one device: the static mask (None
    without deaths) or, under a program, :func:`eventual_alive`."""
    from gossip_tpu_torch.models.state import alive_mask
    if get(fault) is not None:
        return eventual_alive(fault, n, origin, device)
    return alive_mask(fault, n, origin, resolve_device(device))


def folded_denominator(fault: Optional[FaultConfig]) -> bool:
    """Whether the reference's compiled loops see the alive-weighted
    coverage's denominator as a compile-time constant: under a program
    without random deaths the eventual alive set is built from constants
    inside the trace, XLA folds its sum, and the division by it becomes
    a product with its float32 reciprocal (``ops/common.f32_mean``).
    With random deaths the mask comes from a threefry draw, which XLA
    does not fold, and the loops divide."""
    return get(fault) is not None and fault.node_death_rate <= 0.0


def fused_sched_tables(fault: FaultConfig, n: int,
                       t_pad: Optional[int] = None):
    """``(cut int32[T], thr int32[T])``, numpy: the fused planes'
    schedule operands, the partition cut of each round (-1 closed) and
    the 20-bit drop threshold ``round(p * 2^20)`` of each round's drop
    probability, computed on the host in float64 as the static
    threshold is (a flat schedule's thresholds equal the static value).
    The loops read them by the clamped lookup (:func:`_idx`)."""
    if get(fault) is None:
        raise ValueError("fused_sched_tables needs a churn schedule")
    validate_events(fault, n)
    cut, drop = _cut_drop_rows(fault, t_pad)
    thr = [int(round(p * (1 << 20))) if p else 0 for p in drop]
    return np.asarray(cut, np.int32), np.asarray(thr, np.int32)


def fused_base_words(fault: Optional[FaultConfig], n: int, origin: int,
                     device=None) -> torch.Tensor:
    """The static alive mask in the fused one-word-per-node layout
    ``int32[mr_rows(n), 128]`` (-1, i.e. 0xFFFFFFFF, alive; 0 dead or
    phantom), always a tensor: the churn rounds always mask."""
    from gossip_tpu_torch.ops.fused_mr_round import render_alive_words
    return render_alive_words(
        base_alive_or_ones(fault, n, origin, device), n)


def fused_word_tables(fault: FaultConfig, n: int, device=None):
    """``(die, rec)``: the program's down and recover rounds in the fused
    one-word-per-node layout, ``int32[mr_rows(n), 128]`` (:data:`NEVER`
    on unscripted and phantom words)."""
    from gossip_tpu_torch.ops.fused_mr_round import mr_rows
    ch = get(fault)
    if ch is None:
        raise ValueError("fused_word_tables needs a churn schedule")
    validate_events(fault, n)
    rows = mr_rows(n)
    die, rec = _event_tables(ch, rows * 128, resolve_device(device))
    return die.reshape(rows, 128), rec.reshape(rows, 128)


def fused_alive_words_at(base: torch.Tensor, die: torch.Tensor,
                         rec: torch.Tensor, round_: int) -> torch.Tensor:
    """The alive words of ``round_``: the base words less the nodes that
    are down (``die <= r < rec``).  Elementwise, so any layout of the
    three tables (the loops keep them lane-major)."""
    r = int(round_)
    return torch.where((die <= r) & (r < rec), 0, base)


def fused_eventual_words(base: torch.Tensor, die: torch.Tensor,
                         rec: torch.Tensor) -> torch.Tensor:
    """The steady-state alive words, the fused planes' coverage
    denominator under a program: the base words less the permanent
    deaths (:func:`eventual_alive`, word-rendered)."""
    return torch.where((die < NEVER) & (rec >= NEVER), 0, base)


def drop_lost(step, ch: Optional[ChurnConfig]):
    """A round step as ``state -> state``: a step under a program returns
    ``(state, lost)``, and loops that do not record ``lost`` drop it
    here."""
    if ch is None:
        return step

    def wrapped(*args, **kwargs):
        out, _lost = step(*args, **kwargs)
        return out

    return wrapped


def check_supported(fault: Optional[FaultConfig], *, engine: str,
                    partitions: bool = True, ramp: bool = True,
                    events: bool = True, byz: bool = False) -> None:
    """Refuse, loudly, the parts of a program an engine cannot run:
    ``byz=False`` (the default) for an engine that cannot run a liar
    program (only the CRDT and the LWW-register pull exchanges render
    the liars' transforms and the defenses), checked first, so a liar
    program without a schedule is refused too; ``events=False`` for an
    engine with no churn support at all, ``partitions=False`` or
    ``ramp=False`` for one that cannot cut messages or follow a
    per-round drop probability."""
    if get_byz(fault) is not None and not byz:
        # the reference's words
        raise ValueError(
            f"the {engine} engine cannot run a byzantine liar program "
            "(no receiver-side transform/defense hooks in its "
            "exchange); run the crdt-pull or register-pull payloads — "
            "docs/ROBUSTNESS.md \"Byzantine adversaries\" capability "
            "rows")
    ch = get(fault)
    if ch is None:
        return
    if not events:
        raise ValueError(f"the {engine} engine does not run churn "
                         "schedules; use the dense/sparse exchanges "
                         "(docs/ROBUSTNESS.md scenario catalog)")
    if not partitions and ch.partitions:
        # the reference's words (SWIM is the engine that refuses a cut)
        raise ValueError(
            f"the {engine} engine cannot honor partition windows (no "
            "per-pair messages a node-id cut could destroy — SWIM "
            "probes ride the complete membership overlay); run the "
            "dense/sparse/halo/fused exchanges for partition scenarios")
    if not ramp and ch.ramp is not None:
        raise ValueError(f"the {engine} engine cannot follow a drop-rate "
                         "ramp")


# -- the byzantine program (scripted liars) ----------------------------

# Integer liar-kind codes of the lowered tables (0 = honest); the
# config-string -> code map is the one translation.
BYZ_HONEST = 0
BYZ_CODES = {BYZ_CORRUPT: 1, BYZ_REPLAY: 2, BYZ_EQUIVOCATE: 3,
             BYZ_INFLATE: 4}


class ByzSchedule(NamedTuple):
    """A lowered liar program: per-node ``kind`` codes
    (:data:`BYZ_CODES`, 0 honest), the ``start`` round of each lie
    (:data:`NEVER` on honest rows) and each liar's transform ``arg``,
    int32[n_pad] tensors on one device, and the defended set
    admission's ``quorum`` (a host int)."""

    kind: torch.Tensor       # int32[n_pad]
    start: torch.Tensor      # int32[n_pad]
    arg: torch.Tensor        # int32[n_pad]
    quorum: int


def validate_liars(fault: FaultConfig, n: int) -> None:
    """Scripted liars must name real node ids (a liar past ``n`` would
    corrupt nobody)."""
    bz = get_byz(fault)
    if bz is None:
        return
    bad = [a for a in bz.liars if a[0] >= n]
    if bad:
        raise ValueError(f"byz liars reference node ids >= n={n}: "
                         f"{bad}")


def build_byz(fault: FaultConfig, n: int, n_pad: Optional[int] = None,
              device=None) -> ByzSchedule:
    """Lower ``fault.byz`` to a :class:`ByzSchedule` on ``device``
    (default CUDA), built in numpy and copied once; padding rows are
    honest."""
    bz = get_byz(fault)
    if bz is None:
        raise ValueError("build_byz() needs a FaultConfig with a byz "
                         "program (gate on nemesis.get_byz(fault) "
                         "first)")
    validate_liars(fault, n)
    dev = resolve_device(device)
    n_pad = n if n_pad is None else n_pad
    kind = np.zeros((n_pad,), np.int32)
    start = np.full((n_pad,), NEVER, np.int32)
    arg = np.zeros((n_pad,), np.int32)
    for node, rnd, k, a in bz.liars:
        kind[node] = BYZ_CODES[k]
        start[node] = rnd
        arg[node] = a
    return ByzSchedule(kind=torch.from_numpy(kind).to(dev),
                       start=torch.from_numpy(start).to(dev),
                       arg=torch.from_numpy(arg).to(dev),
                       quorum=int(bz.quorum))


def honest_mask(fault: Optional[FaultConfig], n: int,
                device=None) -> torch.Tensor:
    """bool[n]: True where the node is not a scripted liar."""
    mask = np.ones((n,), bool)
    bz = get_byz(fault)
    if bz is not None:
        for node, _, _, _ in bz.liars:
            if node < n:
                mask[node] = False
    return torch.from_numpy(mask).to(resolve_device(device))


def byz_active(byz: ByzSchedule, nodes: torch.Tensor,
               round_: int) -> torch.Tensor:
    """bool[...]: whether each of ``nodes`` lies at ``round_`` (a kind
    and its start round reached).  Callers AND in liveness: a liar that
    is down serves nothing."""
    return (byz.kind[nodes] != BYZ_HONEST) & (byz.start[nodes] <= int(round_))


def mixed_scenarios(k: int, n: int, *, salt: int = 0,
                    drop_prob: float = 0.0, seed: int = 0,
                    ramp_to: float = 0.15, window_end: int = 4):
    """K mixed fault programs cycling four shapes: a crash and recovery,
    a partition window, a drop-rate ramp, and a permanent crash with a
    window (the reference's scenario family; ``salt`` varies the
    content, never a shape)."""
    out = []
    for i in range(k):
        kind = i % 4
        if kind == 0:
            ch = ChurnConfig(events=(((3 + i + salt) % n, 1, 4),))
        elif kind == 1:
            ch = ChurnConfig(partitions=((0, 2 + (i + salt) % 3, n // 2),))
        elif kind == 2:
            ch = ChurnConfig(ramp=(0, window_end, 0.0,
                                   ramp_to * (1 + i % 3) / 3))
        else:
            ch = ChurnConfig(events=(((11 + i + salt) % n, 1, -1),),
                             partitions=((1, window_end, n // 4),))
        out.append(FaultConfig(drop_prob=drop_prob, seed=seed, churn=ch))
    return out
