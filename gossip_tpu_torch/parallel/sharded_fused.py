"""Rumor-plane sharding of the fused multi-rumor round over
``torch.distributed``: scale the rumors, not the traffic.

The port of the JAX package's ``parallel/sharded_fused.py``.  Pull gossip
gives every node one partner a round, and the partner's whole digest
rides that exchange: rumors never choose partners.  So the state ``W``
planes of the one-word-per-node layout (plane ``p`` holds rumors ``32p``
to ``32p + 31``, :mod:`gossip_tpu_torch.ops.fused_mr_round`) shards plane
by plane over the ranks: rank ``k`` of ``K`` holds planes ``[k * W/K,
(k + 1) * W/K)`` (:func:`local_planes`) and advances each with the same
fused round, keyed by the same ``(seed, round)``.  The port's Philox
stream is a pure function of that key, so every rank draws the same
partner for every node, and no plane ever reads another: the merge
exchanges nothing between ranks.  The one collective of a run is the
stop test's minimum over the ranks' counts, once a round
(:meth:`~gossip_tpu_torch.parallel.group.Group.all_reduce_min`).  The
trajectory does not depend on K: plane ``p`` after R rounds is the
single-device multi-rumor loop's table from origin ``origin + 32p``.

Rumor padding (the reference's): planes are whole 32-bit words; rumor
columns past ``rumors``, and whole planes past ``ceil(rumors / 32)``
when W is padded up to a multiple of K, start all-ones at every real
node, so they sit at coverage 1.0 from round 0 and never win the
minimum.  Phantom nodes stay zero.

The loops (:func:`simulate_until_sharded_fused`,
:func:`simulate_curve_sharded_fused`) keep each local plane in the
kernel's lane-major ping-pong buffers (one transpose in, one out) and
launch ``csrc/fused_mr_round.cu`` once per local plane per round through
:func:`~gossip_tpu_torch.ops.fused_mr_round.fused_mr_round_lanes` (on a
CPU tensor its plain version); each launch adds its plane's per-rumor
counts to a device counter.  Faults are the round's operands: static
deaths as alive words and the drop coin's 20-bit threshold; under a
fault program (:mod:`gossip_tpu_torch.ops.nemesis`) each round's alive
words (rendered from lane-major die and recover tables where they
change), partition cut words (where the cut changes) and threshold, all
read at the absolute round.

The stop test and the report are the reference's compiled chooser
(:func:`coverage_planes_masked`): without an alive set the minimum count
times ``float32(1 / n)`` (XLA folds the division by the static ``n``);
with deaths, or under a program (the eventual alive words), the minimum
count of alive bits over the alive total, a true quotient.  Every plane
shares one denominator, and both roundings never decrease as the count
grows, so the ranks reduce integer counts and round the minimum once.
Under a program the count is ``popcount(table & eventual)``: the
kernel's counter less the bits the table holds at nodes that are dead
from the start (constant: they receive nothing) and at the permanently
crashed nodes (gathered each round: they receive until their crash).

:func:`checkpointed_fused_planes` runs a fixed number of rounds in
checkpointed segments (:mod:`gossip_tpu_torch.utils.checkpoint`) with
the same rounds and operands, the planes lane-major between checkpoints
and written in the reference's ``[W, rows, 128]`` layout, all ranks'
planes in one file.

Under an active run ledger the two loops record the reference's round
metrics (:class:`PlaneRecorder`) from the kernel's per-rumor counters,
which the loops already keep for the stop test, in one pass after the
loop: no second pass over the planes and no work inside the loop.

:func:`assert_prng_invariant` checks on every rank that the partner
stream is the same: one identically keyed round on one deterministic
plane, digested and gathered.  A differing rank raises.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch.config import RunConfig
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.ops.common import (f32_fraction, f32_mean, from_words,
                                         to_words)
from gossip_tpu_torch.ops.fused_round import BITS, LANES, drop_threshold_for
from gossip_tpu_torch.ops.philox import MASK32
from gossip_tpu_torch.utils.timing import steady_timed


def plane_count(rumors: int, n_devices: int) -> int:
    """Planes covering ``rumors``, padded up to a multiple of the mesh."""
    w = -(-rumors // BITS)
    return -(-w // n_devices) * n_devices


def local_planes(rumors: int, group) -> range:
    """The global indices of the planes this rank holds."""
    w_local = plane_count(rumors, group.size) // group.size
    return range(group.rank * w_local, (group.rank + 1) * w_local)


def _i32(word: int) -> int:
    """A 32-bit word as the int32 with its bits."""
    return word - (1 << 32) if word >= 1 << 31 else word


def init_plane_state(n: int, rumors: int, group,
                     origin: int = 0) -> torch.Tensor:
    """This rank's planes at round 0, ``int32[W_local, mr_rows(n), 128]``
    on the group's device: rumor ``32p + j`` at node ``(origin + 32p + j)
    % n``; padding rumor columns and planes all-ones at every real node.
    Only this rank's planes are built."""
    if not 0 <= origin < n:
        raise ValueError(f"origin {origin} out of range for n={n}")
    planes = local_planes(rumors, group)
    dev = group.device
    rows = MR.mr_rows(n)
    out = torch.zeros(len(planes), rows * LANES, dtype=torch.int32,
                      device=dev)
    for i, p in enumerate(planes):
        lo = p * BITS
        real = max(0, min(rumors - lo, BITS))
        out[i, :n] = _i32((MASK32 << real) & MASK32)
        words = {}
        for j in range(real):
            node = (origin + lo + j) % n
            words[node] = words.get(node, 0) | 1 << j
        if words:
            idx = torch.tensor(list(words), device=dev)
            out[i, idx] |= torch.tensor([_i32(w) for w in words.values()],
                                        dtype=torch.int32, device=dev)
    return out.reshape(len(planes), rows, LANES)


def _counts(planes: torch.Tensor, words=None) -> torch.Tensor:
    """int64[W, 32]: each plane's count of every bit (of ``planes &
    words`` when ``words`` is given)."""
    return torch.stack([MR.rumor_counts(p if words is None else p & words,
                                        BITS) for p in planes])


def _global_min(group, local: torch.Tensor) -> torch.Tensor:
    """The minimum over the ranks (this rank's alone without a group)."""
    return local if group is None else group.all_reduce_min(local)


def _fraction(count: int, n: int, total: Optional[int]) -> float:
    """The reference's compiled coverage of a minimum count: the product
    with ``float32(1 / n)`` without an alive set (``total`` None), else
    the quotient by the alive total."""
    return f32_mean(count, n) if total is None else f32_fraction(count,
                                                                 total)


def _alive_total(words: torch.Tensor) -> int:
    return int((to_words(words) & 1).sum())


def coverage_planes(planes: torch.Tensor, n: int) -> float:
    """Min-over-rumors infected fraction over a stack of planes, as the
    reference's compiled loops compute it: ``float32(min count) *
    float32(1 / n)``.  Padding rumors sit at 1.0 and never win."""
    return coverage_planes_masked(planes, n)


def coverage_planes_masked(planes: torch.Tensor, n: int,
                           alive_words=None) -> float:
    """The one plane-coverage chooser of the compiled loops: without
    ``alive_words`` :func:`coverage_planes`; with them (0xFFFFFFFF alive,
    0 dead, reference layout) the minimum count of alive bits over the
    alive total, ``float32(c) / float32(a)`` (the padding rumors stay at
    1.0: every alive node holds their bits)."""
    total = None if alive_words is None else _alive_total(alive_words)
    return _fraction(int(_counts(planes, alive_words).min()), n, total)


def _planes_round(planes, seed, round_, n: int, fanout: int, bits,
                  args: dict) -> torch.Tensor:
    """One round of a stack in the reference's layout through the loops'
    own :func:`_round`: one transpose in, one out."""
    lanes = planes.transpose(1, 2).contiguous()
    pop = torch.zeros(lanes.shape[0], BITS, dtype=torch.int32,
                      device=lanes.device)
    lanes, _ = _round(lanes, torch.empty_like(lanes), pop, seed, round_, n,
                      fanout, args, bits)
    return lanes.transpose(1, 2).contiguous()


def make_sharded_fused_round_masked(n: int, fanout: int = 1,
                                    inject_bits=None,
                                    has_alive: bool = False,
                                    has_cut: bool = False):
    """``round_fn(planes, seed, round_, alive_words=None,
    drop_threshold=0, cut_words=None)``: one round of this rank's planes
    (``int32[W_local, R, 128]``, the reference's layout) with every
    fault input an operand (reference layout too), each plane through
    :func:`~gossip_tpu_torch.ops.fused_mr_round.fused_mr_round_lanes`
    (the kernel on the card, the plain round on the CPU).
    ``inject_bits`` is one ``(sbits, rbits)`` pair for every plane: one
    partner stream.  Every rank runs it on its own planes: nothing
    crosses ranks."""

    def round_fn(planes, seed, round_, alive_words=None, drop_threshold=0,
                 cut_words=None):
        if (alive_words is not None) != has_alive:
            raise ValueError("alive_words must be passed exactly when the "
                             "round was built with has_alive=True")
        if (cut_words is not None) != has_cut:
            raise ValueError("cut_words must be passed exactly when the "
                             "round was built with has_cut=True")
        bits = (None if inject_bits is None
                else MR.lanes_bits(inject_bits, planes.device))
        return _planes_round(planes, seed, round_, n, fanout, bits, dict(
            drop_threshold=drop_threshold,
            alive_lanes=MR.to_lanes(alive_words),
            cut_lanes=MR.to_lanes(cut_words)))

    return round_fn


def make_sharded_fused_round(n: int, group, fanout: int = 1,
                             inject_bits=None, fault=None, origin: int = 0):
    """``round_fn(planes, seed, round_)``: one round of this rank's planes
    under ``fault`` with the loops' operands (:class:`_Operands`): static
    deaths as the alive words and the static threshold; under a program
    the alive words, cut words and threshold of the absolute
    ``round_``."""
    ops = _Operands(n, fault, origin, group.device)
    bits = None if inject_bits is None else MR.lanes_bits(inject_bits,
                                                          group.device)

    def round_fn(planes, seed, round_):
        return _planes_round(planes, seed, round_, n, fanout, bits,
                             ops.round_args(round_))

    return round_fn


def _digest_table(n: int, device) -> torch.Tensor:
    """The invariant's input plane: ``((i * 2654435761) ^ (j * 40503)) |
    1`` at row i, lane j, in 32-bit arithmetic."""
    i = torch.arange(MR.mr_rows(n), dtype=torch.int64, device=device)[:, None]
    j = torch.arange(LANES, dtype=torch.int64, device=device)[None, :]
    return from_words((((i * 2654435761) ^ (j * 40503)) | 1) & MASK32)


def plane_digest(table: torch.Tensor) -> tuple:
    """``(popcount, mix)`` of a plane, each mod 2^32: the total of set
    bits and ``sum(word * (2 * (i * 128 + j) + 1))`` (a distinct odd
    weight a position, so a swap of two words changes the mix)."""
    w = to_words(table)
    pop = int(MR.rumor_counts(table, BITS).sum()) & MASK32
    pos = torch.arange(w.numel(), dtype=torch.int64,
                       device=w.device).reshape(w.shape)
    mix = int(((w * (2 * pos + 1)) & MASK32).sum()) & MASK32
    return pop, mix


def prng_invariant_digests(n: int, group, seed: int = 0, round_: int = 1,
                           fanout: int = 1, inject_bits=None) -> np.ndarray:
    """``uint32[K, 2]``: every rank's :func:`plane_digest` of one round of
    the same deterministic plane (:func:`_digest_table`) keyed by ``(seed,
    round_)``, gathered in rank order.  Equal rows: every rank drew the
    same partner stream.  ``inject_bits`` replaces the draw (all zeros
    reproduce the reference's interpreter, which stubs its hardware PRNG
    with zeros)."""
    out = MR.fused_multirumor_pull_round(
        _digest_table(n, group.device), seed, round_, n, fanout,
        inject_bits=inject_bits)
    mine = torch.tensor([plane_digest(out)], dtype=torch.int64,
                        device=group.device)
    return group.all_gather(mine).cpu().numpy().astype(np.uint32)


def assert_prng_invariant(n: int, group, seed: int = 0, round_: int = 1,
                          fanout: int = 1, inject_bits=None) -> np.ndarray:
    """Raise unless every rank drew the same partner stream; return the
    digest table."""
    d = prng_invariant_digests(n, group, seed, round_, fanout, inject_bits)
    if not (d == d[0]).all():
        raise AssertionError(
            "zero-ICI plane-sharding PRNG invariant VIOLATED: devices "
            f"drew different partner streams; digests per device:\n{d}")
    if int(d[0, 0]) == 0:
        raise AssertionError(
            "degenerate digest (popcount 0) — the check input never "
            "reached the kernel")
    return d


class _Operands:
    """One run's fault operands on one rank, lane-major, and the stop
    test's count: each round's drop threshold, alive lanes and cut lanes
    (rendered again only where the program changes them), the alive
    total of the coverage (None: the folded product over n), and the
    correction that turns the kernel's per-rumor counters into counts of
    the metric's alive bits."""

    def __init__(self, n: int, fault, origin: int, device):
        NE.check_supported(fault, engine="fused-planes")
        self.n, self.dev = n, device
        ch = NE.get(fault)
        self.churn = ch is not None
        self.thr = drop_threshold_for(fault)
        self.alive = None           # static alive lanes
        self.static = None          # words whose bits never change
        self.metric = None          # the coverage's alive words
        self.perm = None            # permanently crashed nodes' positions
        self.fixed = None           # counts at nodes dead from the start
        if self.churn:
            cut, thr = NE.fused_sched_tables(fault, n)
            self.cut_tbl = torch.from_numpy(cut)
            self.thr_tbl = torch.from_numpy(thr)
            base = NE.fused_base_words(fault, n, origin, device)
            die, rec = NE.fused_word_tables(fault, n, device)
            self.metric = NE.fused_eventual_words(base, die, rec)
            self.static = base
            self.tables = tuple(MR.to_lanes(t) for t in (base, die, rec))
            # the alive words change only at the events' rounds
            self.changes = sorted({e[1] for e in ch.events}
                                  | {e[2] for e in ch.events if e[2] >= 0})
            flat = base.reshape(-1)
            perm = [v for v in NE.permanent_dead_ids(ch) if int(flat[v])]
            if perm:
                v = torch.tensor(perm, dtype=torch.int64, device=device)
                self.perm = (v & (LANES - 1), v >> 7)
            self._keys = [None, None]
        elif fault is not None and fault.node_death_rate:
            self.metric = self.static = MR.fault_masks_word(
                fault, n, origin, device)[0]
            self.alive = MR.to_lanes(self.metric)
        self.total = (None if self.metric is None
                      else _alive_total(self.metric))

    def start(self, planes: torch.Tensor) -> torch.Tensor:
        """This rank's least count of the start planes; records the
        constant part of the counters' correction and drops the static
        words, which no round reads (the metric's stay, for the eager
        coverage of :meth:`cov_fn`)."""
        self.fixed = (None if self.static is None
                      else _counts(planes, ~self.static))
        self.static = None
        return _counts(planes, self.metric).min()

    def cov_fn(self, group=None):
        """``planes -> coverage`` (:func:`fused_planes_cov_fn`) over this
        run's metric words."""
        words = self.metric
        total = self.n if self.total is None else self.total

        def cov(planes):
            least = _counts(planes, words).min().reshape(1)
            return f32_fraction(int(_global_min(group, least)[0]), total)

        return cov

    def round_args(self, r: int) -> dict:
        """The kernel's operands of round ``r``."""
        if not self.churn:
            return dict(drop_threshold=self.thr, alive_lanes=self.alive)
        alive_key = bisect.bisect_right(self.changes, r)
        if alive_key != self._keys[0]:
            self._keys[0] = alive_key
            self.alive = NE.fused_alive_words_at(*self.tables, r)
        cut = int(NE._idx(self.cut_tbl, r))
        if cut != self._keys[1]:
            self._keys[1] = cut
            self.cut = MR.to_lanes(MR.render_cut_words(cut, self.n,
                                                       self.dev))
        return dict(drop_threshold=int(NE._idx(self.thr_tbl, r)),
                    alive_lanes=self.alive, cut_lanes=self.cut)

    def counts(self, pop: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
        """int64[W, 32]: this rank's count of each rumor's bits at the
        metric's nodes after a round, the round's counters ``pop``
        (int32[W, 32]) less the bits at nodes outside the metric."""
        c = pop.to(torch.int64)
        if self.fixed is not None:
            c = c - self.fixed
        if self.perm is not None:
            words = to_words(lanes[:, self.perm[0], self.perm[1]])
            bits = torch.arange(BITS, device=words.device)
            c = c - ((words[..., None] >> bits) & 1).sum(dim=1)
        return c

    def least(self, pop: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
        """This rank's least count of the metric's bits, a 0-d device
        tensor (:meth:`counts`)."""
        return self.counts(pop, lanes).min()

    def fraction(self, count: int) -> float:
        return _fraction(count, self.n, self.total)


class PlaneRecorder:
    """The reference's ``_plane_recorder``, read after the loop from the
    kernel counters it already keeps, ``pops[r]`` (int32[W_local, 32],
    every plane's count of each bit after round ``r``): a round's count
    is their sum (every set bit, the all-ones rumor padding a constant
    that cancels in ``newly``), this rank's front its least count times
    ``float32(1 / n)``.  ``msgs`` is the driver's ``2 * fanout * n``;
    ``offered`` every delivered digest bit (``fanout * n`` times the
    mesh's ``W * 32``); ``bytes`` 4, the stop test's reduction, the only
    traffic between ranks.  The loop itself records nothing: the stack
    is filled in one pass over the rounds run (:meth:`finish`)."""

    def __init__(self, label: str, n: int, rumors: int, fanout: int, group,
                 max_rounds: int, planes: torch.Tensor):
        w = plane_count(rumors, group.size)
        self.n = n
        self.offered = float(np.float32(fanout * n) * np.float32(w * BITS))
        self.msgs = 2.0 * fanout * n
        self.start = RM.count_planes(planes).reshape(1)
        self.m = RM.init(max(max_rounds, 1), group.size, label, group.device,
                         group=group, local_shards=1)

    def finish(self, pops: torch.Tensor, rounds: int) -> RM.RoundMetrics:
        """The stack of the loop's first ``rounds`` rounds, from their
        counters ``pops[:rounds]`` (device arithmetic, no host read)."""
        p = pops[:rounds]
        RM.record_rounds(
            self.m, rounds,
            newly=torch.diff(p.to(torch.int64).sum((1, 2)),
                             prepend=self.start),
            front=RM.front_counts(p.amin((1, 2)), self.n)[:, None],
            msgs=self.msgs, offered=self.offered, bytes=4.0)
        return self.m


def _recorder(label, n, rumors, fanout, group, run, lanes):
    if not RM.wanted():
        return None
    return PlaneRecorder(label, n, rumors, fanout, group, run.max_rounds,
                         lanes)


def _init_and_masks(n: int, rumors: int, run: RunConfig, group, fault):
    """``(lanes, operands, least start count)``: this rank's start planes
    transposed to the kernel's lane-major layout ``int32[W_local, 128,
    R]`` and the run's operands (built first: a static death draw's
    temporaries never meet the planes)."""
    ops = _Operands(n, fault, run.origin, group.device)
    planes = init_plane_state(n, rumors, group, run.origin)
    least = ops.start(planes)
    return planes.transpose(1, 2).contiguous(), ops, least


def _round(lanes, spare, pop, seed: int, r: int, n: int, fanout: int,
           args: dict, inject_bits=None):
    """One round of every local plane into ``spare`` under the round's
    operands ``args`` (:meth:`_Operands.round_args`): one kernel launch
    a plane, its counts added to ``pop[p]``.  Returns the new pair."""
    for p in range(lanes.shape[0]):
        MR.fused_mr_round_lanes(lanes[p], seed, r, n, fanout, inject_bits,
                                rumors=BITS, out=spare[p], pop=pop[p],
                                **args)
    return spare, lanes


def _timed_init(n, rumors, run, group, fault, timing):
    (lanes, ops, least), init_s = steady_timed(
        group.device, _init_and_masks, n, rumors, run, group, fault)
    if timing is not None:
        timing["init_build_s"] = init_s
    return lanes, ops, least


def _finish(lanes, steady_s, timing):
    """The final planes in the reference's layout."""
    if timing is not None:
        timing["steady_s"] = steady_s
    return lanes.transpose(1, 2).contiguous()


def simulate_until_sharded_fused(n: int, rumors: int, run: RunConfig, group,
                                 fanout: int = 1, fault=None, timing=None):
    """``(rounds, coverage, msgs, final planes)``: this rank's run of the
    plane-sharded rounds until the min-over-rumors coverage of every
    rank's planes reaches ``run.target_coverage`` or the round counter
    ``run.max_rounds`` (the reference's compiled while-loop).  The stop
    test reads this rank's counters once a round and takes the minimum
    over the ranks in one reduction; the coverage is the loop's last
    (the compiled chooser, module doc).  ``msgs`` is ``2 * fanout * n``
    a round, all planes riding one exchange.  ``timing`` gets the
    state's build (``init_build_s``) and the loop's seconds
    (``steady_s``)."""
    dev = group.device
    lanes, ops, least = _timed_init(n, rumors, run, group, fault, timing)
    # the start's stop test, outside the timed loop: its reduction also
    # waits for the slowest rank's set-up
    cov = ops.fraction(int(_global_min(group, least.reshape(1))[0]))
    rec = _recorder("simulate_until_sharded_fused", n, rumors, fanout,
                    group, run, lanes)

    def loop(lanes, cov):
        target = np.float32(run.target_coverage)
        pops = torch.zeros(max(run.max_rounds, 1), *lanes.shape[:1], BITS,
                           dtype=torch.int32, device=dev)
        spare = torch.empty_like(lanes)
        r = 0
        while cov < target and r < run.max_rounds:
            lanes, spare = _round(lanes, spare, pops[r], run.seed, r, n,
                                  fanout, ops.round_args(r))
            m = _global_min(group, ops.least(pops[r], lanes).reshape(1))
            cov = ops.fraction(int(m[0]))
            r += 1
        RM.deliver(rec and rec.finish(pops, r))
        return lanes, r, cov        # the spare buffer is freed here

    (lanes, rounds, cov), steady = steady_timed(dev, loop, lanes, cov)
    final = _finish(lanes, steady, timing)
    return rounds, cov, 2.0 * fanout * n * rounds, final


def simulate_curve_sharded_fused(n: int, rumors: int, run: RunConfig, group,
                                 fanout: int = 1, fault=None, timing=None):
    """``(coverage after each of run.max_rounds rounds, final planes)``:
    the fixed-length twin of :func:`simulate_until_sharded_fused` (no
    early exit).  Each round's least count stays on the device; one
    reduction over the ranks at the end turns them into the curve."""
    dev = group.device
    lanes, ops, _ = _timed_init(n, rumors, run, group, fault, timing)
    rec = _recorder("simulate_curve_sharded_fused", n, rumors, fanout,
                    group, run, lanes)

    def loop(lanes):
        rounds = run.max_rounds
        pops = torch.zeros(max(rounds, 1), *lanes.shape[:1], BITS,
                           dtype=torch.int32, device=dev)
        least = torch.zeros(rounds, dtype=torch.int64, device=dev)
        spare = torch.empty_like(lanes)
        for r in range(rounds):
            lanes, spare = _round(lanes, spare, pops[r], run.seed, r, n,
                                  fanout, ops.round_args(r))
            least[r] = ops.least(pops[r], lanes)
        RM.deliver(rec and rec.finish(pops, rounds))
        counts = _global_min(group, least).tolist() if rounds else []
        return lanes, [ops.fraction(c) for c in counts]

    (lanes, covs), steady = steady_timed(dev, loop, lanes)
    return covs, _finish(lanes, steady, timing)


def fused_planes_cov_fn(n: int, fault=None, origin: int = 0, group=None,
                        device=None):
    """``planes -> coverage`` of this rank's planes (reference layout),
    the minimum over every rank's: the reference's eager value, the
    least count over ``n`` (a quotient, where its compiled loops
    multiply by the reciprocal), alive-weighted under deaths, and under
    a program over the eventual alive words."""
    return _Operands(n, fault, origin, group.device if group is not None
                     else device).cov_fn(group)


def restore_plane_state(planes: torch.Tensor, group) -> torch.Tensor:
    """This rank's planes of a loaded checkpoint's stack (``[W, rows,
    128]``, already padded to the mesh, so a resume on the same number of
    ranks is bitwise; the configuration fingerprint refuses another), on
    the group's device."""
    from gossip_tpu_torch.utils.checkpoint import rank_rows
    return rank_rows(planes, group)


def checkpointed_fused_planes(n: int, rumors: int, run: RunConfig, group,
                              path: str, every: int = 50, fanout: int = 1,
                              resume_state=None, want_curve: bool = False,
                              curve_prefix=(), extra_meta=None, fault=None,
                              stats=None):
    """This rank's share of a plane-sharded fused run of
    ``run.max_rounds`` rounds in checkpointed segments: the rounds and
    operands of :func:`simulate_curve_sharded_fused` (one launch of
    ``csrc/fused_mr_round.cu`` a local plane a round, keyed by the
    absolute round; the operand path under a fault program), from
    ``resume_state`` (a loaded ``FusedState`` whose ``table`` is the
    stack) or round 0.  The planes stay lane-major between checkpoints
    and are written in the reference's layout, every rank's in one file.
    ``msgs`` is a float32 carry, ``2 * fanout * n`` added a round (not
    the product of the straight loops' report).  The curve is the least
    count of each round, reduced over the ranks at the checkpoint.
    Returns ``(final FusedState of this rank's planes in the reference's
    layout, coverage, curve or None)``, the coverage eager
    (:func:`fused_planes_cov_fn`)."""
    from gossip_tpu_torch.ops.fused_round import FusedState
    from gossip_tpu_torch.utils.checkpoint import run_with_checkpoints
    dev = group.device
    ops = _Operands(n, fault, run.origin, dev)
    if resume_state is None:
        planes = init_plane_state(n, rumors, group, run.origin)
        round0, msgs0 = 0, np.float32(0.0)
    else:
        planes = restore_plane_state(resume_state.table, group)
        round0, msgs0 = resume_state.round, np.float32(resume_state.msgs)
    ops.start(planes)
    lanes = planes.transpose(1, 2).contiguous()
    del planes
    spare = torch.empty_like(lanes)
    pop = torch.zeros(lanes.shape[0], BITS, dtype=torch.int32, device=dev)
    add = np.float32(2.0 * fanout * n)

    def step(st):
        nonlocal spare
        pop.zero_()
        out, spare = _round(st.table, spare, pop, run.seed, st.round, n,
                            fanout, ops.round_args(st.round))
        return FusedState(table=out, round=st.round + 1,
                          msgs=np.float32(np.float32(st.msgs) + add))

    def reference_layout(st):
        return st._replace(table=st.table.transpose(1, 2).contiguous())

    kw = {}
    if want_curve:
        kw = dict(curve_fn=lambda st: ops.least(pop, st.table),
                  curve_reduce=group.all_reduce_min,
                  curve_value=lambda c: ops.fraction(int(c)))
    out = run_with_checkpoints(
        step, FusedState(table=lanes, round=round0, msgs=msgs0),
        max(0, run.max_rounds - round0), path, every=every,
        extra_meta=extra_meta, curve_prefix=curve_prefix, group=group,
        to_saved=reference_layout, stats=stats, **kw)
    final, curve = out if want_curve else (out, None)
    del spare
    final = reference_layout(final)
    return final, ops.cov_fn(group)(final.table), curve
