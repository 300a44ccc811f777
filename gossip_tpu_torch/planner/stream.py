"""Execute a ScalePlan: stream word-plane tiles through the packed pull
round.

The port of the JAX package's ``planner/stream.py``.  Why tiling along
the WORD-PLANE axis is exact: a packed PULL round's partner draws, drop
coins, liveness rows and partition cuts are all functions of
``(base_key, round, node id)`` — never of plane CONTENT
(models/si_packed.make_packed_round).  Gather-then-OR commutes with
column slicing, so a tile of Wt < W word planes runs the IDENTICAL
trajectory on its own columns, and the concatenation of T streamed
tiles is BITWISE the untiled in-memory run — the gate
:func:`untiled_reference` + ``check_bitwise`` asserts.

Execution contract:

* ONE tile step per plan: every tile pads its words to the plan's pow2
  ``bucket_words`` (padded planes are zero words — inert under the
  OR-merge).  The step (models/si_packed.make_packed_round, or on a node
  mesh parallel/sharded_packed.make_sharded_packed_round) is built once
  for a key with the schedule's CONTENT stripped and cached (bounded,
  FIFO, :data:`_STEP_CACHE_MAX`); its schedule tables are operands, so a
  salted program with the same shapes copies its tables into the cached
  ones and builds nothing.  The step draws its rows in
  :data:`DRAW_CHUNKS` node chunks, so its threefry draw's transient
  tensors fit the budget's partner terms (planner/budget).
* The segment (:func:`_segment`) is a loop of rounds with no host read
  inside it.  It carries ``msgs`` in the state and, under a fault
  program, the sequential float32 ``dropped``, as
  utils/checkpoint.run_with_checkpoints's ``track_lost`` does.
* THREE-STAGE PIPELINE on a card: a tile's words go host to device from
  a pinned staging buffer on a copy stream; its segment runs on the
  compute stream; its result goes device to host, non-blocking, into a
  pinned buffer on a fetch stream, with a recorded event.  The segment
  loop dispatches tile *k* and only THEN drains tile *k-1*: ``_drain``
  is the ONE place that waits (on that event), and then writes the
  columns into the host cursor.  ``overlap=False`` (CLI
  ``--no-overlap``) drains each tile at once, the serial A/B leg,
  bitwise the same.  On the CPU the three stages run in order.  The
  per-tile walls (``put_ms``, ``dispatch_ms``, ``wait_ms``, ``copy_ms``)
  go to the caller's ``stats`` list, and ``overlap_efficiency`` is the
  fraction of segment wall the host did NOT spend waiting.
* The host cursor is ``uint32[n, W]``, as the reference's file holds
  it; tiles cross to the device as its ``int32`` view.
* Ranks (one process each, ``parallel/group``): a plan with
  ``per_slice`` > 1 runs a node mesh, each rank streaming its own node
  rows of every tile.  A plan with ``dcn_slices`` > 1 runs the hybrid
  mesh (parallel/multislice.make_hybrid_mesh): slice ``s`` streams the
  tiles ``t`` with ``t % dcn_slices == s``, one drain slot in flight, and
  before each publish the slices exchange their columns, so every
  slice's cursor is the whole state and the file and the resume are the
  single-slice run's.  The host-side collectives (the exchange, the
  checkpoint's gather, the coverage counts) run over gloo groups on the
  CPU.
* Crash safety: every segment publishes an atomic checkpoint
  (utils/checkpoint.save_state, the reference's npz format: a
  ``SimState`` with ``extra = {round, dropped, scale_plan,
  fault_program}``), so either package resumes the other's file where
  their plan fingerprints agree; ``resume`` refuses a file of another
  plan or fault program, in the reference's words.

The run ledger gets the reference's events, with the numbers ``stats``
carries: ``scale_plan`` once, ``tile_stream`` a tile (unsynced),
``scale_segment`` a published segment, ``scale_run`` at the end, and
:func:`~gossip_tpu_torch.planner.budget.crosscheck_peak`'s
``budget_xcheck``.  Under several ranks rank 0 writes them, its own
tiles' ``tile_stream`` among them.

Scope refusals (the reference's): engine != packed, mode != pull, more
slices than the world has.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import List, Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig, ProtocolConfig
from gossip_tpu_torch.models.si_packed import make_packed_round
from gossip_tpu_torch.models.state import SimState
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.bitpack import rumor_count_tensor
from gossip_tpu_torch.ops.common import resolve_device
from gossip_tpu_torch.planner.budget import (WORD_BITS, ScalePlan,
                                             crosscheck_peak,
                                             plan_fingerprint)
from gossip_tpu_torch.topology import generators as G
from gossip_tpu_torch.utils import telemetry

# node chunks a tile step draws its rows in: the draw's transient
# tensors (int64 ids, keys, threefry words and partners; a bare draw
# peaks at about 64 bytes a draw on the card) are a sixteenth of the
# rows', inside the budget's partner_lanes term (16 bytes a node at
# fanout 1)
DRAW_CHUNKS = 16

CPU = torch.device("cpu")


@dataclasses.dataclass
class ScaleRunResult:
    """What a streamed run reports (the CLI prints it as JSON)."""

    n: int
    rounds: int
    coverage: float
    msgs: float
    dropped: float
    tiles: int
    bucket_words: int
    segments_run: int
    resumed: bool
    halted: bool                       # stopped by halt_after_segments
    bitwise_equal: Optional[bool]      # vs untiled_reference, if checked
    measured_loop_bytes: Optional[int]
    predicted_peak_device_bytes: int
    dcn_slices: int                    # tile fan-out width (1 = serial)
    overlap: bool                      # three-stage pipeline engaged?
    # 1 - (host stall wall / segment wall), clamped to [0, 1]; None
    # when no segment ran (module doc "THREE-STAGE PIPELINE")
    overlap_efficiency: Optional[float]
    final_state: Optional[np.ndarray]  # uint32[n, W] when keep_state

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("final_state")
        return d


def _init_rows(n: int, rumors: int, origin: int, lo: int,
               rows: int) -> np.ndarray:
    """uint32[rows, W]: the rows ``lo .. lo + rows`` of
    :func:`host_init_packed` (rows at or past ``n`` are zero)."""
    w = (rumors + WORD_BITS - 1) // WORD_BITS
    out = np.zeros((rows, w), np.uint32)
    r = np.arange(rumors)
    at = (origin + r) % n
    mine = (at >= lo) & (at < lo + rows)
    bits = np.left_shift(np.uint32(1),
                         (r % WORD_BITS).astype(np.uint32),
                         dtype=np.uint32)
    np.bitwise_or.at(out, (at[mine] - lo, (r // WORD_BITS)[mine]),
                     bits[mine])
    return out


def host_init_packed(n: int, rumors: int, origin: int) -> np.ndarray:
    """uint32[n, W] initial packed state in NUMPY — bitwise
    ``pack(init_state(...).seen)`` (rumor r starts at node
    ``(origin + r) % n``, models/state.init_state) without ever
    allocating the bool[N, R] table: at 100M nodes the device-side init
    IS the budget item streaming exists to avoid."""
    return _init_rows(n, rumors, origin, 0, n)


# Tile steps cached with the schedule CONTENT stripped from the key, so
# two fault programs sharing (static fault, canonical horizon) share ONE
# step and a salted re-entry builds nothing (its tables are copied into
# the step's own).  BOUNDED FIFO: a step holds device tensors (its
# schedule tables, its alive rows), so an unbounded dict would pin them
# for the life of the process; a scale run uses ONE entry.
_STEP_CACHE: dict = {}
_STEP_CACHE_MAX = 16


@dataclasses.dataclass
class _TileStep:
    """A cached tile step: the round, the schedule tables it reads when
    it runs (None without a program) and the program they hold, and the
    device bytes it holds between calls."""

    step: object
    sched: Optional[NE.Schedule]
    program: Optional[FaultConfig]
    resident_bytes: int


def _staged(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` (on the CPU) ready for a non-blocking copy to ``dev``: pinned
    for a card (a copy from pageable memory waits for the card)."""
    return t.pin_memory() if dev.type == "cuda" else t


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index (``cuda`` names the current card), so the
    tensors made on it compare equal to it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _allocated(dev: torch.device) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _tile_step(proto: ProtocolConfig, n: int, fault: Optional[FaultConfig],
               origin: int, group, dev: torch.device):
    """``(tile step, whether it came from the cache)``: the step of any
    word width on ``dev`` (on ``group``'s node mesh when given); under a
    program its tables hold this program's content."""
    ch = NE.get(fault)
    fault_static = (None if fault is None
                    else dataclasses.replace(fault, churn=None))
    t_pad = None if ch is None else NE.canonical_horizon(ch)
    place = (dev,) if group is None else (dev, group.rank, group.size,
                                          id(group.pg))
    key = (proto, n, fault_static, t_pad, origin, place)
    n_pad = n if group is None else group.rows(n)[0]
    hit = _STEP_CACHE.get(key)
    if hit is not None:
        if ch is not None and hit.program != fault:
            # tables are operands: this program's content, in place
            new = NE.build(fault, n, n_pad, t_pad=t_pad, device=CPU)
            for dst, src in zip(hit.sched, new):
                dst.copy_(_staged(src, dev), non_blocking=True)
            hit.program = fault
        return hit, True
    before = _allocated(dev)
    sched = (None if ch is None
             else NE.build(fault, n, n_pad, t_pad=t_pad, device=dev))
    topo = G.complete(n)
    if group is None:
        step = make_packed_round(proto, topo, fault, origin, device=dev,
                                 schedule=sched, chunks=DRAW_CHUNKS)
    else:
        from gossip_tpu_torch.parallel.sharded_packed import \
            make_sharded_packed_round
        step = make_sharded_packed_round(proto, topo, group, fault, origin,
                                         schedule=sched, chunks=DRAW_CHUNKS)
    while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
        _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
    ts = _TileStep(step, sched, fault, _allocated(dev) - before)
    _STEP_CACHE[key] = ts
    return ts, False


@functools.lru_cache(maxsize=_STEP_CACHE_MAX)
def _schedule_fingerprint(fault: Optional[FaultConfig], n: int,
                          origin: int) -> Optional[str]:
    """``nemesis.schedule_fingerprint``, once a program (it hashes the
    program's tables: about 1 GB at 100M nodes)."""
    return NE.schedule_fingerprint(fault, n, origin)


def _segment(step, state: SimState, rounds: int, acc=None):
    """``rounds`` rounds of ``step`` from ``state``, with no host read:
    ``(state, acc)``.  Under a program the step returns ``(state,
    lost)`` and ``acc`` (a float32 0-d tensor, the ``dropped`` carry)
    adds each round's ``lost`` in order."""
    for _ in range(rounds):
        if acc is None:
            state = step(state)
        else:
            state, lost = step(state)
            acc = acc + lost
    return state, acc


def _refuse(plan: ScalePlan) -> None:
    if plan.engine != "packed":
        raise ValueError(
            f"run_at_scale streams the packed engine only; plan says "
            f"engine={plan.engine!r} (the budget model covers it, the "
            "streamed executor does not — docs/SCALING.md scope)")
    if plan.mode != C.PULL:
        raise ValueError(
            f"run_at_scale streams PULL rounds only, got mode="
            f"{plan.mode!r} (anti-entropy's reverse delta writes "
            "cross-tile state — planner/budget.plan_scale already "
            "refuses this at plan time)")


def host_counts(state: np.ndarray, alive: Optional[np.ndarray] = None,
                chunk: int = 1 << 20):
    """``(int64[W * 32] counts, denominator)`` of a host packed state:
    each rumor bit's count over the (alive) rows, and the rows counted.
    Chunked so a 100M-row table never materializes its bit expansion."""
    n, w = state.shape
    counts = np.zeros(w * WORD_BITS, np.int64)
    denom = 0
    # the 32x bit expansion below transiently allocates rows*w*32
    # uint32s — bound it by WORDS processed, not rows
    chunk = max(1, chunk // max(w, 1))
    for lo in range(0, n, chunk):
        rows = state[lo:lo + chunk]
        if alive is not None:
            m = alive[lo:lo + chunk]
            rows = rows[m]
            denom += int(m.sum())
        else:
            denom += rows.shape[0]
        bits = (rows[:, :, None] >> np.arange(WORD_BITS,
                                              dtype=np.uint32)) & 1
        counts += bits.reshape(rows.shape[0], -1).sum(0, dtype=np.int64)
    return counts, denom


def host_coverage(state: np.ndarray, rumors: int,
                  alive: Optional[np.ndarray] = None,
                  chunk: int = 1 << 20) -> float:
    """Min-over-rumors coverage of a host packed state — the numpy twin
    of ops/bitpack.coverage_packed: integer counts, ONE division at the
    end (exact past 2^24 nodes, ROADMAP queue 3 item 3)."""
    counts, denom = host_counts(state, alive, chunk)
    if denom == 0:
        return 0.0
    return float(counts[:rumors].min() / denom)


@dataclasses.dataclass
class _Ranks:
    """This process's place in the plan's mesh: its device, its slice,
    the node mesh its tile step runs on (None: one device), the gloo
    groups of its host-side collectives (None: one process) and every
    rank's ``(slice, column)``."""

    dev: torch.device
    slice_index: int = 0
    step_group: object = None
    world: object = None             # gloo over every rank, on the CPU
    row0: object = None              # gloo over slice 0's ranks (members)
    coords: tuple = ((0, 0),)

    def rows(self, n: int):
        """``(n_pad, nl, lo)`` of this rank's node rows."""
        if self.step_group is None:
            return n, n, 0
        return self.step_group.rows(n)


def _ranks(plan: ScalePlan, group, device) -> _Ranks:
    """The :class:`_Ranks` of this process: one device without a group,
    else the rank ``group.rank`` of the plan's ``dcn_slices x per_slice``
    world (``group`` is the world's)."""
    if group is None:
        return _Ranks(_indexed(resolve_device(device)))
    want = max(1, plan.dcn_slices) * plan.per_slice
    if group.size != want:
        raise ValueError(
            f"plan wants a {plan.dcn_slices}x{plan.per_slice} hybrid "
            f"mesh; the supplied group has {group.size} rank(s) — launch "
            f"{want} ranks (parallel/group.launch)")
    if want == 1:
        return _Ranks(group.device)
    import torch.distributed as dist

    from gossip_tpu_torch.parallel import group as GR
    if plan.dcn_slices > 1:
        from gossip_tpu_torch.parallel.multislice import make_hybrid_mesh
        mesh = make_hybrid_mesh(plan.dcn_slices, plan.per_slice,
                                device=group.device)
        (row, col), inner = mesh.coords, mesh.inner
    else:
        row, col, inner = 0, group.rank, group
    world = GR.Group(group.rank, group.size, CPU, "gloo",
                     pg=dist.new_group(backend="gloo"))
    coords = tuple(tuple(rc) for rc in world.all_gather(
        torch.tensor([[row, col]], dtype=torch.int64)).tolist())
    # new_group orders its ranks by world rank: slice 0's in column order
    row0 = sorted(r for r, (s, _) in enumerate(coords) if s == 0)
    pg0 = dist.new_group(row0, backend="gloo")
    return _Ranks(group.device, row,
                  inner if plan.per_slice > 1 else None, world,
                  (GR.Group(row0.index(group.rank), len(row0), CPU, "gloo",
                            pg=pg0) if group.rank in row0 else None),
                  coords)


class _Stage:
    """The pipeline's buffers on one card: two pinned staging buffers in
    and two out (a tile's slot is its index on this rank mod 2), the
    copy and fetch streams beside the compute stream.  On the CPU it
    copies in order."""

    def __init__(self, rows: int, bucket: int, dev: torch.device):
        self.rows, self.bucket, self.dev = rows, bucket, dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.copy = torch.cuda.Stream(dev)
            self.fetch = torch.cuda.Stream(dev)
            pin = dict(dtype=torch.int32, pin_memory=True)
            self.inp = [torch.empty((rows, bucket), **pin) for _ in "ab"]
            self.out = [torch.empty((rows, bucket), **pin) for _ in "ab"]
            self.scal = [torch.empty(2, dtype=torch.float32,
                                     pin_memory=True) for _ in "ab"]
            self.cnt = [torch.empty(bucket * WORD_BITS, dtype=torch.int64,
                                    pin_memory=True) for _ in "ab"]
            self.landed = [None, None]

    def put(self, i: int, cols: np.ndarray) -> torch.Tensor:
        """The device tile of host columns ``cols`` (``uint32[rows,
        <= bucket]``), zero-padded to the bucket: on a card a
        non-blocking copy from pinned slot ``i % 2`` on the copy stream,
        which the compute stream waits for."""
        w = cols.shape[1]
        if not self.cuda:
            a = np.zeros((self.rows, self.bucket), np.uint32)
            a[:, :w] = cols
            return torch.from_numpy(a.view(np.int32))
        slot = i % 2
        if self.landed[slot] is not None:
            # the slot's last copy has left it (long since, in order)
            self.landed[slot].synchronize()
        buf = self.inp[slot].numpy().view(np.uint32)
        buf[:, :w] = cols
        buf[:, w:] = 0
        with torch.cuda.stream(self.copy):
            tile = torch.empty((self.rows, self.bucket), dtype=torch.int32,
                               device=self.dev)
            tile.copy_(self.inp[slot], non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.copy)
        self.landed[slot] = landed
        self.compute.wait_event(landed)
        tile.record_stream(self.compute)
        return tile

    def get(self, i: int, rec: dict):
        """On a card: enqueue the copies of a dispatched record's result
        (its words, ``msgs`` and ``dropped``, its bit counts) into pinned
        slot ``i % 2`` behind the compute stream's work, on the fetch
        stream; its event (None on the CPU)."""
        if not self.cuda:
            return None
        slot = i % 2
        self.fetch.wait_stream(self.compute)
        with torch.cuda.stream(self.fetch):
            for dst, key in ((self.out, "seen"), (self.scal, "scal"),
                             (self.cnt, "cnt")):
                dst[slot].copy_(rec[key], non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(self.fetch)
        for key in ("seen", "scal", "cnt"):
            rec[key].record_stream(self.fetch)
        return fetched

    def result(self, rec: dict):
        """``(uint32 words [rows, bucket], msgs, dropped, int64 bit
        counts)`` of a drained record (its event has completed)."""
        if self.cuda:
            slot = rec["slot"]
            words, scal, cnt = (self.out[slot], self.scal[slot],
                                self.cnt[slot])
        else:
            words, scal, cnt = rec["seen"], rec["scal"], rec["cnt"]
        scal = scal.numpy()
        return (words.numpy().view(np.uint32), float(scal[0]),
                float(scal[1]), cnt.numpy().copy())


def _device_key(seed: int, dev: torch.device) -> torch.Tensor:
    """``key(seed)`` on ``dev``, filled in place (no host-to-device copy,
    which would wait for the card)."""
    k = threefry.key(seed)
    if dev.type != "cuda":
        return k
    out = torch.empty(2, dtype=torch.int64, device=dev)
    out[0].fill_(int(k[0]))
    out[1].fill_(int(k[1]))
    return out


def untiled_reference(plan: ScalePlan, group=None, device=None):
    """The in-memory run at full word width W — ONE segment over the
    plan's whole round budget through the SAME tile step the tiles use.
    Returns ``(uint32[n, W], msgs, dropped)``, what the streamed
    trajectory must equal BITWISE; with ``group`` (a node mesh's rank)
    the words are this rank's rows.  Word-plane trajectories are
    placement invariant, so one device is any mesh's reference."""
    _refuse(plan)
    dev = _indexed(group.device if group is not None
                   else resolve_device(device))
    proto = ProtocolConfig(mode=plan.mode, fanout=plan.fanout,
                           rumors=plan.rumors)
    ts, _ = _tile_step(proto, plan.n, plan.fault, plan.origin, group, dev)
    n_pad, nl, lo = (group.rows(plan.n) if group is not None
                     else (plan.n, plan.n, 0))
    words = _init_rows(plan.n, plan.rumors, plan.origin, lo, nl)
    st = SimState(seen=torch.from_numpy(words.view(np.int32)).to(dev),
                  round=0, key=_device_key(plan.seed, dev),
                  msgs=torch.zeros((), dtype=torch.float32, device=dev))
    track = NE.get(plan.fault) is not None
    acc = torch.zeros((), dtype=torch.float32, device=dev) if track else None
    out, acc = _segment(ts.step, st, plan.max_rounds, acc)
    final = out.seen.cpu().numpy().view(np.uint32)[:max(0, min(nl, plan.n
                                                               - lo))]
    return (final, float(out.msgs.cpu()),
            float(acc.cpu()) if track else 0.0)


def _scale_rank(plan: ScalePlan, kw: dict, group):
    """One spawned rank of :func:`run_at_scale`: ``(result, stats)``."""
    return _run_rank(plan, group=group, device=None, **kw)


def _check_world(plan: ScalePlan, device, shared_card: bool) -> None:
    """Refuse, before any rank starts, a mesh larger than the world this
    call can launch (the reference's words, multislice's grid): one rank
    a card under NCCL, one a core sharing a card or on the CPU."""
    from gossip_tpu_torch.parallel.multislice import (RankSlot,
                                                      _hybrid_device_grid)
    dev = resolve_device(device)
    have = (torch.cuda.device_count()
            if dev.type == "cuda" and not shared_card
            else (os.cpu_count() or 1))
    _hybrid_device_grid([RankSlot(i, 0) for i in range(have)],
                        plan.dcn_slices, plan.per_slice)


def run_at_scale(plan: ScalePlan, *, checkpoint_path: Optional[str] = None,
                 resume: bool = False, check_bitwise: bool = False,
                 measure_memory: bool = False, keep_state: bool = False,
                 halt_after_segments: Optional[int] = None,
                 overlap: bool = True, group=None, device=None,
                 shared_card: bool = False,
                 stats: Optional[List[dict]] = None) -> ScaleRunResult:
    """Drive a ScalePlan: T word-plane tiles stream host <-> device
    through each checkpoint segment as a three-stage pipeline, over the
    plan's ranks (module doc has both contracts).

    ``halt_after_segments`` stops after that many segments WITH the
    checkpoint published — the deterministic stand-in for a SIGKILL
    between segments.  ``check_bitwise`` also runs
    :func:`untiled_reference` and compares the final states
    byte-for-byte.  ``measure_memory`` reads the card's peak of
    allocated memory over the first segment's tiles (None on the CPU)
    and holds it against the plan's predicted peak
    (:func:`~gossip_tpu_torch.planner.budget.crosscheck_peak`).
    ``overlap=False`` drains every tile at once (the serial leg).

    Placement: on ``device`` (default CUDA) for a one-device plan; a plan
    of several ranks runs as this rank of ``group`` (the world's group,
    brought up by a launcher), or of the process group that is up, or on
    ranks it spawns itself (NCCL with a card a rank; gloo on the CPU, or
    with ``shared_card`` on one card); its result is rank 0's.
    ``stats`` gets the walls: one ``tile_stream`` record a tile and
    segment, one ``scale_segment`` record a segment (its wall, the
    save's ms and bytes), ``load`` on resume, ``budget_xcheck`` with
    ``measure_memory``, ``untiled`` (its ms) with ``check_bitwise``, and
    ``scale_run`` last."""
    _refuse(plan)
    if resume and not checkpoint_path:
        raise ValueError("resume=True needs checkpoint_path")
    kw = dict(checkpoint_path=checkpoint_path, resume=resume,
              check_bitwise=check_bitwise, measure_memory=measure_memory,
              keep_state=keep_state,
              halt_after_segments=halt_after_segments, overlap=overlap)
    world = max(1, plan.dcn_slices) * plan.per_slice
    if group is None and world > 1:
        import torch.distributed as dist

        from gossip_tpu_torch.parallel import group as GR
        if dist.is_available() and dist.is_initialized():
            group = GR.current(device)
        else:
            _check_world(plan, device, shared_card)
            result, rank_stats = GR.launch(_scale_rank, world, plan, kw,
                                           device=device,
                                           shared_card=shared_card)[0]
            if stats is not None:
                stats.extend(rank_stats)
            return result
    result, rank_stats = _run_rank(plan, group=group, device=device, **kw)
    if stats is not None:
        stats.extend(rank_stats)
    return result


def _run_rank(plan: ScalePlan, *, group, device, checkpoint_path, resume,
              check_bitwise, measure_memory, keep_state,
              halt_after_segments, overlap):
    """This process's share of :func:`run_at_scale`: ``(result on rank
    0, else this rank's, stats)``."""
    from gossip_tpu_torch.utils.checkpoint import (load_meta, load_state,
                                                   save_state)
    stats: List[dict] = []
    rk = _ranks(plan, group, device)
    dev = rk.dev
    n, w_total = plan.n, plan.total_words
    bucket, tiles = plan.bucket_words, plan.tiles
    n_slices = max(1, plan.dcn_slices)
    plan_fp = plan_fingerprint(plan.to_dict())
    fault_fp = _schedule_fingerprint(plan.fault, n, plan.origin)
    proto = ProtocolConfig(mode=plan.mode, fanout=plan.fanout,
                           rumors=plan.rumors)
    track = NE.get(plan.fault) is not None
    _, nl, lo = rk.rows(n)
    real = max(0, min(nl, n - lo))       # this rank's rows below n
    base = _allocated(dev)
    ts, hit = _tile_step(proto, n, plan.fault, plan.origin, rk.step_group,
                         dev)
    if hit:
        base -= ts.resident_bytes       # held since an earlier run
    # the coverage denominator: this rank's rows of the (eventual) alive
    # set; the tiles' bits are counted on the card as they finish
    alive_host = NE.metric_alive(plan.fault, n, plan.origin, CPU)
    alive_dev = None
    if alive_host is not None:
        alive_host = alive_host.numpy()[lo:lo + real]
        pad = np.zeros(nl, bool)
        pad[:real] = alive_host
        alive_dev = _staged(torch.from_numpy(pad), dev).to(
            dev, non_blocking=True)
    counts = {}
    mine = [t for t in range(tiles) if t % n_slices == rk.slice_index]

    base_round, dropped, msgs = 0, 0.0, 0.0
    resumed = False
    if resume:
        meta = load_meta(checkpoint_path)
        extra = meta.get("extra") or {}
        if extra.get("scale_plan") != plan_fp:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written under a "
                f"different scale plan (fingerprint "
                f"{extra.get('scale_plan')!r} != {plan_fp!r}) — "
                "resuming a re-tiled run would make its budget claims "
                "unattributable; regenerate or drop --resume")
        if extra.get("fault_program") != fault_fp:
            raise ValueError(
                f"checkpoint {checkpoint_path} carries fault program "
                f"{extra.get('fault_program')!r}; this plan builds "
                f"{fault_fp!r} — a resumed fault program must be the "
                "one the checkpoint ran (utils/checkpoint crash "
                "contract)")
        t0 = time.perf_counter()
        st = load_state(checkpoint_path, device=CPU)
        full = st.seen.numpy().view(np.uint32)
        host = np.zeros((nl, w_total), np.uint32)
        host[:real] = full[lo:lo + real]
        stats.append({"event": "load",
                      "ms": (time.perf_counter() - t0) * 1e3})
        base_round = int(extra["round"])
        dropped = float(extra.get("dropped", 0.0))
        msgs = float(st.msgs)
        resumed = True
    else:
        host = _init_rows(n, plan.rumors, plan.origin, lo, nl)

    def tile_cols(t):
        c0 = t * bucket
        return c0, min(c0 + bucket, w_total)

    led = telemetry.current()
    if led.active:
        led.event("scale_plan", n=n, tiles=tiles, bucket_words=bucket,
                  total_words=w_total, segments=plan.segment_count,
                  dcn_slices=n_slices, overlap=overlap,
                  predicted_peak_device_bytes=(
                      plan.predicted_peak_device_bytes),
                  plan_fingerprint=plan_fp, resumed=resumed)
    stage = _Stage(nl, bucket, dev)
    key = _device_key(plan.seed, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    measured = None
    segments_run = 0
    halted = False
    wait_total_ms = 0.0        # host stall wall across all segments
    wall_total_ms = 0.0        # segment walls across all segments
    done = base_round
    while done < plan.max_rounds:
        todo = min(plan.segment_every, plan.max_rounds - done)
        seg = {"msgs": None, "dropped": None}
        seg_round = done
        seg_t0 = time.perf_counter()
        gauge = measure_memory and segments_run == 0 and stage.cuda
        if gauge:
            torch.cuda.reset_peak_memory_stats(dev)

        def _dispatch(t, i):
            """Stages 1+2: stage the tile's words onto the card (the
            copy overlaps the previous tile's compute: that tile is NOT
            yet drained) and enqueue the segment, then the result's copy
            behind it.  Returns the in-flight record ``_drain``
            settles."""
            t0 = time.perf_counter()
            c0, c1 = tile_cols(t)
            st = SimState(seen=stage.put(i, host[:, c0:c1]), round=seg_round,
                          key=key, msgs=torch.full((), msgs,
                                                   dtype=torch.float32,
                                                   device=dev))
            t1 = time.perf_counter()
            acc = (torch.full((), dropped, dtype=torch.float32, device=dev)
                   if track else None)
            out, acc = _segment(ts.step, st, todo, acc)
            rec = {"tile": t, "slot": i % 2, "seen": out.seen,
                   "scal": torch.stack([out.msgs, acc if track else zero]),
                   # every bit column's holders among this rank's alive
                   # rows: the coverage's counts, read with the words
                   "cnt": rumor_count_tensor(out.seen, bucket * WORD_BITS,
                                             alive_dev)}
            rec["event"] = stage.get(i, rec)
            t2 = time.perf_counter()
            rec.update(put_ms=(t1 - t0) * 1e3, dispatch_ms=(t2 - t1) * 1e3)
            return rec

        def _drain(rec):
            """Stage 3 — the ONE place the segment loop waits for the
            card: wait for the tile's result, write its columns into
            the host cursor, settle the message accounting, and record
            the tile's walls."""
            nonlocal wait_total_ms
            t = rec["tile"]
            t0 = time.perf_counter()
            if rec["event"] is not None:
                rec["event"].synchronize()
            t1 = time.perf_counter()
            words, tile_msgs, tile_dropped, cnt = stage.result(rec)
            c0, c1 = tile_cols(t)
            host[:, c0:c1] = words[:, :c1 - c0]
            counts[t] = cnt[:(c1 - c0) * WORD_BITS]
            t2 = time.perf_counter()
            if not track:
                tile_dropped = 0.0
            if seg["msgs"] is None:
                seg["msgs"], seg["dropped"] = tile_msgs, tile_dropped
            elif (tile_msgs, tile_dropped) != (seg["msgs"],
                                               seg["dropped"]):
                # every tile replays the SAME content-free message
                # accounting; disagreement means the plane-independence
                # contract broke — refuse before publishing state
                raise AssertionError(
                    f"tile {t} (slice {rk.slice_index}) message "
                    f"accounting ({tile_msgs}, {tile_dropped}) "
                    f"disagrees with tile {mine[0]} ({seg['msgs']}, "
                    f"{seg['dropped']}) — word planes are no longer "
                    "trajectory-independent")
            wait_ms = (t1 - t0) * 1e3
            wait_total_ms += wait_ms
            tile = {"round": seg_round, "tile": t, "slice": rk.slice_index,
                    "put_ms": rec["put_ms"],
                    "dispatch_ms": rec["dispatch_ms"], "wait_ms": wait_ms,
                    "copy_ms": (t2 - t1) * 1e3}
            stats.append({"event": "tile_stream", **tile})
            if led.active:
                led.event("tile_stream", sync=False, **tile)

        pending = None
        for i, t in enumerate(mine):
            rec = _dispatch(t, i)
            prev, pending = pending, rec
            if not overlap:
                pending = None
                _drain(rec)
            elif prev is not None:
                # tile t is now in flight; draining the previous one
                # overlaps its transfer AND compute
                _drain(prev)
        if pending is not None:
            _drain(pending)
        if gauge:
            measured = torch.cuda.max_memory_allocated(dev) - base
        if segments_run == 0 and measure_memory:
            verdict = crosscheck_peak(
                plan.predicted_peak_device_bytes, measured,
                engine=plan.engine, n=plan.n, tiles=plan.tiles,
                plan_fingerprint=plan_fp)
            stats.append({"event": "budget_xcheck", **verdict})
        if rk.world is not None:
            if n_slices > 1:
                _exchange_columns(host, rk, tiles, n_slices, tile_cols)
            seg["msgs"], seg["dropped"] = _slice_accounting(
                rk, seg["msgs"], seg["dropped"])
        seg_wall_ms = (time.perf_counter() - seg_t0) * 1e3
        wall_total_ms += seg_wall_ms
        done += todo
        msgs, dropped = seg["msgs"], seg["dropped"]
        segments_run += 1
        rec = {"event": "scale_segment", "round": done, "tiles": tiles,
               "dropped": dropped, "wall_ms": seg_wall_ms,
               "save_ms": None, "bytes": None}
        if checkpoint_path:
            t0 = time.perf_counter()
            _publish(checkpoint_path, host, rk, n, done, plan.seed, msgs,
                     {"round": done, "dropped": dropped,
                      "scale_plan": plan_fp, "fault_program": fault_fp},
                     save_state)
            rec["save_ms"] = (time.perf_counter() - t0) * 1e3
            rec["bytes"] = os.path.getsize(checkpoint_path)
        stats.append(rec)
        if checkpoint_path and led.active:
            led.event("scale_segment", round=done, tiles=tiles,
                      dropped=dropped, wall_ms=seg_wall_ms)
        if halt_after_segments is not None \
                and segments_run >= halt_after_segments \
                and done < plan.max_rounds:
            halted = True
            break

    if segments_run:
        # the last segment's tiles (every slice's, after the exchange)
        if rk.world is not None and n_slices > 1:
            counts = _exchange_counts(rk, counts, tiles, n_slices,
                                      tile_cols)
        bits = np.concatenate([counts[t] for t in range(tiles)])
        denom = real if alive_host is None else int(alive_host.sum())
    else:
        bits, denom = host_counts(host[:real], alive_host)
    if rk.world is not None:
        bits, denom = _row0_sum(rk, bits, denom)
    cov = 0.0 if denom == 0 else float(bits[:plan.rumors].min() / denom)

    efficiency = None
    if wall_total_ms > 0.0:
        efficiency = max(0.0, min(1.0,
                                  1.0 - wait_total_ms / wall_total_ms))
    bitwise = None
    if check_bitwise and not halted:
        ok = True
        if rk.slice_index == 0:
            t0 = time.perf_counter()
            ref, ref_msgs, ref_dropped = untiled_reference(
                plan, group=rk.step_group, device=dev)
            stats.append({"event": "untiled", "rounds": plan.max_rounds,
                          "ms": (time.perf_counter() - t0) * 1e3})
            ok = (np.array_equal(ref, host[:real])
                  and ref_msgs == msgs and ref_dropped == dropped)
        if rk.world is not None:
            ok = bool(rk.world.all_gather(torch.tensor(
                [int(ok)], dtype=torch.int64)).min())
        bitwise = bool(ok)
    final = None
    if keep_state:
        final = host[:real] if rk.world is None else _row0_state(rk, host, n)
    stats.append({"event": "scale_run", "rounds": done,
                  "wall_ms": wall_total_ms, "wait_ms": wait_total_ms,
                  "measured_loop_bytes": measured})
    if led.active:
        led.event("scale_run", rounds=done, coverage=cov, msgs=msgs,
                  dropped=dropped, tiles=tiles, halted=halted,
                  bitwise_equal=bitwise, dcn_slices=n_slices,
                  overlap=overlap, overlap_efficiency=efficiency,
                  wall_ms=wall_total_ms, wait_ms=wait_total_ms,
                  measured_loop_bytes=measured)
    result = ScaleRunResult(
        n=n, rounds=done, coverage=cov, msgs=msgs, dropped=dropped,
        tiles=tiles, bucket_words=bucket, segments_run=segments_run,
        resumed=resumed, halted=halted, bitwise_equal=bitwise,
        measured_loop_bytes=measured,
        predicted_peak_device_bytes=plan.predicted_peak_device_bytes,
        dcn_slices=n_slices, overlap=overlap,
        overlap_efficiency=efficiency, final_state=final)
    return result, stats


def _words_tensor(host: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host).view(np.int32))


def _exchange_columns(host: np.ndarray, rk: _Ranks, tiles: int,
                      n_slices: int, tile_cols) -> None:
    """Every slice's columns into every slice's cursor: tile ``t``'s
    columns of this rank's rows come from slice ``t % n_slices``'s rank
    in this rank's column."""
    parts = rk.world.all_gather(_words_tensor(host)[None]).numpy()
    col = rk.coords[rk.world.rank][1]
    src = {s: r for r, (s, c) in enumerate(rk.coords) if c == col}
    for t in range(tiles):
        c0, c1 = tile_cols(t)
        host[:, c0:c1] = parts[src[t % n_slices]].view(np.uint32)[:, c0:c1]


def _exchange_counts(rk: _Ranks, counts: dict, tiles: int,
                     n_slices: int, tile_cols) -> dict:
    """Every tile's bit counts of this rank's rows, each from the slice
    that streamed it (the rank of this rank's column)."""
    width = max(c1 - c0 for c0, c1 in map(tile_cols, range(tiles)))
    mine = np.zeros((tiles, width * WORD_BITS), np.int64)
    for t, c in counts.items():
        mine[t, :len(c)] = c
    parts = rk.world.all_gather(torch.from_numpy(mine)[None]).numpy()
    col = rk.coords[rk.world.rank][1]
    src = {s: r for r, (s, c) in enumerate(rk.coords) if c == col}
    out = {}
    for t in range(tiles):
        c0, c1 = tile_cols(t)
        out[t] = parts[src[t % n_slices]][t, :(c1 - c0) * WORD_BITS]
    return out


def _slice_accounting(rk: _Ranks, msgs, dropped):
    """Slice 0's ``(msgs, dropped)`` of the segment on every rank, after
    each slice's accounting is held to it."""
    mine = torch.tensor([[float(msgs is not None), msgs or 0.0,
                          dropped or 0.0]], dtype=torch.float64)
    rows = rk.world.all_gather(mine).tolist()
    ref = next(r for r, (s, _) in enumerate(rk.coords) if s == 0)
    _, m0, d0 = rows[ref]
    for r, (has, m, d) in enumerate(rows):
        s = rk.coords[r][0]
        if has and (m, d) != (m0, d0):
            raise AssertionError(
                f"tile {s} (slice {s}) message accounting ({m}, {d}) "
                f"disagrees with tile 0 ({m0}, {d0}) — word planes are "
                "no longer trajectory-independent")
    return m0, d0


def _row0_sum(rk: _Ranks, counts: np.ndarray, denom: int):
    """The counts and denominator over slice 0's ranks (every slice holds
    the whole state after the exchange)."""
    mine = torch.from_numpy(np.concatenate([counts, [denom]]))[None]
    rows = rk.world.all_gather(mine).numpy()
    total = sum(rows[r] for r, (s, _) in enumerate(rk.coords) if s == 0)
    return total[:-1], int(total[-1])


def _row0_state(rk: _Ranks, host: np.ndarray, n: int):
    """uint32[n, W]: slice 0's rows gathered, on rank 0 of slice 0 (None
    elsewhere)."""
    if rk.row0 is None:
        return None
    full = rk.row0.all_gather(_words_tensor(host)).numpy()
    return full.view(np.uint32)[:n] if rk.row0.rank == 0 else None


def _publish(path: str, host: np.ndarray, rk: _Ranks, n: int, done: int,
             seed: int, msgs: float, extra: dict, save_state) -> None:
    """The segment's checkpoint, the reference's file: ``SimState(seen=
    uint32[n, W], round, key(seed), msgs)`` written atomically (on a mesh
    slice 0's rows gathered, rank 0 writing, every rank waiting)."""
    words = (_words_tensor(host) if rk.world is None
             else (None if rk.row0 is None
                   else rk.row0.all_gather(_words_tensor(host))))
    if words is not None and (rk.row0 is None or rk.row0.rank == 0):
        save_state(path, SimState(seen=words[:n], round=done,
                                  key=threefry.key(seed),
                                  msgs=torch.tensor(np.float32(msgs))),
                   extra_meta=extra)
    if rk.world is not None:
        rk.world.barrier()
