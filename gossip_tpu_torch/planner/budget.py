"""The device-memory / host-RAM budget model: "what tiling fits N on
this box?"

The port of the JAX package's ``planner/budget.py`` (which never imports
jax; the port keeps its own copy all the same, and imports neither jax
nor ``gossip_tpu``).  Pure host arithmetic over the engines' memory
layouts: it never touches a device, and the closed forms below are
config-sized, never N-sized.  The forms, the plan document, its JSON and
its fingerprint are the reference's, byte for byte, so a plan file and
a streamed run's checkpoint cross between the two packages.  Two places
differ:

* the defaults are the card's: :class:`DeviceSpec` holds an NVIDIA H100
  80GB HBM3's memory (:data:`H100_HBM_BYTES`, read on the card as
  ``torch.cuda.get_device_properties(0).total_memory``) and the card
  machine's host RAM (:data:`HOST_RAM_BYTES`, its ``MemTotal``), where
  the reference's default is a TPU chip's 16 GiB and a 64 GiB host;
* :func:`crosscheck_peak`'s measured peak is the port's
  ``torch.cuda.max_memory_allocated``.

What the forms count, engine by engine:

* **packed** (models/si_packed, parallel/sharded_packed) — the
  streamed engine.  State is ``uint32[N, W]`` word planes
  (W = ceil(R/32), ops/bitpack layout); the pull round's big
  intermediates are the all-gathered visible table (``n_pad * Wt * 4``
  per device) and the partner gather (``nl * k * Wt * 4``,
  ``pull_merge_packed``'s ``[Nl, k, W]`` pickup).  Because a PULL
  round's partner draws, drop coins, liveness and partition cuts are
  all functions of (key, round, node) — never of plane CONTENT — the
  word-plane axis is embarrassingly parallel: a tile of Wt < W planes
  runs the identical trajectory on its own columns, which is what the
  streamed executor (planner/stream.py) exploits and what these forms
  budget.  The port's tile step draws its rows in node chunks
  (planner/stream.DRAW_CHUNKS) so that its threefry draw's transient
  tensors fit the forms' partner terms.
* **dense** (models/si, parallel/sharded) — bool rows, 8x the packed
  bytes per rumor plus the push scatter's count table; modeled for the
  refusal message (at 100M nodes dense is the binding constraint
  almost immediately), not for streaming.
* **fused** (ops/fused_mr_round, parallel/sharded_fused) — the
  ``[W, rows, 128]`` plane stack, one int32 lane word per node per
  plane; planes already shard rumor-wise, so its natural scale axis is
  more devices, not host streaming.

The plan a feasible target lowers to is a :class:`ScalePlan`:
pow2-bucketed word-tile width (one tile step serves every tile — tile
content is operands), checkpoint segment schedule (utils/checkpoint
cursor discipline, so a streamed run is crash-safe), and the mesh
shape — single-slice, or the ``parallel/multislice.make_hybrid_mesh``
hybrid where the node axis stays inside a slice and the
(communication-free) tile stream divides across slices.  An infeasible
target raises :class:`InfeasiblePlanError` NAMING the binding
constraint — a refusal that cannot say which wall it hit is not a
capacity model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import FaultConfig

PLAN_VERSION = 1

WORD_BITS = 32
WORD_BYTES = 4

# Engines the model has closed forms for.  Only "packed" is executable
# by the streamed driver (planner/stream.py) — the others exist so the
# planner can NAME why they do not reach the target N.
ENGINES = ("packed", "dense", "fused")

# Fraction of device memory the plan never touches: the CUDA context,
# the allocator's cached blocks, fragmentation headroom.  Deliberately
# conservative; overridable per plan_scale call.
DEFAULT_RESERVE_FRAC = 0.08

# Pessimism multiplier on the checkpoint's host footprint: the live
# numpy state plus the npz tmp-write buffer (save_state writes
# ``path + ".tmp"`` then os.replace — both exist at the publish
# instant).
HOST_CKPT_COPIES = 2

# Default checkpoint segment length (rounds) — the utils/checkpoint
# ``every`` default.
DEFAULT_SEGMENT_EVERY = 50

# Minimum canonical schedule-table length — MUST equal
# ops/nemesis.SCHED_T_MIN (pinned by tests/test_torch_planner.py;
# duplicated here so this module stays pure arithmetic).
SCHED_T_MIN = 32

# The defaults of a DeviceSpec: one NVIDIA H100 80GB HBM3's memory,
# torch.cuda.get_device_properties(0).total_memory on the card, and its
# machine's host RAM, MemTotal of /proc/meminfo there (PERF.md section
# 3 has the card's name and power limit beside them).
H100_HBM_BYTES = 85_017_493_504
HOST_RAM_BYTES = 108_447_924_224


class InfeasiblePlanError(ValueError):
    """Target N does not fit the device topology.  ``binding`` names
    the constraint that refused it; ``bytes_needed``/``bytes_budget``
    quantify the wall."""

    def __init__(self, msg: str, *, binding: str, bytes_needed: int,
                 bytes_budget: int):
        super().__init__(msg)
        self.binding = binding
        self.bytes_needed = bytes_needed
        self.bytes_budget = bytes_budget


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def n_words(rumors: int) -> int:
    """ceil(R/32) — ops/bitpack.n_words, duplicated here (pinned equal
    in tests/test_torch_planner.py)."""
    return (rumors + WORD_BITS - 1) // WORD_BITS


def sched_t_pad(fault: Optional[FaultConfig]) -> int:
    """Canonical schedule-table length for a fault program — the
    arithmetic twin of ops/nemesis.canonical_horizon (pinned equal in
    tests/test_torch_planner.py so the two cannot drift)."""
    if fault is None or fault.churn is None:
        return SCHED_T_MIN
    return max(SCHED_T_MIN, _pow2_at_least(fault.churn.horizon()))


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """The device topology a plan targets.  ``slices`` > 1 selects the
    hybrid DCN mesh (parallel/multislice): ``chips`` is the TOTAL chip
    count, ``chips // slices`` the ICI-connected inner axis.  The
    defaults are one H100's memory and its machine's host RAM (module
    doc)."""

    chips: int = 1
    hbm_bytes_per_chip: int = H100_HBM_BYTES
    slices: int = 1
    host_ram_bytes: int = HOST_RAM_BYTES

    def __post_init__(self):
        if self.chips < 1:
            raise ValueError(f"chips must be >= 1, got {self.chips}")
        if self.slices < 1:
            raise ValueError(f"slices must be >= 1, got {self.slices}")
        if self.chips % self.slices:
            raise ValueError(
                f"chips={self.chips} does not divide into "
                f"slices={self.slices} (the hybrid mesh needs equal "
                "ICI rows — parallel/multislice.make_hybrid_mesh)")
        if self.hbm_bytes_per_chip <= 0 or self.host_ram_bytes <= 0:
            raise ValueError("byte capacities must be positive")

    @property
    def per_slice(self) -> int:
        return self.chips // self.slices


def engine_components(engine: str, *, n: int, rumors: int, fanout: int,
                      tile_words: int, devices: int,
                      fault: Optional[FaultConfig],
                      max_rounds: int) -> dict:
    """Per-DEVICE byte components of one compiled round program at word
    -tile width ``tile_words`` — the closed forms the plan sums into
    its predicted peak.  Keys are stable (docs/SCALING.md glossary);
    values are bytes.  ``devices`` is the node-axis shard count (the
    ICI inner axis — DCN slices divide the tile STREAM, i.e. wall
    clock, never per-device bytes)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")
    w_total = n_words(rumors)
    wt = min(tile_words, w_total)
    n_pad = math.ceil(n / devices) * devices
    nl = n_pad // devices
    k = fanout
    t_pad = sched_t_pad(fault)
    churn = fault is not None and fault.churn is not None

    # schedule operands (ops/nemesis.sched_args): die/rec int32[n_pad]
    # + cut/drop [t_pad] — replicated on every device
    sched = (2 * n_pad + 2 * t_pad) * 4 if churn else 0
    # the metrics stack (ops/round_metrics) rides the loop carry only
    # under an active ledger: max_rounds rows of ~12 f32 channels
    metrics = max_rounds * 12 * 4

    if engine == "packed":
        state = nl * wt * WORD_BYTES
        comps = {
            # the resident tile + the masked `visible` copy
            "state_tile": state,
            "visible_copy": state,
            # all_gather of the visible table — the ONE collective
            # (parallel/sharded_packed module doc); on one device this
            # is the full table itself
            "exchange_gather": n_pad * wt * WORD_BYTES,
            # pull_merge_packed's [Nl, k, Wt] partner pickup
            "partner_gather": nl * k * wt * WORD_BYTES,
            # partners0/partners/valid int32 lanes + ids
            "partner_lanes": (3 * nl * k + nl) * 4,
            # the OR-accumulated `pulled` tile + the output state
            "merge_out": 2 * state,
            # the NEXT tile's device_put landing while this one
            # computes (planner/stream double buffering)
            "double_buffer": state,
            # the PREVIOUS tile's result, still resident while its D2H
            # fetch drains behind this tile's compute — the third
            # pipeline stage (planner/stream _drain); same tile shape,
            # output dtype == state dtype
            "fetch_buffer": state,
            "sched_operands": sched,
            "metrics_stack": metrics,
        }
    elif engine == "dense":
        state = nl * rumors  # bool rows
        comps = {
            "state_rows": state,
            "visible_copy": state,
            "exchange_gather": n_pad * rumors,
            "partner_gather": nl * k * rumors,
            "partner_lanes": (3 * nl * k + nl) * 4,
            # push half: the psum_scatter'd int32 count table
            # (ops/propagate.push_counts)
            "push_counts": n_pad * rumors * 4,
            "merge_out": 2 * state,
            "sched_operands": sched,
            "metrics_stack": metrics,
        }
    else:  # fused plane stack: [planes, rows, 128] int32 lane words
        rows = math.ceil(n / 128)
        planes = math.ceil(rumors / devices) if devices > 1 else rumors
        comps = {
            "plane_stack": planes * rows * 128 * 4,
            # the port's own term (ROADMAP queue 3): its loops keep every
            # local plane in two lane-major ping-pong buffers
            # (ops/fused_mr_round, parallel/sharded_fused), so a second
            # stack's bytes live beside the first
            "lane_major_pingpong": planes * rows * 128 * 4,
            "alive_words": rows * 128 // 8 * 4,
            "cut_words": rows * 128 // 8 * 4,
            "sched_operands": (2 * t_pad) * 4 if churn else 0,
            "metrics_stack": metrics,
        }
    # the allocator rounds every buffer to its block size and keeps
    # small scalars (round/key/msgs/counters) beside the big arrays —
    # ~1.6% headroom plus a 4 KB floor covers both (the streamed run
    # gates measured <= predicted against max_memory_allocated, so this
    # term cannot silently rot)
    comps["alignment_pad"] = max(4096, sum(comps.values()) // 64)
    return comps


def host_components(*, n: int, rumors: int) -> dict:
    """Host-RAM byte components of a streamed run: the FULL packed
    state lives in numpy on the host (that is the whole point of
    streaming), and every checkpoint publish momentarily holds the npz
    tmp buffer beside it (utils/checkpoint.save_state's atomic-write
    choreography)."""
    w = n_words(rumors)
    full = n * w * WORD_BYTES
    return {
        "host_state": full,
        "checkpoint_buffers": (HOST_CKPT_COPIES - 1) * full,
    }


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    """A validated, executable capacity plan.  ``to_dict`` round-trips
    through JSON (``from_dict`` re-validates); planner/stream.py
    executes it; the CLI prints it."""

    n: int
    rumors: int
    engine: str
    mode: str
    fanout: int
    max_rounds: int
    seed: int
    origin: int
    fault: Optional[FaultConfig]
    device: DeviceSpec
    # mesh: the node axis (O(N) collectives) stays on ICI inside one
    # slice; DCN slices divide the tile stream (zero cross-slice bytes
    # — tiles are independent trajectories)
    mesh_kind: str                 # "single" | "hybrid"
    dcn_slices: int
    per_slice: int
    # tiling
    total_words: int
    tiles: int
    bucket_words: int              # pow2 — the ONE compiled tile shape
    # checkpoint segments
    segment_every: int
    segment_count: int
    # budget verdict
    reserve_frac: float
    hbm_budget_bytes: int
    predicted_peak_device_bytes: int
    predicted_host_peak_bytes: int
    components: tuple              # ((name, bytes), ...) sorted desc
    binding: str                   # largest component (the headroom edge)

    def to_dict(self) -> dict:
        d = {
            "version": PLAN_VERSION,
            "target": {
                "n": self.n, "rumors": self.rumors, "mode": self.mode,
                "fanout": self.fanout, "max_rounds": self.max_rounds,
                "seed": self.seed, "origin": self.origin,
                "topology": "complete",
            },
            "engine": self.engine,
            "fault": (None if self.fault is None
                      else dataclasses.asdict(self.fault)),
            "device": dataclasses.asdict(self.device),
            "mesh": {"kind": self.mesh_kind,
                     "dcn_slices": self.dcn_slices,
                     "per_slice": self.per_slice,
                     "axes": ["sweep", "nodes"]},
            "tiling": {"total_words": self.total_words,
                       "tiles": self.tiles,
                       "bucket_words": self.bucket_words},
            "segments": {"every": self.segment_every,
                         "count": self.segment_count},
            "budget": {"reserve_frac": self.reserve_frac,
                       "hbm_budget_bytes": self.hbm_budget_bytes,
                       "predicted_peak_device_bytes":
                           self.predicted_peak_device_bytes,
                       "predicted_host_peak_bytes":
                           self.predicted_host_peak_bytes,
                       "components": {k: v for k, v in self.components},
                       "binding": self.binding},
        }
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _fault_from_dict(d: Optional[dict]) -> Optional[FaultConfig]:
    if d is None:
        return None
    d = dict(d)
    churn = d.get("churn")
    if isinstance(churn, dict):
        # JSON lists -> the tuple-of-tuples ChurnConfig expects
        churn = {k: (tuple(tuple(x) if isinstance(x, list) else x
                           for x in v)
                     if isinstance(v, list) else v)
                 for k, v in churn.items()}
        d["churn"] = churn
    return FaultConfig(**d)


def plan_from_dict(doc: dict) -> ScalePlan:
    """Rebuild (and re-validate) a ScalePlan from its JSON dict —
    the ONE loader the CLI and the streamed executor share.  Every
    malformation is a ``ValueError`` naming the field (the CLI's
    one-line-refusal contract): a KeyError/TypeError from a truncated
    or foreign dict must never escape as a traceback."""
    validate_plan(doc)
    t = doc["target"]
    try:
        fault = _fault_from_dict(doc.get("fault"))
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"plan fault section is malformed: "
                         f"{type(e).__name__}: {e}") from e
    try:
        device = DeviceSpec(**doc["device"])
    except (TypeError, ValueError) as e:
        raise ValueError(f"plan device section is malformed: "
                         f"{type(e).__name__}: {e}") from e
    # re-derive rather than trust: a hand-edited plan must still be
    # internally consistent with the model
    plan = plan_scale(
        t["n"], rumors=t["rumors"], device=device,
        engine=doc["engine"], mode=t["mode"], fanout=t["fanout"],
        max_rounds=t["max_rounds"], seed=t["seed"],
        origin=t["origin"], fault=fault,
        segment_every=doc["segments"]["every"],
        reserve_frac=doc["budget"]["reserve_frac"])
    got, want = plan.to_dict(), doc
    for key in ("tiling", "mesh", "segments"):
        if got[key] != want[key]:
            raise ValueError(
                f"plan file's {key} section {want[key]} disagrees with "
                f"the model's derivation {got[key]} — stale or "
                "hand-edited plan; regenerate with `gossip_tpu plan`")
    return plan


_REQUIRED_SECTIONS = ("target", "engine", "device", "mesh", "tiling",
                      "segments", "budget")
_REQUIRED_TARGET = ("n", "rumors", "mode", "fanout", "max_rounds",
                    "seed", "origin")


def validate_plan(doc: dict) -> None:
    """Structural validation of a plan dict; ``ValueError`` NAMES the
    offending field (the CLI prints it one-line — a wrong-TYPED
    section must refuse the same way, never escape as a
    TypeError/AttributeError traceback)."""
    if not isinstance(doc, dict):
        raise ValueError(f"plan must be a JSON object, got "
                         f"{type(doc).__name__}")
    if doc.get("version") != PLAN_VERSION:
        raise ValueError(f"plan version {doc.get('version')!r} != "
                         f"{PLAN_VERSION} (regenerate with "
                         "`gossip_tpu plan`)")
    for sec in _REQUIRED_SECTIONS:
        if sec not in doc:
            raise ValueError(f"plan is missing the {sec!r} section")
        if sec != "engine" and not isinstance(doc[sec], dict):
            raise ValueError(
                f"plan {sec!r} section must be an object, got "
                f"{type(doc[sec]).__name__}")
    for key in _REQUIRED_TARGET:
        if key not in doc["target"]:
            raise ValueError(f"plan target is missing {key!r}")
    tiling = doc["tiling"]
    for key in ("total_words", "tiles", "bucket_words"):
        if not isinstance(tiling.get(key), int) or tiling[key] < 1:
            raise ValueError(f"plan tiling.{key} must be a positive "
                             f"int, got {tiling.get(key)!r}")
    if tiling["tiles"] * tiling["bucket_words"] < tiling["total_words"]:
        raise ValueError(
            f"plan tiling covers {tiling['tiles']}*"
            f"{tiling['bucket_words']} words < total_words="
            f"{tiling['total_words']}")
    bw = tiling["bucket_words"]
    if bw & (bw - 1):
        raise ValueError(f"plan tiling.bucket_words={bw} is not a "
                         "power of two (the one-executable-per-bucket "
                         "contract)")
    seg = doc["segments"]
    if not isinstance(seg.get("every"), int) or seg["every"] < 1:
        raise ValueError("plan segments.every must be a positive int")
    if "reserve_frac" not in doc["budget"]:
        raise ValueError("plan budget section is missing "
                         "'reserve_frac'")


def plan_fingerprint(doc: dict) -> str:
    """sha256 of the canonical plan JSON — stamped into streamed-run
    checkpoints (extra['scale_plan']) so --resume refuses a checkpoint
    written under a DIFFERENT plan (the utils/checkpoint fingerprint
    discipline: a silently re-tiled resume would still be bitwise, but
    its budget claims would be unattributable)."""
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


def crosscheck_peak(predicted_bytes, measured_bytes, *,
                    engine: str = "packed", n=None, tiles=None,
                    plan_fingerprint=None,
                    source: str = "torch.cuda.max_memory_allocated") -> dict:
    """The measured<=predicted drift gate, as ONE reusable cross-check:
    the port's measured peak (``torch.cuda.max_memory_allocated`` over
    one segment's tiles, planner/stream) against this module's closed
    forms.  Returns the reference's verdict dict and writes it as one
    ``budget_xcheck`` event to the ambient run ledger.

    ``measured_bytes=None`` (the CPU, which reports no device peak)
    records explicit nulls with ``ok=None`` — the verdict is never
    fabricated; gating callers decide what a null means.  A real pair
    with measured > predicted is ``ok=False``: the closed form drifted
    below reality and every capacity plan built on it is a lie."""
    ok = None
    headroom = None
    predicted = int(predicted_bytes) if predicted_bytes is not None \
        else None
    measured = int(measured_bytes) if measured_bytes is not None \
        else None
    if measured is not None and predicted:
        ok = bool(measured <= predicted)
        headroom = round(1.0 - measured / predicted, 4)
    verdict = {"engine": engine, "n": n, "tiles": tiles,
               "predicted_bytes": predicted,
               "measured_bytes": measured, "ok": ok,
               "headroom_frac": headroom, "source": source,
               "plan_fingerprint": plan_fingerprint}
    # unsynced: the streamed driver calls this inside its first segment
    from gossip_tpu_torch.utils import telemetry
    telemetry.current().event("budget_xcheck", sync=False, **verdict)
    return verdict


def forced_device_for_tiles(n: int, *, rumors: int, fanout: int,
                            max_rounds: int,
                            fault: Optional[FaultConfig],
                            tiles_at_least: int, devices: int = 1,
                            host_ram_bytes: int = HOST_RAM_BYTES
                            ) -> DeviceSpec:
    """A DeviceSpec whose artificial HBM budget FORCES >=
    ``tiles_at_least`` streamed tiles for this target — the ONE
    forced-budget construction (chip_smoke.py's scale phase and the test
    suite build theirs here, so the load-bearing reserve-frac inversion +
    headroom margin cannot drift between the gates).  The budget is sized just above
    the peak of a candidate tile width and then VERIFIED by planning
    against it — at degenerate shapes (tiny n, wide fixed terms) a
    wider bucket can still fit a budget sized for a narrower one, so
    the candidate shrinks until the plan really streams >=
    ``tiles_at_least`` tiles; impossible requests (more tiles than
    word planes) are refused loudly."""
    w = n_words(rumors)
    if tiles_at_least > w:
        raise ValueError(
            f"cannot force {tiles_at_least} tiles over {w} word "
            f"plane(s) (rumors={rumors}); tiles are word-granular")
    for wt in range(max(1, w // tiles_at_least), 0, -1):
        peak = sum(engine_components(
            "packed", n=n, rumors=rumors, fanout=fanout,
            tile_words=wt, devices=devices, fault=fault,
            max_rounds=max_rounds).values())
        dev = DeviceSpec(
            chips=devices,
            hbm_bytes_per_chip=int(peak / (1 - DEFAULT_RESERVE_FRAC))
            + 4096,
            host_ram_bytes=host_ram_bytes)
        plan = plan_scale(n, rumors=rumors, device=dev,
                          fanout=fanout, max_rounds=max_rounds,
                          fault=fault)
        if plan.tiles >= tiles_at_least:
            return dev
    raise ValueError(
        f"cannot force {tiles_at_least} tiles for n={n}, "
        f"rumors={rumors} on {devices} device(s): fixed-size "
        "components dominate even the 1-word tile budget")


def plan_scale(n: int, *, rumors: int = 1,
               device: DeviceSpec = DeviceSpec(),
               engine: str = "packed", mode: str = C.PULL,
               fanout: int = 1, max_rounds: int = 64, seed: int = 0,
               origin: int = 0, fault: Optional[FaultConfig] = None,
               segment_every: Optional[int] = None,
               reserve_frac: float = DEFAULT_RESERVE_FRAC) -> ScalePlan:
    """Pick the word-tile width / segment schedule / mesh shape that
    fits ``n`` on ``device``, or refuse with the binding constraint
    named (:class:`InfeasiblePlanError`).

    The search is over pow2 tile-width buckets, widest first: the
    fewest tiles whose per-device peak fits the reserved HBM budget
    wins (fewer tiles = fewer host<->device round trips per segment).
    All tiles share ONE bucket (padded trailing planes are zero words,
    inert under the OR-merge), so the streamed executor compiles
    exactly one loop per plan."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n > 2**31 - 1:
        raise InfeasiblePlanError(
            f"n={n} exceeds the int32 node-id space (2^31-1) every "
            "round kernel indexes with — the binding constraint is "
            "node_id_dtype, not memory",
            binding="node_id_dtype", bytes_needed=n,
            bytes_budget=2**31 - 1)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")
    if engine == "packed" and mode != C.PULL:
        raise ValueError(
            f"scale plans stream the packed PULL engine; mode {mode!r} "
            "is not tileable along word planes (anti-entropy's reverse "
            "delta and the push scatter write CROSS-tile state — "
            "models/si_packed module doc)")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if rumors < 1:
        raise ValueError(f"rumors must be >= 1, got {rumors}")
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    if not 0.0 <= reserve_frac < 1.0:
        raise ValueError(f"reserve_frac={reserve_frac} outside [0, 1)")

    w_total = n_words(rumors)
    budget = int(device.hbm_bytes_per_chip * (1.0 - reserve_frac))
    devices = device.per_slice   # node axis shards ICI-only

    def peak(wt: int):
        comps = engine_components(
            engine, n=n, rumors=rumors, fanout=fanout, tile_words=wt,
            devices=devices, fault=fault, max_rounds=max_rounds)
        return sum(comps.values()), comps

    # host side first: streaming cannot help a host that cannot hold
    # the full packed state + the checkpoint publish buffer
    hcomps = host_components(n=n, rumors=rumors)
    host_peak = sum(hcomps.values())
    if host_peak > device.host_ram_bytes:
        biggest = max(hcomps, key=hcomps.get)
        raise InfeasiblePlanError(
            f"infeasible: host RAM is the binding constraint "
            f"({biggest}: the streamed run needs {host_peak:,} host "
            f"bytes — full packed state {hcomps['host_state']:,} plus "
            f"checkpoint publish buffers — against "
            f"{device.host_ram_bytes:,} available); a bigger host or "
            "fewer rumor planes, not more HBM, moves this wall",
            binding=biggest, bytes_needed=host_peak,
            bytes_budget=device.host_ram_bytes)

    # widest pow2 bucket that fits -> fewest tiles
    bucket = _pow2_at_least(w_total)
    chosen = None
    while bucket >= 1:
        p, comps = peak(bucket)
        if p <= budget:
            chosen = (bucket, p, comps)
            break
        bucket //= 2
    if chosen is None:
        _, comps = peak(1)
        biggest = max(comps, key=comps.get)
        need = sum(comps.values())
        raise InfeasiblePlanError(
            f"infeasible: n={n:,} does not fit "
            f"{devices} chip(s) x {device.hbm_bytes_per_chip:,} HBM "
            f"bytes even at the minimum 1-word tile — the binding "
            f"constraint is {biggest} ({comps[biggest]:,} bytes of the "
            f"{need:,}-byte peak against the {budget:,}-byte reserved "
            f"budget); it scales with N/devices, so more ICI chips "
            "per slice (or a smaller N) move it, narrower tiles "
            "cannot",
            binding=biggest, bytes_needed=need, bytes_budget=budget)

    bucket_words, predicted, comps = chosen
    tiles = math.ceil(w_total / bucket_words)
    every = (DEFAULT_SEGMENT_EVERY if segment_every is None
             else int(segment_every))
    if every < 1:
        raise ValueError(f"segment_every must be >= 1, got {every}")
    every = min(every, max_rounds)
    ordered = tuple(sorted(comps.items(), key=lambda kv: -kv[1]))
    return ScalePlan(
        n=n, rumors=rumors, engine=engine, mode=mode, fanout=fanout,
        max_rounds=max_rounds, seed=seed, origin=origin, fault=fault,
        device=device,
        mesh_kind="hybrid" if device.slices > 1 else "single",
        dcn_slices=device.slices, per_slice=device.per_slice,
        total_words=w_total, tiles=tiles, bucket_words=bucket_words,
        segment_every=every,
        segment_count=math.ceil(max_rounds / every),
        reserve_frac=reserve_frac, hbm_budget_bytes=budget,
        predicted_peak_device_bytes=predicted,
        predicted_host_peak_bytes=host_peak,
        components=ordered, binding=ordered[0][0])
