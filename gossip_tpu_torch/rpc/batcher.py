"""Admission batching: coalesce concurrent ``Run`` / ``Ensemble``
requests into one megabatch a tick.

The port of the JAX package's ``rpc/batcher.py``.  Requests enqueue with
their deadline; a collector thread drains the queue every
``ServingConfig.tick_ms`` and runs each group of requests with equal
:class:`BatchKey` as one batch
(:func:`gossip_tpu_torch.parallel.sweep.request_sweep_curves`); a
request the megabatch cannot host falls through to the solo path, its
reply labeled with the reason (:func:`classify_run`, the reference's
words).

Batch key against operand (the reference's table): requests share a
batch when they agree on the n bucket (a power of two on the complete
graph; the exact table otherwise), the fanout (the shared draw width),
the rumor bucket and ``max_rounds``.  Their mode, period, seed, origin,
target, n and rumors within the buckets, drop probability, static
deaths and fault program are per-lane operands.

Each reply equals the request's solo ``simulate_curve`` run (curve, msgs,
rounds, coverage, the final state's digest): the megabatch's contract.

**One device lock.**  A serving process runs solo requests in its
handler threads and megabatches in the collector thread, and every one
of them times its device work between two synchronizes of the device.
:data:`DEVICE_LOCK` serializes that work (on one stream it runs one call
at a time anyway), so no call's timed window holds another's kernels; a
request waiting in the queue does not hold it.  The reference lets its
solo runs and megabatches overlap on its device.

**Request-axis mesh.**  With ``ServingConfig.devices`` K above 1 the
batcher starts a pool of K spawned ranks once
(:class:`~gossip_tpu_torch.parallel.group.Pool`: gloo on the CPU or on
one shared card, NCCL with a card a rank) and runs each tick's megabatch
on it (``request_sweep_curves(group=)``), the serving process staying
outside the group.  The lanes pad to the least multiple of K (the
reference pads to a power of two floored at K to hold one XLA executable
a lane bucket; the port compiles nothing); the padding lanes are inert
and every reply stays its solo run's.  A width the process cannot hold
(more ranks than cards without ``shared_card``) is refused at
construction in the reference's words; a pool that fails fails its
tick's requests, and every later tick's, and nothing falls back to the
single-device path.  :meth:`Batcher.close` stops the ranks.

**Compile verdict.**  The reference counts XLA backend compiles around a
megabatch; the port compiles nothing at serve time, and its verdict is
the count of ``kernel_build`` events (``ops/_kernels.build_events``)
inside the group, the mesh ranks' included: ``warm`` when zero.

Telemetry: one ``batch`` event a group (the reference's fields), and the
``backpressure``, ``deadline_exceeded``, ``batch_error``, ``trace_admit``
and ``request_trace`` events where the reference writes them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from functools import lru_cache
from typing import Optional, Tuple

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import ServingConfig, TopologyConfig

BATCHABLE_MODES = (C.PUSH, C.PULL, C.PUSH_PULL, C.ANTI_ENTROPY)

# Serializes device work in a serving process (module doc).
DEVICE_LOCK = threading.Lock()


class BatchError(Exception):
    """Base class of the serving layer's refusals (the handlers map each
    to its status code)."""


class QueueFull(BatchError):
    """Backpressure: the queue holds ``max_queue`` lanes."""


class TooLarge(BatchError):
    """The request needs more lanes than ``max_batch``: it could never be
    scheduled, so admission refuses it (INVALID_ARGUMENT)."""


class Closed(BatchError):
    """The batcher is shut down: no collector drains the queue any more
    (UNAVAILABLE, a transient the client may retry elsewhere)."""


class Expired(BatchError):
    """The request's deadline passed before its tick ran."""


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """What requests must share to run in one batch (module doc)."""
    n_bucket: int
    rounds: int
    fanout: int
    rumor_bucket: int
    topology: Optional[TopologyConfig]   # None: the implicit complete graph

    def describe(self) -> dict:
        return {"n_bucket": self.n_bucket, "rounds": self.rounds,
                "fanout": self.fanout, "rumor_bucket": self.rumor_bucket,
                "topology": (self.topology.family
                             if self.topology is not None else "complete")}


def deadline_of(context) -> Optional[float]:
    """The request's absolute monotonic deadline from its context (None:
    no client timeout)."""
    rem = context.time_remaining()
    if rem is None:
        return None
    return time.monotonic() + float(rem)


def classify_run(args, device=None):
    """``(key, spec, want_curve)`` for a batchable ``Run`` request, or
    ``(None, reason, None)`` naming the first reason it is not (the
    reference's words; the reason lands in the solo reply's
    ``meta["batch"]``).  ``device``: the serving device, which decides
    whether ``engine='auto'`` takes the fused route."""
    from gossip_tpu_torch.backend import fused_auto_ok
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.parallel.sweep import RequestSpec, _pow2_at_least
    if args["backend"] != "jax-tpu":
        return None, f"backend={args['backend']}", None
    if args.get("log_cfg") is not None:
        return None, "log workload dispatches solo", None
    if args.get("txn_cfg") is not None:
        return None, "txn workload dispatches solo", None
    if args["mesh_cfg"] is not None:
        return None, "mesh requests dispatch solo", None
    run, proto, tc = args["run"], args["proto"], args["tc"]
    if run.engine not in ("auto", "xla"):
        return None, f"engine={run.engine}", None
    if proto.mode not in BATCHABLE_MODES:
        return None, f"mode={proto.mode}", None
    fault = args["fault"]
    if fault is not None and (fault.dead_nodes or fault.fail_round):
        return None, "swim-scripted fault fields", None
    if run.engine == "auto" and fused_auto_ok(proto, tc, fault, device):
        # the solo route is the fused kernel's, another trajectory than
        # the megabatch's threefry draws: batching it would break the
        # solo contract
        return None, "engine=auto routes to the fused engine", None
    try:
        spec = RequestSpec(proto, run, fault, tc.n)
        if fault is not None:
            NE.validate_events(fault, tc.n)
    except ValueError as e:
        return None, str(e).splitlines()[0], None
    if tc.family == C.COMPLETE:
        topo_key, n_bucket = None, _pow2_at_least(tc.n, 2)
    else:
        topo_key, n_bucket = tc, tc.n
    key = BatchKey(n_bucket=n_bucket, rounds=run.max_rounds,
                   fanout=proto.fanout,
                   rumor_bucket=_pow2_at_least(proto.rumors),
                   topology=topo_key)
    return key, spec, bool(args["want_curve"])


def classify_ensemble(args, seeds, count, device=None):
    """``(key, specs)`` for a batchable ``Ensemble`` request, a lane a
    seed, or ``(None, reason)``."""
    run = args["run"]
    if seeds is None:
        seeds = [run.seed + i for i in range(int(count))]
    seeds = [int(s) for s in seeds]
    if not seeds:
        return None, "empty seed list"
    key, first, _ = classify_run({**args, "want_curve": False}, device)
    if key is None:
        return None, first
    return key, tuple(dataclasses.replace(
        first, run=dataclasses.replace(run, seed=s)) for s in seeds)


def refuse_mesh_width(devices: int, device, shared_card: bool) -> None:
    """Refuse a megabatch mesh wider than the process can hold: more
    ranks than cards without ``shared_card`` (the reference's words, with
    its JAX devices the port's CUDA ones and its remedy the port's).  The
    CPU's gloo ranks are processes, so the CPU holds any width."""
    import torch
    if devices <= 1 or torch.device(device).type != "cuda" or shared_card:
        return
    have = torch.cuda.device_count()
    if have < devices:
        raise ValueError(
            f"ServingConfig.devices={devices} but this process has "
            f"only {have} CUDA device(s) — the megabatch mesh would "
            "silently degrade; serve with --share-card (the ranks share "
            "one card under gloo) or on a host with enough cards")


def _mesh_batch(specs, topology, n_pad, lanes, group):
    """One mesh rank's share of a tick's megabatch (runs in the pool's
    ranks): rank 0's result (every rank holds all of it) and this rank's
    ``kernel_build`` events during the batch."""
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.parallel.sweep import request_sweep_curves
    before = _kernels.build_events()
    res = request_sweep_curves(specs, topo=_topo_for(topology, group.device),
                               n_pad=n_pad, group=group, lanes=lanes)
    return (res if group.rank == 0 else None,
            _kernels.build_events() - before)


@lru_cache(maxsize=8)
def _topo_for(tc: Optional[TopologyConfig], device):
    """The shared explicit table of a batch key on ``device`` (None for
    the complete graph), built once a configuration."""
    if tc is None:
        return None
    from gossip_tpu_torch.topology import generators as G
    return G.build(tc, device)


class _Pending:
    """One admitted request waiting for its tick."""

    __slots__ = ("kind", "key", "specs", "want_curve", "deadline",
                 "enq_t", "event", "reply", "error", "trace_id")

    def __init__(self, kind, key, specs, want_curve, deadline,
                 trace_id=None):
        self.kind = kind                  # "run" | "ensemble"
        self.key = key
        self.specs = specs
        self.want_curve = want_curve
        self.deadline = deadline          # absolute monotonic, or None
        self.trace_id = trace_id
        self.enq_t = time.monotonic()
        self.event = threading.Event()
        self.reply = None
        self.error: Optional[BaseException] = None

    def wait(self) -> dict:
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.reply


class Batcher:
    """The admission queue and its collector thread (module doc), on
    ``device`` (default CUDA).  ``close()`` refuses new admissions, then
    answers what is queued; the collector is a daemon thread."""

    def __init__(self, cfg: Optional[ServingConfig] = None, device=None):
        from gossip_tpu_torch.ops.common import resolve_device
        self.cfg = cfg or ServingConfig()
        self.device = resolve_device(device)
        self.devices = self.cfg.devices
        self._pool = self._build_pool()
        self._lock = threading.Lock()
        self._queue = []          # [(BatchKey, _Pending)], FIFO
        self._stop = threading.Event()
        self._tick = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="gossip-admission-batcher",
                                        daemon=True)
        self._thread.start()

    def _build_pool(self):
        """The megabatch's K ranks, or None on the single-device path;
        refused when the process cannot hold them (module doc)."""
        if self.devices <= 1:
            return None
        from gossip_tpu_torch.parallel.group import Pool
        refuse_mesh_width(self.devices, self.device, self.cfg.shared_card)
        return Pool(self.devices, self.device,
                    shared_card=self.cfg.shared_card)

    def pool_pids(self):
        """The mesh ranks' process ids (empty on the single-device
        path)."""
        return [] if self._pool is None else self._pool.pids

    # -- admission --------------------------------------------------------

    def _admit(self, pending: _Pending) -> _Pending:
        from gossip_tpu_torch.utils import telemetry
        if len(pending.specs) > self.cfg.max_batch:
            raise TooLarge(
                f"request needs {len(pending.specs)} megabatch lanes "
                f"but max_batch is {self.cfg.max_batch}; split the "
                "ensemble or raise the server's batch cap")
        with self._lock:
            # the stop flag is read under the queue lock: close() sets it
            # before its last drain, so nothing lands in a queue that no
            # one drains again
            if self._stop.is_set():
                raise Closed("sidecar batcher is shut down")
            depth = sum(len(p.specs) for _, p in self._queue)
            if depth + len(pending.specs) > self.cfg.max_queue:
                telemetry.current().event(
                    "backpressure", sync=False, queue_depth=depth,
                    rejected_lanes=len(pending.specs),
                    max_queue=self.cfg.max_queue,
                    trace_id=pending.trace_id)
                raise QueueFull(
                    f"admission queue full ({depth}/"
                    f"{self.cfg.max_queue} lanes); back off and retry")
            self._queue.append((pending.key, pending))
        if pending.trace_id is not None:
            telemetry.current().event(
                "trace_admit", sync=False, trace_id=pending.trace_id,
                req_kind=pending.kind, lanes=len(pending.specs),
                queue_depth=depth)
        return pending

    def submit_run(self, args, deadline, trace_id=None
                   ) -> Tuple[Optional[_Pending], Optional[str]]:
        """Admit a ``Run`` request: ``(pending, None)`` when it batches
        (the caller waits on ``pending.wait()``), ``(None, reason)`` for
        the solo path.  Raises :class:`QueueFull`, :class:`TooLarge` or
        :class:`Closed`."""
        key, spec, want_curve = classify_run(args, self.device)
        if key is None:
            return None, spec
        return self._admit(_Pending("run", key, (spec,), want_curve,
                                    deadline, trace_id)), None

    def submit_ensemble(self, args, seeds, count, deadline, trace_id=None):
        """:meth:`submit_run` for an ``Ensemble`` request, a lane a
        seed."""
        key, specs = classify_ensemble(args, seeds, count, self.device)
        if key is None:
            return None, specs
        return self._admit(_Pending("ensemble", key, specs, False,
                                    deadline, trace_id)), None

    # -- collector ----------------------------------------------------------

    def close(self):
        """Stop: refuse admissions first, then answer what is queued, then
        stop the mesh ranks."""
        self._stop.set()
        self._thread.join(timeout=10)
        self._drain_once()
        if self._pool is not None:
            self._pool.close()

    def _loop(self):
        tick_s = self.cfg.tick_ms / 1e3
        while not self._stop.wait(tick_s):
            self._drain_once()
        self._drain_once()

    def _drain_once(self):
        from gossip_tpu_torch.utils import telemetry
        with self._lock:
            q, self._queue = self._queue, []
        if not q:
            return
        try:
            depth = sum(len(p.specs) for _, p in q)
            now = time.monotonic()
            groups: dict = {}
            leftovers = []
            for key, p in q:
                if p.deadline is not None and now >= p.deadline:
                    self._expire(p, now)
                    continue
                entries = groups.get(key, [])
                if sum(len(e.specs) for e in entries) + len(p.specs) \
                        > self.cfg.max_batch:
                    leftovers.append((key, p))     # the next tick
                    continue
                groups.setdefault(key, entries).append(p)
            if leftovers:
                with self._lock:
                    # FIFO: deferred requests go ahead of newer ones
                    self._queue = leftovers + self._queue
            for key, entries in groups.items():
                self._run_group(key, entries, depth)
        except BaseException as e:              # noqa: BLE001
            # the collector never dies with waiters attached: this tick's
            # requests fail (INTERNAL), and their re-queued leftovers go
            err = BatchError("collector tick failed: "
                             f"{type(e).__name__}: "
                             + (str(e).splitlines()[0] if str(e) else ""))
            telemetry.current().event("batch_error", sync=False,
                                      error=str(err)[:300])
            failed = {id(p) for _, p in q}
            with self._lock:
                self._queue = [(k2, p2) for k2, p2 in self._queue
                               if id(p2) not in failed]
            for _, p in q:
                if not p.event.is_set():
                    p.error = err
                    p.event.set()

    def _expire(self, p: _Pending, now: float):
        from gossip_tpu_torch.utils import telemetry
        wait_ms = (now - p.enq_t) * 1e3
        telemetry.current().event(
            "deadline_exceeded", sync=False, req_kind=p.kind,
            wait_ms=round(wait_ms, 1), lanes=len(p.specs),
            trace_id=p.trace_id)
        p.error = Expired(
            "deadline expired before the batch tick ran "
            f"(waited {wait_ms:.0f} ms; the client timeout bounds "
            "queue wait + run)")
        p.event.set()

    def _run_group(self, key: BatchKey, entries, queue_depth: int):
        from gossip_tpu_torch.ops import _kernels
        from gossip_tpu_torch.parallel.sweep import request_sweep_curves
        from gossip_tpu_torch.utils import telemetry
        specs = tuple(s for e in entries for s in e.specs)
        n_pad = None if key.topology is not None else key.n_bucket
        with DEVICE_LOCK:
            before = _kernels.build_events()
            t0 = time.monotonic()
            try:
                if self._pool is None:
                    res = request_sweep_curves(
                        specs, topo=_topo_for(key.topology, self.device),
                        n_pad=n_pad, device=self.device)
                    rank_builds = 0
                else:
                    lanes = -(-len(specs) // self.devices) * self.devices
                    ranks = self._pool.run(_mesh_batch, specs,
                                           key.topology, n_pad, lanes)
                    res = ranks[0][0]
                    rank_builds = sum(r[1] for r in ranks)
            except Exception as e:      # classify should have refused it,
                # or the mesh's ranks failed: the tick fails, never solo
                err = BatchError(
                    f"batch execution failed: {type(e).__name__}: "
                    + (str(e).splitlines()[0] if str(e) else ""))
                telemetry.current().event("batch_error", sync=False,
                                          error=str(err)[:300])
                for p in entries:
                    p.error = err
                    p.event.set()
                return
            run_ms = (time.monotonic() - t0) * 1e3
            compiles = _kernels.build_events() - before + rank_builds
        self._tick += 1
        waits = sorted((t0 - e.enq_t) * 1e3 for e in entries)
        cache = "warm" if compiles == 0 else "compiled"
        batch_meta = {
            "batched": True, "tick": self._tick,
            "size": len(specs), "requests": len(entries),
            "run_ms": round(run_ms, 1), "cache": cache,
            "devices": self.devices,
            "semantics": "fixed-scan", **key.describe()}
        telemetry.current().event(
            "batch", sync=False, tick=self._tick,
            queue_depth=queue_depth, batch_size=len(specs),
            requests=len(entries),
            wait_ms_p50=round(telemetry.percentile(waits, 0.50), 1),
            wait_ms_max=round(waits[-1], 1) if waits else 0.0,
            run_ms=round(run_ms, 1), compiles=compiles, cache=cache,
            devices=self.devices,
            trace_ids=[p.trace_id for p in entries
                       if p.trace_id is not None],
            **key.describe())
        off = 0
        for p in entries:
            k = len(p.specs)
            try:
                p.reply = (self._run_reply(p, res, off, batch_meta)
                           if p.kind == "run"
                           else self._ensemble_reply(p, res, off, k,
                                                     batch_meta))
            except Exception as e:
                p.error = BatchError(
                    f"reply assembly failed: {type(e).__name__}: {e}")
            if p.trace_id is not None:
                telemetry.current().event(
                    "request_trace", sync=False, trace_id=p.trace_id,
                    source="replica", req_kind=p.kind, batched=True,
                    tick=self._tick, lanes=k, cache=cache,
                    queue_wait_ms=round((t0 - p.enq_t) * 1e3, 1),
                    batch_run_ms=round(run_ms, 1))
            off += k
            p.event.set()

    # -- replies --------------------------------------------------------------

    def _run_reply(self, p: _Pending, res, i: int, batch_meta: dict) -> dict:
        """The reference's reply: a RunReport-shaped dict whose curve,
        rounds, coverage and msgs are the request's solo ``curve=True``
        run's; ``backend`` names this package on its device."""
        spec = p.specs[0]
        curve = [float(c) for c in res.curves[i]]
        return {
            "backend": f"torch-{self.device.type}", "mode": spec.proto.mode,
            "n": spec.n, "rounds": int(res.rounds_to_target[i]),
            "coverage": curve[-1], "msgs": float(res.msgs[i][-1]),
            "wall_s": round(batch_meta["run_ms"] / 1e3, 4),
            "curve": curve if p.want_curve else None,
            "meta": {"clock": "rounds",
                     "devices": batch_meta["devices"],
                     "msgs_counts": "transmissions",
                     "engine": "xla-request-batch",
                     "state_digest": res.state_digests[i],
                     "dropped_total": float(res.dropped[i].sum()),
                     "batch": dict(batch_meta)}}

    @staticmethod
    def _ensemble_reply(p: _Pending, res, off: int, k: int,
                        batch_meta: dict) -> dict:
        """The ``Ensemble`` reply from this request's lanes: each seed's
        curve is its solo run's, so the summary is ``run_ensemble``'s."""
        from gossip_tpu_torch.parallel.sweep import EnsembleResult
        spec = p.specs[0]
        ens = EnsembleResult(
            curves=res.curves[off:off + k], msgs=res.msgs[off:off + k],
            rounds_to_target=res.rounds_to_target[off:off + k],
            target=spec.run.target_coverage)
        return {"ensemble": ens.summary(), "mode": spec.proto.mode,
                "n": spec.n, "batch": dict(batch_meta)}
