"""The serving sidecar: ``Run``, ``Ensemble``, ``Health`` and ``Metrics``
over JSON bytes.

The port of the JAX package's ``rpc/sidecar.py``, in two halves:

* **Handlers** (:func:`_run`, :func:`_ensemble`, :func:`_health`,
  :func:`_metrics`) take the request's bytes and a context and return
  the reply's bytes.  The context is any object with ``abort(code,
  message)``, ``time_remaining()`` and ``invocation_metadata()``;
  ``code`` is a :class:`StatusCode`, named as gRPC names its codes.
  :class:`LocalContext` is one that needs no transport: its ``abort``
  raises :class:`Aborted`.  The handlers run without ``grpc``.
* **Transport**: :func:`serve` registers the handlers as generic gRPC
  method handlers on ``/gossip.Simulator/<Method>`` (no codegen; any
  language's bytes-in, bytes-out stub calls them) and maps
  :class:`StatusCode` onto ``grpc.StatusCode``; :class:`SidecarClient`
  calls them with the reference's retry policy and trace metadata.  Only
  these import ``grpc``; without it they raise an ``ImportError`` that
  names it, and nothing falls back to another transport.

The wire is the reference's: ``Run`` takes ``{"backend", "proto",
"topology", "run", "fault", "mesh", "log", "txn", "curve"}`` (the config
dataclasses' fields, checked strictly) and returns a RunReport dict;
``Ensemble`` takes the same less ``curve`` and ``mesh``, plus ``seeds``
or ``ensemble`` (a count).  A malformed request is INVALID_ARGUMENT with
a one-line message, never a traceback.  Under batching
(:mod:`gossip_tpu_torch.rpc.batcher`) compatible requests coalesce into
one megabatch a tick; a solo fall-through is labeled with its reason in
``meta["batch"]``.  Solo runs take the batcher's device lock
(:data:`~gossip_tpu_torch.rpc.batcher.DEVICE_LOCK`), so each report's
wall and launch tally are its own call's.

Declared differences: ``Health`` reports this package's device type and
``torch.cuda.device_count()`` where the reference reports its JAX backend
and device count (its ``serving_devices``, the batcher's mesh width, is
the reference's), and ``Metrics``' ``compiles_total`` counts this
process's ``kernel_build`` events (``ops/_kernels.build_events``), not
XLA backend compiles; its ``last_compile`` key (the reference's compile
chokepoint's last record) is absent: nothing here compiles at serve
time.
"""

from __future__ import annotations

import enum
import json
import threading
import time
from typing import Optional

from gossip_tpu_torch.config import ServingConfig

SERVICE = "gossip.Simulator"
METHODS = ("Run", "Ensemble", "Health", "Metrics")

# The one metadata key of the tracing plane (the reference's).
TRACE_KEY = "gossip-trace-id"


# gRPC's status codes, by name (:class:`StatusCode`).
_CODES = ("OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT",
          "DEADLINE_EXCEEDED", "NOT_FOUND", "ALREADY_EXISTS",
          "PERMISSION_DENIED", "RESOURCE_EXHAUSTED", "FAILED_PRECONDITION",
          "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED", "INTERNAL",
          "UNAVAILABLE", "DATA_LOSS", "UNAUTHENTICATED")
# The status codes of the handlers and the router, named as gRPC names them
# (the transport maps each onto ``grpc.StatusCode``; the router passes a
# replica's code on by name).
StatusCode = enum.Enum("StatusCode", {c: c for c in _CODES})


class Aborted(Exception):
    """A handler's refusal through a :class:`LocalContext`."""

    def __init__(self, code: StatusCode, message: str):
        super().__init__(message)
        self.code, self.message = code, message


class LocalContext:
    """A handler context without a transport: ``timeout`` seconds from
    now (None: no deadline), ``metadata`` the invocation metadata, and
    ``abort`` raising :class:`Aborted`."""

    def __init__(self, timeout: Optional[float] = None, metadata=()):
        self._deadline = (None if timeout is None
                          else time.monotonic() + float(timeout))
        self._metadata = tuple(metadata or ())

    def time_remaining(self):
        return (None if self._deadline is None
                else self._deadline - time.monotonic())

    def invocation_metadata(self):
        return self._metadata

    def abort(self, code: StatusCode, message: str):
        raise Aborted(code, message)


def _grpc():
    """The ``grpc`` module, or an ImportError that names it."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the sidecar's transport (serve, route, fleet-status, "
            "SidecarClient) needs the grpc package (grpcio); the "
            "handlers and the batcher run without it") from e
    return grpc


def trace_id_of(context) -> Optional[str]:
    """The request's trace id from its metadata, or None."""
    try:
        md = context.invocation_metadata()
    except Exception:
        return None
    for item in md or ():
        if item[0] == TRACE_KEY:
            return str(item[1])
    return None


def trace_metadata(trace_id: Optional[str]):
    """Outgoing metadata carrying ``trace_id`` (None: none)."""
    if trace_id is None:
        return None
    return ((TRACE_KEY, trace_id),)


# What a malformed or invalid request may raise while it is parsed,
# checked or run: INVALID_ARGUMENT with a one-line message.
_BAD_REQUEST = (ValueError, TypeError, KeyError, AttributeError)


def _one_line(e: BaseException) -> str:
    """The first line of an error, bounded (the client-visible error)."""
    msg = str(e) or type(e).__name__
    return msg.splitlines()[0][:400]


def _parse_obj(request: bytes) -> dict:
    """A UTF-8 JSON object, else ValueError."""
    req = json.loads(request)
    if not isinstance(req, dict):
        raise ValueError("request must be a JSON object, got "
                         f"{type(req).__name__}")
    return req


def _identity(b: bytes) -> bytes:
    return b


def _device_of(batcher, device):
    """The serving device: the batcher's, else ``device`` resolved."""
    from gossip_tpu_torch.ops.common import resolve_device
    return batcher.device if batcher is not None else resolve_device(device)


def _await_batched(pending, context) -> bytes:
    """Wait for the megabatch's reply; Expired -> DEADLINE_EXCEEDED, any
    other batch error -> INTERNAL, one line each."""
    from gossip_tpu_torch.rpc import batcher as B
    try:
        return json.dumps(pending.wait()).encode()
    except B.Expired as e:
        context.abort(StatusCode.DEADLINE_EXCEEDED, _one_line(e))
    except B.BatchError as e:
        context.abort(StatusCode.INTERNAL, _one_line(e))


def _solo_trace(trace_id: Optional[str], req_kind: str, run_ms: float,
                note: Optional[str]):
    """The solo path's replica-side ``request_trace`` (no queue)."""
    if trace_id is None:
        return
    from gossip_tpu_torch.utils import telemetry
    telemetry.current().event(
        "request_trace", sync=False, trace_id=trace_id,
        source="replica", req_kind=req_kind, batched=False,
        solo_reason=note, queue_wait_ms=0.0,
        batch_run_ms=round(run_ms, 1))


def _submit(submit, context, *args, trace_id=None):
    """Admit through the batcher, mapping its refusals to their codes:
    ``(pending, note)``."""
    from gossip_tpu_torch.rpc import batcher as B
    try:
        return submit(*args, B.deadline_of(context), trace_id=trace_id)
    except B.QueueFull as e:
        context.abort(StatusCode.RESOURCE_EXHAUSTED, _one_line(e))
    except B.TooLarge as e:
        context.abort(StatusCode.INVALID_ARGUMENT, _one_line(e))
    except B.Closed as e:
        context.abort(StatusCode.UNAVAILABLE, _one_line(e))


def _run(request: bytes, context, batcher=None, device=None) -> bytes:
    from gossip_tpu_torch.backend import dispatch, request_to_args
    from gossip_tpu_torch.rpc.batcher import DEVICE_LOCK
    trace_id = trace_id_of(context)
    try:
        args = request_to_args(_parse_obj(request))
    except _BAD_REQUEST as e:
        context.abort(StatusCode.INVALID_ARGUMENT, _one_line(e))
    note = None
    if batcher is not None:
        pending, note = _submit(batcher.submit_run, context, args,
                                trace_id=trace_id)
        if pending is not None:
            return _await_batched(pending, context)
    dev = _device_of(batcher, device)
    t0 = time.monotonic()
    try:
        with DEVICE_LOCK:
            report = dispatch(**args, device=dev)
    except (ValueError, TypeError) as e:
        context.abort(StatusCode.INVALID_ARGUMENT, _one_line(e))
    _solo_trace(trace_id, "run", (time.monotonic() - t0) * 1e3, note)
    out = report.to_dict()
    if batcher is not None:
        out["meta"]["batch"] = {"batched": False, "reason": note}
    return json.dumps(out).encode()


def _ensemble(request: bytes, context, batcher=None, device=None) -> bytes:
    """Seed-ensemble statistics in one call: the ``Run`` fields less
    ``curve`` / ``mesh``, plus ``seeds`` or ``ensemble`` (a count); the
    reply is the command line's ``--ensemble`` output.  Under batching
    each seed is one megabatch lane."""
    from gossip_tpu_torch.backend import request_to_args, run_ensemble
    from gossip_tpu_torch.rpc.batcher import DEVICE_LOCK
    trace_id = trace_id_of(context)
    try:
        req = _parse_obj(request)
        seeds = req.pop("seeds", None)
        count = req.pop("ensemble", None)
        # the reference's words
        if (seeds is None) == (count is None):
            raise ValueError("pass exactly one of 'seeds' (list) or "
                             "'ensemble' (count)")
        if seeds is not None:
            seeds = [int(s) for s in seeds]
        if count is not None:
            count = int(count)
        args = request_to_args(req)
        if args["backend"] != "jax-tpu":
            raise ValueError("ensembles need the jax-tpu backend")
        if args.get("log_cfg") is not None:
            raise ValueError("the Ensemble RPC does not run the log "
                             "workload; use Run (one log program per "
                             "call)")
        if args.get("txn_cfg") is not None:
            raise ValueError("the Ensemble RPC does not run the txn "
                             "workload; use Run (one write program "
                             "per call)")
        if args["mesh_cfg"] is not None:
            raise ValueError("the Ensemble RPC is single-process "
                             "single-device; shard seed axes via the "
                             "library API")
        if args["want_curve"]:
            raise ValueError("the Ensemble RPC returns summary "
                             "statistics, not curves; drop 'curve' "
                             "(bands are a CLI --save-curve feature)")
    except _BAD_REQUEST as e:
        context.abort(StatusCode.INVALID_ARGUMENT, _one_line(e))
    note = None
    if batcher is not None:
        pending, note = _submit(batcher.submit_ensemble, context, args,
                                seeds, count, trace_id=trace_id)
        if pending is not None:
            return _await_batched(pending, context)
    t0 = time.monotonic()
    try:
        run_args = {k: v for k, v in args.items()
                    if k not in ("backend", "mesh_cfg", "want_curve",
                                 "log_cfg", "txn_cfg")}
        with DEVICE_LOCK:
            ens, extra = run_ensemble(seeds=seeds, count=count,
                                      device=_device_of(batcher, device),
                                      **run_args)
        out = {"ensemble": ens.summary(), "mode": args["proto"].mode,
               "n": args["tc"].n, **extra}
    except (ValueError, TypeError) as e:
        context.abort(StatusCode.INVALID_ARGUMENT, _one_line(e))
    _solo_trace(trace_id, "ensemble", (time.monotonic() - t0) * 1e3, note)
    if batcher is not None:
        out["batch"] = {"batched": False, "reason": note}
    return json.dumps(out).encode()


def _health(request: bytes, context, batcher=None, device=None) -> bytes:
    import torch
    dev = _device_of(batcher, device)
    return json.dumps({
        "ok": True,
        "backend": dev.type,
        "devices": (torch.cuda.device_count() if dev.type == "cuda"
                    else 1),
        # the megabatch mesh width this replica serves with, which the
        # fleet's devices_per_replica check reads
        "serving_devices": batcher.devices if batcher is not None else 1,
        "service": SERVICE,
    }).encode()


def _metrics(request: bytes, context, batcher=None, window=None,
             state=None, lock=None) -> bytes:
    """The replica's live metrics: the rolling request window, the
    in-flight gauge, the kernel builds (total and since the last poll)
    and the ambient ledger's fsync count.  Reads no device."""
    from gossip_tpu_torch.ops import _kernels
    from gossip_tpu_torch.utils import telemetry
    snap = window.snapshot() if window is not None else {}
    compiles = _kernels.build_events()
    inflight = 0
    delta = None
    if state is not None and lock is not None:
        with lock:
            inflight = state["inflight"]
            delta = compiles - state["last_compiles"]
            state["last_compiles"] = compiles
    return json.dumps({
        "ok": True,
        "service": SERVICE,
        "role": "replica",
        # the megabatch mesh width this replica serves with, which the
        # fleet's devices_per_replica check reads
        "serving_devices": batcher.devices if batcher is not None else 1,
        "inflight": inflight,
        "window": snap,
        "compiles_total": compiles,
        "compiles_delta": delta,
        "ledger_fsyncs": getattr(telemetry.current(), "fsyncs", 0),
    }).encode()


def handlers(batching: Optional[ServingConfig] = None, device=None):
    """``(handlers, batcher, window)``: the four methods as ``fn(request,
    context) -> bytes`` keyed by name, sharing one batcher (None without
    ``batching``) and one metrics window.  ``Run`` and ``Ensemble`` are
    recorded into the window, success or abort."""
    from gossip_tpu_torch.utils import telemetry
    batcher = None
    if batching is not None:
        from gossip_tpu_torch.rpc.batcher import Batcher
        batcher = Batcher(batching, device)
    window = telemetry.MetricsWindow()
    mstate = {"inflight": 0, "last_compiles": 0}
    mlock = threading.Lock()

    def observed(fn):
        def handler(req, ctx):
            t0 = time.perf_counter()
            with mlock:
                mstate["inflight"] += 1
            try:
                return fn(req, ctx, batcher, device)
            finally:
                with mlock:
                    mstate["inflight"] -= 1
                window.record((time.perf_counter() - t0) * 1e3)
        return handler

    return ({"Run": observed(_run), "Ensemble": observed(_ensemble),
             "Health": lambda req, ctx: _health(req, ctx, batcher, device),
             "Metrics": lambda req, ctx: _metrics(req, ctx, batcher, window,
                                                  mstate, mlock)},
            batcher, window)


class _GrpcContext:
    """A gRPC server context seen through the handlers' interface."""

    def __init__(self, ctx, grpc):
        self._ctx, self._grpc = ctx, grpc

    def time_remaining(self):
        return self._ctx.time_remaining()

    def invocation_metadata(self):
        return self._ctx.invocation_metadata()

    def abort(self, code: StatusCode, message: str):
        self._ctx.abort(getattr(self._grpc.StatusCode, code.value),
                        message)


def generic_server(methods, port: int, max_workers: int, host: str):
    """A started gRPC server with ``methods`` (name -> ``fn(request,
    context)``) on :data:`SERVICE`: ``(server, bound port)``."""
    grpc = _grpc()
    from concurrent import futures

    def wrap(fn):
        return grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: fn(req, _GrpcContext(ctx, grpc)),
            request_deserializer=_identity, response_serializer=_identity)

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        SERVICE, {name: wrap(fn) for name, fn in methods.items()}),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0 and port != 0:      # grpc's bind-failure sentinel
        raise OSError(f"could not bind {host}:{port} (port in use?)")
    server.start()
    return server, bound


def serve(port: int = 50051, max_workers: int = 4, host: str = "127.0.0.1",
          batching: Optional[ServingConfig] = None, device=None):
    """Start the sidecar on ``device`` (default CUDA): ``(server,
    bound port)``; ``port=0`` picks a free port.  ``batching`` turns on
    the admission batcher (module doc); ``max_workers`` bounds the
    requests that can wait on a tick at once.
    ``server.gossip_batcher.close()`` drains the batcher."""
    grpc = _grpc()     # noqa: F841 -- refuse before starting a batcher
    methods, batcher, window = handlers(batching, device)
    try:
        server, bound = generic_server(methods, port, max_workers, host)
    except Exception:
        if batcher is not None:
            batcher.close()
        raise
    server.gossip_batcher = batcher
    server.gossip_metrics = window
    return server, bound


class SidecarClient:
    """The typed client over the JSON-bytes wire (the reference's).
    Transient transport failures (UNAVAILABLE; plus DEADLINE_EXCEEDED
    for ``health`` and ``metrics``) are retried with capped, jittered
    exponential backoff, each retry an ``rpc_retry`` event on the
    ambient ledger; ``timeout`` is the whole call's budget across its
    attempts.  A well-formed error reply is raised at once."""

    def __init__(self, address: str, max_attempts: int = 4,
                 backoff_base: float = 0.1, backoff_cap: float = 2.0):
        grpc = _grpc()
        if max_attempts < 1:
            raise ValueError(f"max_attempts={max_attempts} must be >= 1")
        self._grpc = grpc
        self._channel = grpc.insecure_channel(address)
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.transient = frozenset({grpc.StatusCode.UNAVAILABLE})
        for name in METHODS:
            setattr(self, "_" + name.lower(), self._channel.unary_unary(
                f"/{SERVICE}/{name}", request_serializer=_identity,
                response_deserializer=_identity))

    def _call_with_retry(self, call, payload: bytes, timeout, method: str,
                         retryable=None, metadata=None, trace_id=None):
        """One call under the retry contract (class doc): each attempt's
        deadline is the budget left, and a budget spent between attempts
        re-raises the last transport error."""
        import random

        from gossip_tpu_torch.utils import telemetry
        retryable = self.transient if retryable is None else retryable
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        for attempt in range(self.max_attempts):
            attempt_timeout = timeout
            if deadline is not None:
                attempt_timeout = deadline - time.monotonic()
                if attempt > 0 and attempt_timeout <= 0:
                    raise last_error
            try:
                return call(payload, timeout=attempt_timeout,
                            metadata=metadata)
            except self._grpc.RpcError as e:
                last_error = e
                code = e.code() if callable(getattr(e, "code", None)) \
                    else None
                if code not in retryable \
                        or attempt + 1 >= self.max_attempts:
                    raise
                sleep = (min(self.backoff_base * (2 ** attempt),
                             self.backoff_cap) * (0.5 + random.random()))
                if deadline is not None:
                    sleep = min(sleep, max(0.0, deadline - time.monotonic()))
                telemetry.current().event(
                    "rpc_retry", sync=False, method=method,
                    attempt=attempt + 1, code=str(code),
                    sleep_s=round(sleep, 3), trace_id=trace_id)
                time.sleep(sleep)
        raise AssertionError("unreachable: loop returns or raises")

    def _traced(self, call, method: str, timeout, trace_id, request):
        from gossip_tpu_torch.utils import telemetry
        tid = trace_id or telemetry.new_trace_id()
        return json.loads(self._call_with_retry(
            call, json.dumps(request).encode(), timeout, method,
            metadata=trace_metadata(tid), trace_id=tid))

    def run(self, timeout: Optional[float] = 600.0,
            trace_id: Optional[str] = None, **request) -> dict:
        """One simulation; the keyword arguments are the request's JSON
        fields.  Every call carries a trace id (minted here unless
        given)."""
        return self._traced(self._run, "run", timeout, trace_id, request)

    def ensemble(self, timeout: Optional[float] = 600.0,
                 trace_id: Optional[str] = None, **request) -> dict:
        """Seed-ensemble statistics; the ``Run`` fields plus
        ``seeds=[...]`` or ``ensemble=count``."""
        return self._traced(self._ensemble, "ensemble", timeout, trace_id,
                            request)

    def health(self, timeout: float = 10.0) -> dict:
        return json.loads(self._call_with_retry(
            self._health, b"{}", timeout, "health",
            retryable=self.transient
            | {self._grpc.StatusCode.DEADLINE_EXCEEDED}))

    def metrics(self, timeout: float = 10.0) -> dict:
        """The live-metrics snapshot: a replica's own, or a router's for
        its whole fleet."""
        return json.loads(self._call_with_retry(
            self._metrics, b"{}", timeout, "metrics",
            retryable=self.transient
            | {self._grpc.StatusCode.DEADLINE_EXCEEDED}))

    def close(self) -> None:
        self._channel.close()
