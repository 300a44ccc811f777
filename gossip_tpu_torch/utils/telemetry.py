"""The run ledger: the crash-safe flight recorder the port's surfaces
write through.

The port's copy of the JAX package's ``utils/telemetry.py``, with the
same schema, so either package's reader parses the other's file:

* a :class:`Ledger` is a run-scoped, append-only JSONL file opened once
  a run, whose first line is the **provenance** event
  (:func:`~gossip_tpu_torch.utils.provenance.provenance`: run id, git
  commit, timestamps, argv, the torch and CUDA versions);
* nested **spans** (``with ledger.span("build"): ...``) record monotonic
  walls and, with ``memory=True``, the card's memory counters;
* **counters** and **gauges** record discrete occurrences;
* **crash safety**: every event is one line, flushed and fsynced before
  control returns, so a SIGKILLed or wedged run leaves a parseable
  ledger (at most one torn line a writer, which :func:`load_ledger`
  drops; a new writer newline-heals a shared file's torn tail).

Nothing here runs inside a round loop: spans wrap whole driver calls on
the host, and the per-round counters (:mod:`gossip_tpu_torch.ops.
round_metrics`) stay on the device until the driver returns.

``GOSSIP_TELEMETRY=<path>`` is the ambient switch, the reference's name:
:func:`from_env` opens a ledger there (appending: several runs share one
file, told apart by each line's ``run`` id), or returns the no-op
:class:`NullLedger` when it is unset and no default is given, or empty.
Under spawned ranks only rank 0 writes, into its launcher's file under
the launcher's run id (:func:`handoff`, :func:`adopt`,
:func:`~gossip_tpu_torch.parallel.group.launch`); the other ranks hold a
:class:`PeerLedger`, a NullLedger, so one file holds the run's events
once.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import sys
import threading
import time
import uuid
from typing import IO, Iterator, Optional

from gossip_tpu_torch.utils.provenance import SCHEMA_VERSION, provenance

ENV_VAR = "GOSSIP_TELEMETRY"

__all__ = ["SCHEMA_VERSION", "ENV_VAR", "Ledger", "NullLedger", "PeerLedger",
           "EchoLedger", "current", "activate", "handoff", "adopt",
           "from_env", "artifact_ledger", "device_memory_stats", "percentile",
           "MetricsWindow", "new_trace_id",
           "parse_dryrun_table", "load_ledger", "provenance"]


def _finite(x):
    """Non-finite floats replaced by their reprs ('nan', 'inf', '-inf'),
    recursively: the ledger stays strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def _dumps(obj) -> str:
    """``json.dumps`` that never writes the NaN/Infinity literals;
    ``default=str`` catches numpy and torch scalars."""
    try:
        return json.dumps(obj, default=str, allow_nan=False)
    except ValueError:
        return json.dumps(_finite(obj), default=str, allow_nan=False)


class Ledger:
    """Append-only JSONL flight recorder; one instance a run.

    Every emit is one write, a flush and an fsync, so a SIGKILL at any
    point leaves every earlier event durable and at most the last line
    torn.  Every line carries ``ev`` (the kind), ``ts`` (wall seconds)
    and ``run`` (this run's id).  ``echo`` mirrors each line to stderr;
    ``fsync=False`` keeps flush-only semantics for every event."""

    # a recording ledger: a surface that would pay real work to prepare
    # an emission (the round metrics' host copy) checks this first
    active = True

    def __init__(self, path: str, argv=None, echo: bool = False,
                 fsync: bool = True, run_id: Optional[str] = None):
        self.path = os.path.abspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "a")
        self._echo = echo
        self._fsync = fsync
        self.fsyncs = 0             # fsyncs issued (a timed window reads it)
        self._span_stack: list = []
        self._next_span = 1
        self._counters: dict = {}
        if run_id is not None:
            # a continuation writer (rank 0 of a spawned group): the
            # run's lines under its launcher's run id, no second
            # provenance line
            self.run_id = run_id
            return
        prov = provenance(argv)
        self.run_id = prov["run_id"]
        self._emit("provenance", prov)

    def _emit(self, ev: str, fields: dict, sync: bool = True):
        if self._f is None:
            return
        obj = {"ev": ev, "ts": round(time.time(), 3), "run": self.run_id}
        # a caller's "ev"/"ts"/"run" is prefixed, never overwrites
        fields = dict(fields)
        for k in ("ev", "ts", "run"):
            if k in fields:
                fields[f"x_{k}"] = fields.pop(k)
        obj.update(fields)
        line = _dumps(obj)
        try:
            # the leading newline heals a torn tail a killed sibling
            # writer left in a shared file
            self._f.write("\n" + line + "\n")
            self._f.flush()
            if self._fsync and sync:
                os.fsync(self._f.fileno())
                self.fsyncs += 1
        except OSError as e:
            # the recorder must never be what kills the run (disk full)
            sys.stderr.write(f"telemetry: ledger write failed, "
                             f"disabling recorder: {e}\n")
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            return
        if self._echo:
            sys.stderr.write(line + "\n")

    def event(self, kind: str, sync: bool = True, **fields):
        """A free-form event line.  ``sync=False`` skips the fsync (flush
        only), for emitters inside a caller's timed window."""
        self._emit(kind, fields, sync=sync)

    def counter(self, name: str, inc: int = 1):
        """A monotonic count; the running total rides along."""
        total = self._counters.get(name, 0) + inc
        self._counters[name] = total
        self._emit("counter", {"name": name, "inc": inc, "total": total})

    def gauge(self, name: str, value, sync: bool = True):
        self._emit("gauge", {"name": name, "value": value}, sync=sync)

    @contextlib.contextmanager
    def span(self, name: str, memory: bool = False,
             **attrs) -> Iterator[dict]:
        """A nested wall-clock span: ``span_start`` at once (durable
        before the work begins), ``span_end`` with the wall and ``ok``
        on exit.  The yielded dict's fields land on the end event;
        ``memory=True`` adds the card's memory counters
        (:func:`device_memory_stats`)."""
        span_id = self._next_span
        self._next_span += 1
        parent = self._span_stack[-1] if self._span_stack else None
        self._emit("span_start", {**attrs, "span": span_id,
                                  "parent": parent, "name": name})
        self._span_stack.append(span_id)
        extra: dict = {}
        t0 = time.perf_counter()
        ok = True
        try:
            yield extra
        except BaseException:
            ok = False
            raise
        finally:
            wall_ms = (time.perf_counter() - t0) * 1e3
            self._span_stack.pop()
            if memory:
                mem = device_memory_stats()
                if mem is not None:
                    extra.setdefault("memory", mem)
            self._emit("span_end", {**extra, "span": span_id,
                                    "parent": parent, "name": name,
                                    "wall_ms": round(wall_ms, 3),
                                    "ok": ok})

    def record_runtime(self):
        """One ``runtime`` event: the backend, the card count and the
        first card's name (the reference's keys, from torch)."""
        try:
            import torch
            cuda = torch.cuda.is_available()
            self._emit("runtime", {
                "backend": "cuda" if cuda else "cpu",
                "device_count": torch.cuda.device_count() if cuda else 1,
                "device_kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                "torch_version": torch.__version__})
        except Exception as e:
            self._emit("runtime",
                       {"error": f"{type(e).__name__}: {e}"[:300]})

    def memory_snapshot(self, tag: str = ""):
        mem = device_memory_stats()
        if mem is not None:
            self._emit("memory", {"tag": tag, "devices": mem})

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullLedger:
    """The no-op twin: surfaces call it unconditionally."""

    path = None
    run_id = None
    active = False
    fsyncs = 0

    def event(self, kind, sync=True, **fields):
        pass

    def counter(self, name, inc=1):
        pass

    def gauge(self, name, value, sync=True):
        pass

    @contextlib.contextmanager
    def span(self, name, memory=False, **attrs):
        yield {}

    def record_runtime(self):
        pass

    def memory_snapshot(self, tag=""):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class PeerLedger(NullLedger):
    """A rank other than 0 of a ledgered run: it writes nothing, but it
    builds the same round-metrics stacks as rank 0, whose flush is a
    collective of every rank (:mod:`gossip_tpu_torch.ops.round_metrics`)."""

    peer = True


class EchoLedger(NullLedger):
    """A file-less ledger that still echoes events to stderr: what an
    echo-requesting surface gets under ``GOSSIP_TELEMETRY=""``."""

    active = True

    def event(self, kind, sync=True, **fields):
        obj = {"ev": kind, "ts": round(time.time(), 3)}
        obj.update(fields)
        sys.stderr.write(_dumps(obj) + "\n")

    def counter(self, name, inc=1):
        self.event("counter", name=name, inc=inc)

    def gauge(self, name, value, sync=True):
        self.event("gauge", name=name, value=value)


def device_memory_stats():
    """``[{device, bytes_in_use, peak_bytes_in_use, bytes_limit}]`` of the
    CUDA cards this process has touched, or None (no card, or CUDA not
    initialised: reading it never initialises it).  The reference's
    keys, from ``torch.cuda.memory_stats()``'s
    ``allocated_bytes.all.current`` and ``.peak`` and the card's
    ``total_memory``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        rows = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            rows.append({
                "device": f"cuda:{i}",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                   0)),
                "bytes_limit": int(torch.cuda.get_device_properties(i)
                                   .total_memory)})
        return rows or None
    except Exception:
        return None


# -- the ambient ledger ---------------------------------------------------

_CURRENT: object = NullLedger()


def current():
    """The process's ambient ledger (a NullLedger unless activated)."""
    return _CURRENT


def activate(ledger):
    """Install ``ledger`` as the ambient one; returns the previous (restore
    it in a ``finally`` for scoped use)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ledger
    return prev


def handoff():
    """What a spawned rank needs to continue this process's ledger:
    ``(path, run id, fsync)`` of an open file ledger, ``(None, None,
    False)`` when recording without a file, or None when not recording
    (:func:`adopt`)."""
    led = current()
    if isinstance(led, Ledger) and led._f is not None:
        return led.path, led.run_id, led._fsync
    if getattr(led, "active", False) or getattr(led, "peer", False):
        return None, None, False
    return None


def adopt(handle, rank: int) -> None:
    """In a spawned rank: rank 0 continues the launcher's ledger (same
    file, same run id); every other rank, and rank 0 of a file-less
    ledger, holds a :class:`PeerLedger`."""
    if handle is None:
        return
    path, run_id, fsync = handle
    if rank == 0 and path:
        activate(Ledger(path, fsync=fsync, run_id=run_id))
    else:
        activate(PeerLedger())


def from_env(default_path: Optional[str] = None, argv=None,
             echo: bool = False):
    """A ledger at ``$GOSSIP_TELEMETRY``, else at ``default_path``, else
    the NullLedger.  ``GOSSIP_TELEMETRY=""`` disables the file; an
    ``echo`` caller still gets stderr diagnostics (:class:`EchoLedger`).
    An unwritable path degrades to no recording, with a warning."""
    path = os.environ.get(ENV_VAR)
    if path is None:
        path = default_path
    if not path:
        return EchoLedger() if echo else NullLedger()
    try:
        return Ledger(path, argv=argv, echo=echo)
    except OSError as e:
        sys.stderr.write(f"telemetry: cannot open ledger {path!r} "
                         f"({e}); recording disabled\n")
        return EchoLedger() if echo else NullLedger()


def artifact_ledger(path: str, rewrite: bool = True, fsync: bool = False,
                    argv=None):
    """A provenance-stamped artifact ledger: ``rewrite=True`` truncates an
    existing file first (the artifact is this run's evidence, not an
    append log), and ``fsync`` defaults off.  An unwritable path
    degrades to the NullLedger with a warning."""
    if rewrite:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        except OSError as e:
            sys.stderr.write(f"telemetry: cannot rewrite artifact "
                             f"ledger {path!r} ({e}); recording "
                             "disabled\n")
            return NullLedger()
    try:
        return Ledger(path, argv=argv, fsync=fsync)
    except OSError as e:
        sys.stderr.write(f"telemetry: cannot open artifact ledger "
                         f"{path!r} ({e}); recording disabled\n")
        return NullLedger()


def new_trace_id() -> str:
    """A fresh request correlation id (16 hex characters), minted once a
    logical request by the outermost client and carried in the call's
    metadata through the router and the batcher (the reference's)."""
    return uuid.uuid4().hex[:16]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 1]) of a sequence, 0.0 with
    no samples: the one quantile definition (the reference's)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q={q} outside [0, 1]")
    vals = sorted(values)
    if not vals:
        return 0.0
    # the epsilon guards float artefacts like 0.95*20 -> 19.000000000000004
    rank = math.ceil(q * len(vals) - 1e-9)
    return float(vals[min(len(vals) - 1, max(0, rank - 1))])


class MetricsWindow:
    """A thread-safe rolling window of ``(monotonic ts, latency ms)``
    samples over the trailing ``window_s`` seconds, with named counters;
    :meth:`snapshot` gives rps, the sample count and p50/p95/p99
    (:func:`percentile`).  Host bookkeeping only: no fsync, no device
    transfer."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque()
        self._counters: dict = {}

    def record(self, latency_ms: float, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(latency_ms)))
            self._prune_locked(now)

    def bump(self, name: str, inc: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def _prune_locked(self, now: float):
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            lats = [ms for _, ms in self._samples]
            oldest = self._samples[0][0] if self._samples else now
            counters = dict(self._counters)
        # rps over the span the samples cover, not the nominal window
        if lats:
            span = min(max(now - oldest, 1e-9), self.window_s)
            rps = len(lats) / span
        else:
            rps = 0.0
        return {"window_s": self.window_s, "n": len(lats),
                "rps": round(rps, 3),
                "p50_ms": round(percentile(lats, 0.50), 3),
                "p95_ms": round(percentile(lats, 0.95), 3),
                "p99_ms": round(percentile(lats, 0.99), 3), **counters}


# -- reading --------------------------------------------------------------

def parse_dryrun_table(text: str):
    """The last ``{"dryrun_family_ms": ...}`` JSON object line of
    ``text``, or None."""
    for line in reversed(text.splitlines()):
        if not line.strip():
            continue
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(parsed, dict) and "dryrun_family_ms" in parsed:
            return parsed
    return None


def load_ledger(path: str, run: Optional[str] = None, strict: bool = False,
                trace_id: Optional[str] = None):
    """Parse a ledger into a list of event dicts.  Torn lines are dropped
    (a killed writer tears at most one line); ``strict=True`` raises on a
    torn line that is not the last.  ``run`` filters to one run id
    (``"last"``: the newest provenance line's run), ``trace_id`` to the
    events carrying that ``trace_id``."""
    events = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if strict and i != len(lines) - 1:
                raise ValueError(
                    f"{path}:{i + 1}: corrupt ledger line (not a torn "
                    f"tail): {line[:120]!r}")
            continue
    if run == "last":
        provs = [e for e in events if e.get("ev") == "provenance"]
        run = provs[-1]["run"] if provs else None
    if run is not None:
        events = [e for e in events if e.get("run") == run]
    if trace_id is not None:
        events = [e for e in events if e.get("trace_id") == trace_id]
    return events
