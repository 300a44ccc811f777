"""Profiling hooks: the port's counterpart of the JAX package's
``utils/trace.py``, on ``torch.profiler``.

* :func:`trace` captures the enclosed block with ``torch.profiler`` (CPU
  and, on a card, CUDA activity) and writes a Chrome trace into a
  directory (``chrome://tracing`` and Perfetto read it).  A capture made
  on a card that recorded no CUDA activity raises instead of writing a
  trace with its device side missing.
* :func:`annotate` names a region of the timeline
  (``torch.profiler.record_function``, and an NVTX range on a card).
* :func:`profile` is the ``GOSSIP_PROFILE`` hook: a capture into that
  directory when it is set, a plain block otherwise.
* :class:`RoundTimer` times stepwise loops round by round.

The driver's own chokepoint (timed walls, the ``driver_timing`` event,
the round-metrics flush) lives in :mod:`gossip_tpu_torch.utils.timing`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

PROFILE_ENV = "GOSSIP_PROFILE"


def profile_dir() -> Optional[str]:
    """``$GOSSIP_PROFILE``, the ambient capture directory, or None (unset
    or empty: profiling off)."""
    return os.environ.get(PROFILE_ENV) or None


def _on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def device_events(prof) -> list:
    """The CUDA kernel and memory events of a finished capture."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


@contextlib.contextmanager
def trace(logdir: Optional[str], device=None) -> Iterator[Optional[object]]:
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    as ``trace_<pid>_<ms>.json``; ``None``/empty is a no-op, so callers
    wrap unconditionally.  ``device`` (default: a card when there is one)
    says where the work runs: on a card the capture records CUDA
    activity too, and one with no device event raises.  Yields the
    profiler (None when off); its ``trace_path`` is set on exit."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile as tprofile
    card = _on_card(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    os.makedirs(logdir, exist_ok=True)
    with tprofile(activities=acts) as prof:
        yield prof
        if card:
            torch.cuda.synchronize()
    if card and not device_events(prof):
        raise RuntimeError(
            "the profiler recorded no CUDA activity on the card; no trace "
            f"was written to {logdir}")
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                f"{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region of the timeline: a ``record_function`` range, and an
    NVTX range when CUDA is up."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile(tag: Optional[str] = None, device=None) -> Iterator[None]:
    """The ``GOSSIP_PROFILE`` hook: a :func:`trace` of the block into the
    ambient directory, with ``tag`` as an annotation around it; a plain
    block when the variable is unset.  Captures do not nest: wrap the
    outer program and mark inner phases with :func:`annotate`."""
    logdir = profile_dir()
    if not logdir:
        yield
        return
    with trace(logdir, device):
        with annotate(tag) if tag else contextlib.nullcontext():
            yield


class RoundTimer:
    """Wall-clock per-round timing for host-stepped loops: ``with
    timer: step()`` once a round."""

    def __init__(self):
        self.times: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(1, len(self.times))

    def percentile_ms(self, q: float) -> float:
        """Nearest-rank percentile (``q`` in [0, 1]) of the round walls in
        ms, 0.0 with no samples (:func:`~gossip_tpu_torch.utils.telemetry.
        percentile`)."""
        from gossip_tpu_torch.utils.telemetry import percentile
        return 1e3 * percentile(self.times, q)

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(0.50)

    @property
    def p95_ms(self) -> float:
        return self.percentile_ms(0.95)
