"""Wall time of a run on the device it ran on, and the device time of a
chain of steps.

There is no compile on this side: the CUDA kernels are built once, at
first use, and that build is reported as ``build_s`` in place of the
reference's ``compile_s``.

:func:`steady_timed` is the port's chokepoint, the counterpart of the
reference's ``utils/trace.maybe_aot_timed``: every timed driver call goes
through it, and after its stop event, outside the timed window, it
writes the ``driver_timing`` event to the ambient run ledger and flushes
the round-metrics stacks the call delivered
(:mod:`gossip_tpu_torch.ops.round_metrics`).
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

SLEEP_CYCLES = 20_000_000  # device sleep that queues a timed chain behind it


def timed_chain(step, init, iters: int, device, repeats: int = 3,
                graph: bool = False, chains: Optional[list] = None) -> float:
    """Seconds per iteration for ``iters`` chained applications
    ``carry = step(i, carry)``, ``i = 0 .. iters-1``, from ``init``: the
    median of ``repeats`` timed chains after one warm-up chain (which
    also builds the kernels).  The counterpart of the JAX package's
    ``tools/_timing.timed_chain``, whose chain is one jitted
    ``fori_loop`` with no host dispatch in it.  On a CUDA device each
    chain is queued behind a device sleep and timed with CUDA events
    (:func:`_behind_sleep`).  ``graph=True`` captures the chain once in
    a CUDA graph and times its replays, for a chain of many small
    launches: the capture calls each wrapper once more (its launch
    counter counts that), the replays call none.  On the CPU it is the
    host clock.  ``chains``: a list to which the number of chains that
    called ``step`` is appended (the warm-up, the capture, each timed
    chain, and one more for each timing :func:`_behind_sleep` retried),
    so a caller knows how many launches each wrapper made."""
    device = torch.device(device)
    called = 0

    def chain():
        nonlocal called
        called += 1
        carry = init
        for i in range(iters):
            carry = step(i, carry)
        return carry

    chain()
    run = chain
    if graph and device.type == "cuda":
        torch.cuda.synchronize(device)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            chain()
        run = captured.replay
        run()                          # the first replay uploads the graph
    samples = []
    for _ in range(repeats):
        if device.type == "cuda":
            seconds = _behind_sleep(run, device)
        else:
            t0 = time.perf_counter()
            run()
            seconds = time.perf_counter() - t0
        samples.append(seconds / iters)
    if chains is not None:
        chains.append(called)
    return statistics.median(samples)


def _behind_sleep(run, device) -> float:
    """Device seconds of ``run()`` queued behind a device sleep
    (``torch.cuda._sleep``), so the host's enqueue is off the clock.  If
    the device reached the work before the host had queued all of it, the
    reading would hold the enqueue: the sleep grows, up to 64-fold, and
    then it raises."""
    for grow in (1, 4, 16, 64):
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SLEEP_CYCLES * grow)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        queued_first = not start.query()
        stop.record()
        torch.cuda.synchronize(device)
        if queued_first:
            return start.elapsed_time(stop) / 1e3
    raise RuntimeError("the host queued the chain slower than the device "
                       "slept, so its time would hold the enqueue; time it "
                       "with graph=True")


def steady_timed(device, fn, /, *args, **kwargs):
    """(out, seconds) of one call ``fn(*args, **kwargs)`` on ``device``.
    On a CUDA device the time is read from CUDA events recorded around
    the call, between two synchronizes: the call's device work and the
    host's waits inside it, not just the enqueue.  On the CPU it is the
    host clock.  Then, outside the timed window, the call's records
    (:func:`_records`)."""
    from gossip_tpu_torch.ops import round_metrics as RM
    device = torch.device(device)
    with RM.collecting() as stacks:
        if device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds = time.perf_counter() - t0
        else:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(stop) / 1e3
    _records(fn, seconds, stacks)
    return out, seconds


def _records(fn, seconds: float, stacks: list) -> None:
    """The chokepoint's ledger half: one ``driver_timing`` event (flush
    only: a caller may be timing this call) with the function's name, its
    module as the label and the steady wall, then every round-metrics
    stack the call delivered, read to the host once
    (:func:`~gossip_tpu_torch.ops.round_metrics.emit`; under a group a
    collective of every rank)."""
    from gossip_tpu_torch.ops import round_metrics as RM
    from gossip_tpu_torch.utils import telemetry
    led = telemetry.current()
    name = getattr(fn, "__name__", None) or type(fn).__name__
    led.event("driver_timing", sync=False, fn=name,
              label=getattr(fn, "__module__", "").rsplit(".", 1)[-1] or None,
              steady_s=seconds)
    if stacks:
        RM.emit([(m, f or name) for m, f in stacks], led)


def timing_meta(build_s: float, steady_s: float, wall_s: float) -> dict:
    """The report's wall decomposition: the first-use kernel build (0.0
    when nothing was built or loaded in this call), the steady run, and
    the overhead around them (state build, host transfers), under the
    JAX report's key `driver_overhead_s`."""
    return {"build_s": round(build_s, 4),
            "steady_wall_s": round(steady_s, 4),
            "driver_overhead_s": round(max(0.0, wall_s - build_s - steady_s),
                                       4)}
