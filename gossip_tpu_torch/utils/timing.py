"""Wall time of a run on the device it ran on.

There is no compile on this side: the CUDA kernels are built once, at
first use, and that build is reported as ``build_s`` in place of the
reference's ``compile_s``.
"""

from __future__ import annotations

import time

import torch


def steady_timed(device, fn, /, *args, **kwargs):
    """(out, seconds) of one call ``fn(*args, **kwargs)`` on ``device``.
    On a CUDA device the time is read from CUDA events recorded around
    the call, between two synchronizes: the call's device work and the
    host's waits inside it, not just the enqueue.  On the CPU it is the
    host clock."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kwargs)
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop) / 1e3


def timing_meta(build_s: float, steady_s: float, wall_s: float) -> dict:
    """The report's wall decomposition: the first-use kernel build (0.0
    when nothing was built or loaded in this call), the steady run, and
    the overhead around them (state build, host transfers), under the
    JAX report's key `driver_overhead_s`."""
    return {"build_s": round(build_s, 4),
            "steady_wall_s": round(steady_s, 4),
            "driver_overhead_s": round(max(0.0, wall_s - build_s - steady_s),
                                       4)}
