"""``run_simulation``: the port's backend for the fused pull routes.

The port of the JAX package's ``backend.run_simulation`` on its
``engine='fused'``, single-device branch (``_run_fused``): pull gossip on
the implicit complete graph, one rumor on the node-packed bitmap
(:mod:`gossip_tpu_torch.ops.fused_round`) or up to 32 on one word per
node (:mod:`gossip_tpu_torch.ops.fused_mr_round`), one CUDA kernel
launch per round.  The report carries the reference's ``RunReport``
fields.  Whatever the port does not run is refused with a
``ValueError``, never run some other way.

The run is on the CUDA device unless the caller passes ``device="cpu"``,
which runs the round's plain version; with no card and no explicit
device it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.utils.timing import steady_timed, timing_meta


@dataclasses.dataclass
class RunReport:
    """One simulation's outcome (JSON-serializable), with the fields of
    the JAX package's report."""

    backend: str
    mode: str
    n: int
    rounds: int
    coverage: float
    msgs: float
    wall_s: float
    curve: Optional[List[float]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _curve_summary(covs, msgs, target):
    """(rounds_to_target, final_cov, final_msgs, curve) from per-round
    series; -1 when the target was never reached."""
    hit = [i for i, c in enumerate(covs) if c >= target]
    return ((hit[0] + 1) if hit else -1, float(covs[-1]), float(msgs[-1]),
            [float(c) for c in covs])


def fused_ineligible_reason(proto: ProtocolConfig, topo: TopologyConfig,
                            run: RunConfig,
                            fault: Optional[FaultConfig]) -> Optional[str]:
    """Why this slice cannot run the configuration, or None if it can.
    Configuration reasons only; the device is resolved afterwards."""
    if run.engine != "fused":
        return (f"the port runs engine='fused' only (got {run.engine!r}); "
                "the XLA engines wait for the threefry port")
    if proto.mode != "pull":
        return (f"engine='fused' implements pull rounds only "
                f"(got mode {proto.mode!r})")
    if topo.family != "complete":
        return ("engine='fused' runs on the implicit complete "
                f"topology only (got family {topo.family!r})")
    if proto.rumors > FR.BITS:
        return (f"engine='fused' packs <= {FR.BITS} rumors per word on "
                f"one device (got rumors={proto.rumors}); rumor planes "
                "across devices wait for the port's multi-GPU slice")
    if fault is not None and fault.churn is not None:
        return ("engine='fused' routing does not run churn schedules "
                "single-device")
    if fault is not None and fault.node_death_rate:
        return FR.DEATHS_NEED_THREEFRY
    if topo.n >= 1 << 31:
        return (f"n={topo.n}: node ids and the round's popcount counter "
                "are 32-bit; n must stay below 2^31")
    return None


def run_simulation(proto: ProtocolConfig, topo: TopologyConfig,
                   run: RunConfig, fault: Optional[FaultConfig] = None,
                   want_curve: bool = False, device=None) -> RunReport:
    """Run the fused pull loop to ``run.target_coverage`` (with several
    rumors: the minimum over rumors) or ``run.max_rounds``
    (``want_curve``: exactly ``max_rounds`` rounds, with the coverage
    after each).  ``meta`` names the engine that ran (``fused-cuda``: the
    kernels; ``fused-plain``: the plain versions on the CPU), the layout,
    the multi-rumor route, every kernel's launches, and the wall's
    parts."""
    reason = fused_ineligible_reason(proto, topo, run, fault)
    if reason is not None:
        raise ValueError(reason)
    dev = FR.resolve_device(device)
    n = topo.n
    multi = proto.rumors > 1
    table_bytes = (MR.check_fused_fits(n, proto.rumors, dev)
                   if multi else MR.fused_table_bytes(n, 1))
    t0 = time.perf_counter()
    build_s = 0.0
    if dev.type == "cuda":
        _kernels.build_all()
        build_s = time.perf_counter() - t0
    launches0 = {k.name: k.launches for k in _kernels.KERNELS}
    kw = dict(seed=run.seed, fanout=proto.fanout, max_rounds=run.max_rounds,
              origin=run.origin, fault=fault, device=dev)
    if multi:
        until_fn = functools.partial(MR.until_fused_multirumor,
                                     rumors=proto.rumors)
        curve_fn = functools.partial(MR.curve_fused_multirumor,
                                     rumors=proto.rumors)
    else:
        until_fn, curve_fn = FR.until_fused, FR.curve_fused
    if want_curve:
        (final, covs), steady = steady_timed(dev, curve_fn, n, **kw)
        rounds, cov, msgs, curve = _curve_summary(
            covs, [float(final.msgs)], run.target_coverage)
        host_reads = 1
    else:
        (final, cov), steady = steady_timed(
            dev, until_fn, n, target_coverage=run.target_coverage, **kw)
        hit = cov >= float(np.float32(run.target_coverage))
        rounds, msgs, curve = (final.round if hit else -1), \
            float(final.msgs), None
        host_reads = final.round
    wall = time.perf_counter() - t0
    return RunReport(
        backend=f"torch-{dev.type}", mode=proto.mode, n=n, rounds=rounds,
        coverage=cov, msgs=msgs, wall_s=round(wall, 4), curve=curve,
        meta={"clock": "rounds", "devices": 1,
              "msgs_counts": "transmissions",
              "engine": "fused-cuda" if dev.type == "cuda" else "fused-plain",
              "layout": ("one 32-rumor word per node" if multi
                         else "node-packed bitmap"),
              "route": "value" if multi else None,
              "table_bytes": table_bytes,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "launches": {k.name: k.launches - launches0[k.name]
                           for k in _kernels.KERNELS},
              "host_reads": host_reads,
              **timing_meta(build_s, steady, wall)})
