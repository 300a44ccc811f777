"""Scale planner: the device-memory budget model and the streamed
bit-plane executor.

The port of the JAX package's ``planner`` package.

* :mod:`gossip_tpu_torch.planner.budget` — the pure host-side
  device-memory / host-RAM budget model.  ``plan_scale`` emits a
  validated :class:`ScalePlan` or refuses loudly with the binding
  constraint named; it never touches a device.
* :mod:`gossip_tpu_torch.planner.stream` — ``run_at_scale``: executes a
  ScalePlan through the packed pull round by streaming word-plane tiles
  host <-> device per checkpoint segment, bitwise identical to the
  untiled in-memory run.

CLI: ``python -m gossip_tpu_torch plan`` / ``scale-run`` / ``run
--plan``.
"""

from gossip_tpu_torch.planner.budget import (  # noqa: F401
    DeviceSpec, InfeasiblePlanError, ScalePlan, plan_fingerprint,
    plan_scale, validate_plan)
