"""Build and drive the native (C++) mini-Maelstrom router.

``native/router.cpp`` is the standalone twin of
:mod:`gossip_tpu_torch.runtime.maelstrom_harness`: one poll() event loop
that spawns the protocol-node processes, routes envelopes with latency and
a partition window, runs the broadcast workload, and checks the
eventual-delivery invariant.  This module compiles it at first use into
the port's build directory (``native.build_native``; without a compiler it
raises, where the reference's returns ``None``) and parses its one-line
JSON stats.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_lock = threading.Lock()


def build_router() -> str:
    """Path to the router program, built first if needed; raises a
    ``ValueError`` naming the compiler's error when it cannot be built."""
    from gossip_tpu_torch.native import ROUTER_SRC, build_native, output_path
    with _lock:
        return str(build_native(ROUTER_SRC, output_path(ROUTER_SRC, "router"),
                                shared=False))


def run_native_workload(n: int, ops: int, rate: float = 50.0,
                        latency: float = 0.002, topology: str = "line",
                        partition_mid: bool = False, seed: int = 0,
                        argv: Optional[List[str]] = None,
                        timeout: float = 180.0) -> dict:
    """The broadcast workload through the NATIVE router; the stats dict of
    maelstrom_harness.run_broadcast_workload (plus ``engine:
    native-router``)."""
    binary = build_router()
    node_cmd = argv or [sys.executable, "-u", "-m",
                        "gossip_tpu_torch.runtime.maelstrom_node"]
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [binary, "--n", str(n), "--latency-ms", str(latency * 1e3),
           "--ops", str(ops), "--rate", str(rate),
           "--topology", topology, "--seed", str(seed)]
    if partition_mid:
        cmd.append("--partition")
    cmd += ["--"] + node_cmd
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    lines = [line for line in p.stdout.splitlines() if line.strip()]
    if not lines:
        raise RuntimeError(f"native router produced no stats "
                           f"(rc={p.returncode}): {p.stderr[-300:]}")
    return json.loads(lines[-1])
