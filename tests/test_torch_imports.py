"""Import hygiene of the port: ``gossip_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, nothing of the JAX package ``gossip_tpu`` and
nothing of the repository's ``tools/`` (the port keeps its own copies of
the tools it needs, under ``gossip_tpu_torch/tools/``).

Two pins: a fresh interpreter imports the package and every module in
it, then finds neither ``jax`` nor any ``gossip_tpu`` / ``gossip_tpu.*``
nor ``tools.*`` module loaded; and an AST scan finds no such import
statement anywhere in the port's sources, including imports inside
functions.  Module names are matched exactly (``gossip_tpu_torch``
itself starts with ``gossip_tpu``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "gossip_tpu", "tools")

PROBE = """
import importlib, json, pkgutil, sys
import gossip_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    gossip_tpu_torch.__path__, "gossip_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "gossip_tpu", "tools")]
print(json.dumps({"imported": names, "forbidden": loaded}))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_names_match_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("gossip_tpu") and _forbidden("gossip_tpu.ops")
    assert not _forbidden("gossip_tpu_torch")
    assert not _forbidden("gossip_tpu_torch.ops.fused_round")
    assert not _forbidden("jaxlib_free")
    assert _forbidden("tools.load_harness") and _forbidden("tools")
    assert not _forbidden("gossip_tpu_torch.tools.load_harness")


def test_importing_every_module_loads_no_jax():
    import json
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "gossip_tpu_torch.ops.fused_round" in out["imported"]
    assert "gossip_tpu_torch.__main__" in out["imported"]
    assert "gossip_tpu_torch.models.swim" in out["imported"]
    assert "gossip_tpu_torch.models.rumor" in out["imported"]
    for name in ("ops.crdt", "models.crdt", "ops.logs", "models.log",
                 "ops.registers", "models.register", "utils.metrics",
                 "parallel", "parallel.group", "parallel.sharded",
                 "parallel.sharded_packed", "parallel.sharded_swim",
                 "parallel.sharded_rumor", "parallel.sharded_crdt",
                 "parallel.sharded_log", "parallel.sharded_register",
                 "parallel.sharded_sparse", "parallel.halo",
                 "parallel.sharded_fused", "parallel.multislice",
                 "parallel.sweep", "utils.checkpoint", "planner",
                 "planner.budget", "planner.stream", "utils.telemetry",
                 "utils.trace", "ops.round_metrics", "tools.crashloop",
                 "tools.load_harness", "tools.fleet_crashloop",
                 "tools.trace_report",
                 "rpc", "rpc.batcher", "rpc.sidecar", "rpc.router",
                 "native", "runtime.gonative", "runtime.native_sim",
                 "runtime.native_router", "runtime.txn_checker",
                 "runtime.maelstrom_node", "runtime.maelstrom_harness"):
        assert f"gossip_tpu_torch.{name}" in out["imported"]
    assert out["forbidden"] == []


NO_GRPC = """
import importlib, json, pkgutil, sys
sys.modules["grpc"] = None          # an installation without grpc
import gossip_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    gossip_tpu_torch.__path__, "gossip_tpu_torch."))
for name in names:
    importlib.import_module(name)
from gossip_tpu_torch.rpc import sidecar
errors = []
for call in (lambda: sidecar.serve(port=0, device="cpu"),
             lambda: sidecar.SidecarClient("127.0.0.1:1")):
    try:
        call()
    except ImportError as e:
        errors.append(str(e))
print(json.dumps({"imported": names, "errors": errors}))
"""


def test_every_module_imports_without_grpc():
    """The serving modules import grpc only inside the transport
    functions: with grpc missing every module imports, and the transport
    raises an ImportError that names grpc."""
    import json
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", NO_GRPC], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("rpc", "rpc.batcher", "rpc.sidecar", "rpc.router"):
        assert f"gossip_tpu_torch.{name}" in out["imported"]
    assert len(out["errors"]) == 2
    assert all("grpc" in e for e in out["errors"])


def _sources():
    return sorted(REPO.glob("gossip_tpu_torch/**/*.py")) + \
        [REPO / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_covers_the_native_loader():
    assert REPO / "gossip_tpu_torch" / "native" / "__init__.py" in _sources()


def test_maelstrom_node_imports_no_torch():
    """``python -m gossip_tpu_torch.runtime.maelstrom_node --help`` (the
    command the harness spawns N times) imports neither torch nor JAX
    nor anything of the JAX package: the interpreter's own import log
    (``-X importtime``) of the real ``-m`` start names every module."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "gossip_tpu_torch.runtime.maelstrom_node", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "--workload" in proc.stdout
    loaded = {ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
              if ln.startswith("import time:")}
    assert "gossip_tpu_torch.runtime" in loaded
    bad = sorted(m for m in loaded
                 if m.split(".")[0] in ("torch", "jax", "gossip_tpu"))
    assert bad == []
