"""Import hygiene of the port: ``gossip_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX and nothing of the JAX package ``gossip_tpu``.

Two pins: a fresh interpreter imports the package and every module in
it, then finds neither ``jax`` nor any ``gossip_tpu`` / ``gossip_tpu.*``
module loaded; and an AST scan finds no such import statement anywhere
in the port's sources, including imports inside functions.  Module
names are matched exactly (``gossip_tpu_torch`` itself starts with
``gossip_tpu``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "gossip_tpu")

PROBE = """
import importlib, json, pkgutil, sys
import gossip_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    gossip_tpu_torch.__path__, "gossip_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "gossip_tpu")]
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
                 "parallel.sweep"):
        assert f"gossip_tpu_torch.{name}" in out["imported"]
    assert out["forbidden"] == []


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
