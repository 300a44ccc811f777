"""Provenance of the port's measurement documents.

The port's copy of the JAX package's ``utils/telemetry.provenance``: the
same keys (``run_id``, ``schema``, ``git_commit``, ``captured``,
``argv``, ``python``, ``platform``, ``pid``; the first three are what
``tools/validate_artifacts.py`` requires of an artifact), with the
``torch`` and ``cuda`` versions in place of ``jax_version`` and, for a
CUDA device, the card's name and power limit as ``nvidia-smi`` reports
them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from pathlib import Path
from typing import Optional

import torch

SCHEMA_VERSION = 1
_REPO = Path(__file__).resolve().parent.parent.parent


def git_commit() -> Optional[str]:
    """HEAD of the checkout this module ships in, or None (an export
    without ``.git``, or no git binary)."""
    try:
        p = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_REPO,
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    out = p.stdout.strip()
    return out if p.returncode == 0 and len(out) == 40 else None


def card_info(index: int = 0) -> dict:
    """The CUDA card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit`` reports them.  Raises when there is
    no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: there is no card to name")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, power_limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": power_limit}


def provenance(argv=None, device=None) -> dict:
    """The provenance block of a measurement document; ``device`` (a
    CUDA device) adds the card's ``nvidia-smi`` name and power limit."""
    doc = {
        "run_id": uuid.uuid4().hex[:12],
        "schema": SCHEMA_VERSION,
        "git_commit": git_commit(),
        "captured": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv) if argv is None else list(argv),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "pid": os.getpid(),
    }
    if device is not None and torch.device(device).type == "cuda":
        doc["card"] = card_info(torch.device(device).index or 0)
    return doc
