"""Curve files: one JSON object per round.

The port's copy of the JAX package's ``utils/metrics.dump_curve_jsonl``,
which the ``run``, ``crdt``, ``log`` and ``txn`` commands'
``--save-curve`` writes, in the same format.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence


def dump_curve_jsonl(path: str, coverage: Sequence[float],
                     msgs: Optional[Sequence[float]] = None,
                     meta: Optional[dict] = None) -> None:
    """One JSON object per round, ``{round, coverage, msgs?}``, after an
    optional ``{"meta": ...}`` line.  A msgs series of the wrong length
    is refused before the file is opened."""
    if msgs is not None and len(msgs) != len(coverage):
        raise ValueError(
            f"len(msgs)={len(msgs)} != len(coverage)={len(coverage)}; "
            "each round needs both series (pass msgs=None to omit)")
    with open(path, "w") as f:
        if meta is not None:
            f.write(json.dumps({"meta": meta}) + "\n")
        for i, c in enumerate(coverage):
            row = {"round": i + 1, "coverage": float(c)}
            if msgs is not None:
                row["msgs"] = float(msgs[i])
            f.write(json.dumps(row) + "\n")
