"""Curve files, one JSON object per round, and the parity gap of two curves.

The port's copy of the JAX package's ``utils/metrics.dump_curve_jsonl``,
which the ``run``, ``crdt``, ``log`` and ``txn`` commands'
``--save-curve`` writes, in the same format, and of its ``curve_gap``,
which ``run --parity-check`` prints.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence


def curve_gap(a: Sequence[float], b: Sequence[float]) -> float:
    """Max absolute coverage gap between two curves (padded with their
    final values): the flood rounds' curve against the go-native hop
    curve gaps to 0 on race-free graphs (the parity contract of
    :mod:`gossip_tpu_torch.runtime.gonative`)."""
    la, lb = list(map(float, a)), list(map(float, b))
    m = max(len(la), len(lb))
    la += [la[-1]] * (m - len(la)) if la else [0.0] * m
    lb += [lb[-1]] * (m - len(lb)) if lb else [0.0] * m
    return max(abs(x - y) for x, y in zip(la, lb))


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
