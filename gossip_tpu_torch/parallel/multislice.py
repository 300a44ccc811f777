"""Hybrid two-level meshes and the multi-host bootstrap.

The port of the JAX package's ``parallel/multislice.py``.  Across hosts
the layout rule is the reference's: the communication-heavy axis (the
node mesh's digest collectives) stays inside a host, whose cards share
NVLink, and the communication-light axis (independent sweep points, or
the rumor planes, which exchange a scalar a round) crosses hosts.

* :func:`make_hybrid_mesh` groups the world's ranks by the host each
  runs on (:func:`device_slice_index`: ``torchrun``'s ``GROUP_RANK``,
  the node rank) into a ``(dcn_slices, per_slice)`` grid, each row one
  host, and returns this rank's two sub-groups
  (:class:`~gossip_tpu_torch.parallel.group.Group` over
  ``dist.new_group``): ``inner`` along its row (inside its host) and
  ``outer`` along its column (across hosts).  On one host it is a plain
  row-major reshape of the ranks.  :func:`_hybrid_device_grid` is the
  grouping alone, testable on fake slice indices.
* :func:`maybe_init_distributed` brings the process group up for a run
  that ``torchrun`` (or any launcher that sets ``MASTER_ADDR``, ``RANK``
  and ``WORLD_SIZE``) started on several hosts, or where
  ``GOSSIP_TPU_MULTIHOST=1`` says so.  Without either it does nothing:
  waiting for peers that never come would hang a single-host run.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gossip_tpu_torch.parallel import group as GR

# what torchrun sets for every rank it starts
LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


class RankSlot(NamedTuple):
    """One rank of the world and the host (slice) it runs on."""

    id: int
    slice_index: int


def device_slice_index() -> int:
    """The host this process runs on: ``torchrun``'s node rank
    (``GROUP_RANK``), else 0."""
    return int(os.environ.get("GROUP_RANK", 0))


def world_slots(device=None) -> list:
    """Every rank of the world with its host, in rank order: gathered
    over the process group when one is up (on ``device``, as
    :func:`~gossip_tpu_torch.parallel.group.current` takes it), else this
    process alone."""
    if not (dist.is_available() and dist.is_initialized()):
        return [RankSlot(0, device_slice_index())]
    base = GR.current(device)
    mine = torch.tensor([device_slice_index()], dtype=torch.int64,
                        device=base.device)
    return [RankSlot(r, int(s))
            for r, s in enumerate(base.all_gather(mine).tolist())]


def detect_slices(slots: Optional[Sequence] = None, device=None) -> int:
    """Number of distinct hosts among ``slots`` (default: the world's,
    gathered on ``device``)."""
    slots = world_slots(device) if slots is None else list(slots)
    return len({s.slice_index for s in slots})


def _hybrid_device_grid(devs: Sequence, dcn_slices: int,
                        per_slice: int) -> np.ndarray:
    """The ``(dcn_slices, per_slice)`` grid of ``devs`` (each with ``id``
    and ``slice_index``) behind :func:`make_hybrid_mesh`: with several
    slices each row is one slice (members in id order, the first
    ``per_slice`` of each of the first ``dcn_slices`` slices, so sub-meshes
    are allowed and a row never crosses slices); with one slice a
    row-major reshape."""
    if dcn_slices < 1 or per_slice < 1:
        raise ValueError("mesh axes must be >= 1")
    want = dcn_slices * per_slice
    if len(devs) < want:
        raise ValueError(f"hybrid mesh {dcn_slices}x{per_slice} needs "
                         f"{want} devices; only {len(devs)} available")
    groups: dict = {}
    for d in devs:
        groups.setdefault(d.slice_index, []).append(d)
    grid = np.empty((dcn_slices, per_slice), dtype=object)
    if len(groups) > 1:
        slice_ids = sorted(groups)
        if dcn_slices > len(slice_ids):
            raise ValueError(
                f"hybrid mesh wants {dcn_slices} DCN slices; platform "
                f"reports {len(slice_ids)}")
        for i, sid in enumerate(slice_ids[:dcn_slices]):
            members = sorted(groups[sid], key=lambda d: d.id)
            if len(members) < per_slice:
                raise ValueError(
                    f"slice {sid} has {len(members)} devices; the inner "
                    f"mesh axis wants {per_slice} and must not cross DCN")
            for j, d in enumerate(members[:per_slice]):
                grid[i, j] = d
        return grid
    for k, d in enumerate(list(devs)[:want]):
        grid[k // per_slice, k % per_slice] = d
    return grid


class HybridMesh(NamedTuple):
    """This rank's place in a hybrid mesh: its ``(row, column)``, the
    sub-group along its column (``outer``, across slices) and along its
    row (``inner``, inside one slice).  A rank outside the grid holds
    None for all three."""

    coords: Optional[Tuple[int, int]]
    outer: Optional[GR.Group]
    inner: Optional[GR.Group]


def make_hybrid_mesh(dcn_slices: int, per_slice: int,
                     device=None) -> HybridMesh:
    """This rank's :class:`HybridMesh` of shape ``(dcn_slices,
    per_slice)`` over the process group that is up (every rank of the
    world must call it: each sub-group is made by all of them).  The
    sub-groups' collectives run on ``device`` (default: the rank's, as
    :func:`~gossip_tpu_torch.parallel.group.current` picks it)."""
    base = GR.current(device)
    grid = _hybrid_device_grid(world_slots(device), dcn_slices, per_slice)
    ids = np.vectorize(lambda d: d.id, otypes=[int])(grid)
    mine = None
    subgroups = {}
    for axis, lines in (("inner", ids), ("outer", ids.T)):
        for line in lines:
            ranks = [int(r) for r in line]
            pg = dist.new_group(ranks)
            if base.rank in ranks:
                subgroups[axis] = GR.Group(ranks.index(base.rank), len(ranks),
                                           base.device, base.backend, pg=pg)
    if base.rank in ids:
        row, col = (int(x[0]) for x in np.nonzero(ids == base.rank))
        mine = (row, col)
    return HybridMesh(mine, subgroups.get("outer"), subgroups.get("inner"))


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """Bring up the process group of a multi-host run.  Opt-in: it fires
    when the launcher's variables (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) are all set, or ``GOSSIP_TPU_MULTIHOST=1`` is, and
    then calls ``init_process_group(init_method="env://")``, NCCL on
    ``cuda:LOCAL_RANK`` where there is a card, else gloo (``backend``
    picks one: gloo for ranks on the CPU or sharing a card).  Returns
    True when it brought the group up.  Without the variables it does
    nothing and returns False, and a group that is already up is left as
    it is (False too)."""
    env = os.environ
    launched = all(env.get(k) is not None for k in LAUNCHER_ENV)
    if not (launched or env.get("GOSSIP_TPU_MULTIHOST") == "1"):
        return False
    if dist.is_initialized():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method="env://", timeout=GR.TIMEOUT,
                            **kw)
    return True
