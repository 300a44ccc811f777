"""The port's hybrid meshes and multi-host bootstrap
(``gossip_tpu_torch.parallel.multislice``) on the CPU: the slice grouping
against the reference's ``_hybrid_device_grid`` on fake slice indices,
``maybe_init_distributed`` without and with a launcher's environment
(two ``python -m gossip_tpu_torch run --devices 2`` processes that join
one gloo group through ``env://`` on a free local port and run as its
ranks), and ``make_hybrid_mesh(2, 2)`` on four spawned ranks.
Tolerance: 0 (integers and the runs' reports, exactly)."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import multislice as MS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeDev:
    def __init__(self, id, slice_index):
        self.id = id
        self.slice_index = slice_index


# 2 slices x 4, in an interleaved enumeration order on purpose
DEVS = [(i, i % 2) for i in range(8)]

# (dcn_slices, per_slice, error): the grid or its refusal
GRIDS = [(2, 4, None), (1, 2, None), (2, 2, None), (3, 2, "DCN slices"),
         (1, 5, "must not cross"), (0, 4, ">= 1"), (4, 4, "devices")]


@pytest.mark.parametrize("dcn,per,error", GRIDS,
                         ids=[f"{d}x{p}" for d, p, _ in GRIDS])
def test_hybrid_grid_equals_reference(dcn, per, error):
    """Each grid (every row one slice; sub-meshes allowed) and each
    refusal equal the reference's on the same fake slice indices."""
    from gossip_tpu.parallel.multislice import _hybrid_device_grid
    ours = [_FakeDev(i, s) for i, s in DEVS]
    theirs = [_FakeDev(i, s) for i, s in DEVS]
    if error is not None:
        with pytest.raises(ValueError, match=error) as got:
            MS._hybrid_device_grid(ours, dcn, per)
        with pytest.raises(ValueError) as want:
            _hybrid_device_grid(theirs, dcn, per)
        assert str(got.value) == str(want.value)
        return
    grid = MS._hybrid_device_grid(ours, dcn, per)
    want = _hybrid_device_grid(theirs, dcn, per)
    assert grid.shape == want.shape == (dcn, per)
    assert [[d.id for d in row] for row in grid] == \
        [[d.id for d in row] for row in want]
    assert all(len({d.slice_index for d in row}) == 1 for row in grid)


def test_single_slice_grid_is_a_reshape():
    """One slice: a row-major reshape of the ranks, as the reference's
    grid of its virtual CPU devices; one host by default."""
    slots = [MS.RankSlot(r, 0) for r in range(6)]
    grid = MS._hybrid_device_grid(slots, 2, 3)
    assert [[s.id for s in row] for row in grid] == [[0, 1, 2], [3, 4, 5]]
    assert MS.detect_slices(slots) == 1
    assert MS.detect_slices([MS.RankSlot(0, 0), MS.RankSlot(1, 3)]) == 2


def test_slice_index_is_the_node_rank(monkeypatch):
    monkeypatch.delenv("GROUP_RANK", raising=False)
    assert MS.device_slice_index() == 0
    monkeypatch.setenv("GROUP_RANK", "3")
    assert MS.device_slice_index() == 3
    assert MS.world_slots() == [MS.RankSlot(0, 3)]


def test_maybe_init_distributed_noop_without_env(monkeypatch):
    for key in ("GOSSIP_TPU_MULTIHOST", *MS.LAUNCHER_ENV):
        monkeypatch.delenv(key, raising=False)
    assert MS.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    # one of the launcher's three variables alone does not fire
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert MS.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launched_ranks_run_as_the_group():
    """Two processes started as a launcher starts them (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) bring one gloo group up
    through ``maybe_init_distributed`` and run ``run --engine fused
    --devices 2`` as its two ranks: both print the report that the
    spawned ranks of ``run_simulation`` give."""
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.config import (MeshConfig, ProtocolConfig,
                                         RunConfig, TopologyConfig)
    args = ["--mode", "pull", "--n", "2011", "--rumors", "64", "--seed", "2"]
    port = _free_port()
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": "2",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gossip_tpu_torch", "run", *args, "--engine",
         "fused", "--devices", "2", "--device", "cpu"], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    reports = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    spawned = run_simulation(ProtocolConfig(mode="pull", rumors=64),
                             TopologyConfig(n=2011),
                             RunConfig(seed=2, engine="fused"),
                             device="cpu", mesh_cfg=MeshConfig(n_devices=2))
    for rep in reports:
        assert (rep["rounds"], rep["coverage"], rep["msgs"]) == \
            (spawned.rounds, spawned.coverage, spawned.msgs)
        assert rep["meta"]["devices"] == 2
        assert rep["meta"]["process_group"] == "gloo"


def _mesh_rank(group):
    """One rank of a 2 x 2 hybrid mesh: its coordinates and the sums of
    the world ranks along its row and its column."""
    mesh = MS.make_hybrid_mesh(2, 2, device="cpu")
    mine = torch.tensor([group.rank])
    return (mesh.coords,
            int(mesh.inner.all_reduce_sum(mine)),
            int(mesh.outer.all_reduce_sum(mine)),
            (mesh.inner.size, mesh.outer.size),
            MS.detect_slices(device="cpu"))


def test_hybrid_mesh_sums_along_each_axis():
    """``make_hybrid_mesh(2, 2)`` on four ranks of one host: ranks (0, 1)
    and (2, 3) share a row (``inner``), (0, 2) and (1, 3) a column
    (``outer``); a sum on each axis gives the row's and the column's
    sums."""
    got = GR.launch(_mesh_rank, 4, device="cpu")
    assert got == [((r // 2, r % 2),
                    1 if r < 2 else 5, 2 if r % 2 == 0 else 4, (2, 2), 1)
                   for r in range(4)]
