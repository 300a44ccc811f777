"""tools/collectives.py on the CPU: every collective the sharded drivers
use, through the node mesh's gloo groups of one, two and four ranks,
with the values each must return; and its refusal to run without a card
unless the CPU is asked for."""

import contextlib
import io
import json

import pytest
import torch

from gossip_tpu_torch.tools import collectives as CO

SIZES = (1, 2, 4)


@pytest.fixture(scope="module")
def lines():
    """The probe's output lines on the CPU's gloo groups, one run a
    module."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert CO.main(["--device", "cpu"]) == 0
    return [json.loads(s) for s in out.getvalue().splitlines()]


def test_every_collective_on_gloo_groups(lines):
    assert [(g["ranks"], g["backend"]) for g in lines] == \
        [(size, "gloo") for size in SIZES]
    one, two = lines[0]["results"][0], lines[1]["results"]
    assert one["all_gather_int32"] == list(range(8))
    assert one["combine_float32"] == [0.5, 1.0]
    assert one["all_reduce_max_int32"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for rank in two:
        assert rank["all_gather_int32"] == \
            list(range(8)) + list(range(100, 108))
        assert rank["all_gather_bool"] == [True, False] * 8
        assert rank["reduce_scatter_int32"] == [3] * 8
        assert rank["all_reduce_int64"] == [3] * 4
        assert rank["all_reduce_max_int32"] == [[100, 101, 102, 103],
                                                [104, 105, 106, 107]]
        # rank order: 0.5 + 1.5; 1.0 + 1.0
        assert rank["combine_float32"] == [2.0, 2.0]
        assert rank["all_gather_40MB_ms"] > 0


@pytest.mark.parametrize("size", SIZES)
def test_all_to_all_and_ppermute_on_gloo_groups(lines, size):
    """The sparse exchange's all_to_all (even and uneven splits) and the
    halo exchange's ppermute by +1 and -1, on every rank of one, two and
    four gloo ranks, against the values each must return."""
    ranks = lines[SIZES.index(size)]["results"]
    assert len(ranks) == size
    for r, out in enumerate(ranks):
        assert out["all_to_all_int32"] == [
            [100 * s + 10 * r + j for j in range(3)] for s in range(size)]
        assert out["all_to_all_bool"] == [
            [(2 * r + s + j) % 2 == 0 for j in range(2)]
            for s in range(size)]
        assert out["all_to_all_uneven"] == [
            100 * s + 10 * r + j for s in range(size)
            for j in range(s + r + 1)]
        left, right = (r - 1) % size, (r + 1) % size
        assert out["ppermute_plus1"] == [100 * left + j for j in range(4)]
        assert out["ppermute_minus1"] == [
            (100 * right + j) % 2 == 0 for j in range(4, 8)]
        assert out["all_to_all_40MB_ms"] > 0


@pytest.mark.parametrize("size", SIZES)
def test_min_and_hybrid_mesh_on_gloo_groups(lines, size):
    """The fused planes' min all-reduce, and the hybrid mesh's sub-groups
    (2 x K/2, or 1 x 1): a sum, a min and an all_gather along each axis
    give the ranks of the rank's row and column."""
    ranks = lines[SIZES.index(size)]["results"]
    shape = (2, size // 2) if size % 2 == 0 else (1, size)
    for r, out in enumerate(ranks):
        assert out["all_reduce_min_int64"] == [10 - (size - 1), 0]
        mesh = out["hybrid_mesh"]
        row, col = divmod(r, shape[1])
        assert mesh["shape"] == list(shape) and mesh["coords"] == [row, col]
        inner = [row * shape[1] + j for j in range(shape[1])]
        outer = [i * shape[1] + col for i in range(shape[0])]
        for axis, members in (("inner", inner), ("outer", outer)):
            assert mesh[axis] == {"sum": [sum(members)],
                                  "min": [min(members)], "gather": members}


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs on the card")
def test_refuses_without_a_card(capsys):
    assert CO.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
