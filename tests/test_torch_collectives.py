"""tools/collectives.py on the CPU: every collective the sharded drivers
use, through the node mesh's gloo groups of one and two ranks, with the
values each must return; and its refusal to run without a card unless
the CPU is asked for."""

import json

import pytest
import torch

from gossip_tpu_torch.tools import collectives as CO


def test_every_collective_on_gloo_groups(capsys):
    assert CO.main(["--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(g["ranks"], g["backend"]) for g in lines] == \
        [(1, "gloo"), (2, "gloo")]
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


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs on the card")
def test_refuses_without_a_card(capsys):
    assert CO.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
