"""tools/launch_cost.py on the CPU: its timing helpers, and its refusal
to run without a card (the timings themselves need one)."""

from __future__ import annotations

import types

import pytest
import torch

from gossip_tpu_torch.tools import launch_cost as LC


def test_per_call_us_times_every_batch_after_a_warm_up():
    """Batches of back-to-back calls, one warm-up batch left out, a
    synchronisation before each batch and after the last."""
    calls, syncs = [], []
    us = LC._per_call_us(lambda: calls.append(1), 5, 3,
                         lambda: syncs.append(len(calls)))
    assert len(calls) == 5 * (3 + 1)
    assert syncs == [0, 5, 10, 15, 20]
    assert us >= 0


def test_loop_ms_reports_the_median_wall_and_the_rounds():
    runs = []

    def run():
        runs.append(1)
        return types.SimpleNamespace(round=27)

    ms, rounds = LC._loop_ms(run, 3, lambda: None)
    assert len(runs) == 3 + 1 and rounds == 27 and ms >= 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs on the card")
def test_refuses_without_a_card(capsys):
    assert LC.main(["--n", "4096"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
