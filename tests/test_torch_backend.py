"""The port's entry points on the CPU: ``run_simulation``, the command
line, the bench line and ``chip_smoke.py``.

The run's numbers, with one rumor and with several, are held against
the JAX package's round replayed on the port's Philox bits
(tests/_torch_reference.py), and the report against the JAX package's
``RunReport`` fields.  Every route
this slice does not run must be refused loudly, and so must a run that
needs the card when there is none.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gossip_tpu.backend import RunReport as JRunReport
from gossip_tpu_torch import bench
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)
from _torch_reference import jax_mr_replay, jax_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096 * 8 - 37
PULL = ProtocolConfig(mode="pull")
TOPO = TopologyConfig(n=N)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    """The reference runs with its executable store off."""
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _port(*args, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")


@pytest.mark.parametrize("drop_prob", [0.0, 0.05])
def test_run_simulation_matches_reference(drop_prob):
    fault = FaultConfig(drop_prob=drop_prob) if drop_prob else None
    rep = run_simulation(PULL, TOPO, RunConfig(seed=4), fault, device="cpu")
    _, rounds, msgs, cov = jax_replay(N, 4, 1, 0.99, 256, drop_prob)
    assert (rep.rounds, rep.coverage, rep.msgs) == (rounds, cov, float(msgs))
    out = rep.to_dict()
    assert set(out) == {f.name for f in dataclasses.fields(JRunReport)}
    assert out["meta"]["layout"] == "node-packed bitmap"
    assert out["meta"]["engine"] == "fused-plain"
    assert out["backend"] == "torch-cpu"
    assert out["meta"]["launches"] == {"fused_round": 0, "fused_mr_round": 0,
                                       "mr_gather": 0}


@pytest.mark.parametrize("fanout,drop_prob", [(1, 0.0), (2, 0.05)])
def test_multirumor_run_matches_reference(fanout, drop_prob):
    fault = FaultConfig(drop_prob=drop_prob) if drop_prob else None
    rep = run_simulation(ProtocolConfig(mode="pull", fanout=fanout,
                                        rumors=8),
                         TOPO, RunConfig(seed=4), fault, device="cpu")
    _, rounds, msgs, cov = jax_mr_replay(N, 8, 4, fanout, 0.99, 256,
                                         drop_prob)
    assert (rep.rounds, rep.coverage, rep.msgs) == (rounds, cov, float(msgs))
    meta = rep.to_dict()["meta"]
    assert meta["layout"] == "one 32-rumor word per node"
    assert meta["route"] == "value" and meta["engine"] == "fused-plain"
    assert meta["table_bytes"] == 256 * 128 * 4
    assert set(meta["launches"].values()) == {0}
    curve = run_simulation(ProtocolConfig(mode="pull", fanout=fanout,
                                          rumors=8),
                           TOPO, RunConfig(seed=4, max_rounds=rounds), fault,
                           want_curve=True, device="cpu")
    assert curve.rounds == rounds and curve.curve[-1] == cov
    assert curve.msgs == rep.msgs


def test_curve_run_matches_reference():
    rep = run_simulation(PULL, TOPO, RunConfig(seed=1, max_rounds=20),
                         want_curve=True, device="cpu")
    _, rounds, _, _ = jax_replay(N, 1, 1, 0.99, 256, 0.0)
    assert rep.rounds == rounds and len(rep.curve) == 20
    assert rep.msgs == 2.0 * N * 20 and rep.coverage == rep.curve[-1]


def test_cli_prints_the_report():
    proc = _port("-m", "gossip_tpu_torch", "run", "--mode", "pull", "--n",
                 str(N), "--engine", "fused", "--fanout", "2",
                 "--drop-prob", "0.05", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rep = run_simulation(ProtocolConfig(mode="pull", fanout=2), TOPO,
                         RunConfig(), FaultConfig(drop_prob=0.05),
                         device="cpu")
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (rep.rounds, rep.coverage, rep.msgs)
    assert out["meta"]["engine"] == "fused-plain"


def test_cli_runs_several_rumors():
    proc = _port("-m", "gossip_tpu_torch", "run", "--mode", "pull", "--n",
                 str(N), "--engine", "fused", "--rumors", "8", "--device",
                 "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    _, rounds, msgs, cov = jax_mr_replay(N, 8, 0, 1, 0.99, 256, 0.0)
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (rounds, cov, float(msgs))
    assert out["meta"]["layout"] == "one 32-rumor word per node"


@pytest.mark.parametrize("proto,topo,run,fault,match", [
    (ProtocolConfig(mode="push"), TOPO, RunConfig(), None, "pull rounds"),
    (PULL, TopologyConfig(family="ring", n=N), RunConfig(), None,
     "complete"),
    (ProtocolConfig(mode="pull", rumors=33), TOPO, RunConfig(), None,
     "32"),
    (PULL, TOPO, RunConfig(), FaultConfig(node_death_rate=0.1),
     "threefry"),
    (PULL, TOPO, RunConfig(), FaultConfig(churn=object()), "churn"),
    (PULL, TOPO, RunConfig(engine="auto"), None, "engine='fused' only"),
    (PULL, TopologyConfig(n=1 << 31), RunConfig(), None, "2\\^31"),
])
def test_refusals_are_loud(proto, topo, run, fault, match):
    with pytest.raises(ValueError, match=match):
        run_simulation(proto, topo, run, fault, device="cpu")


@pytest.mark.parametrize("args", [
    ["--mode", "push", "--n", "1000", "--engine", "fused"],
    ["--mode", "pull", "--n", "1000", "--engine", "xla"],
    ["--mode", "pull", "--n", "1000", "--engine", "fused", "--seed", "1"],
    ["--mode", "pull", "--n", "1000", "--engine", "fused", "--device",
     "tpu"],
])
def test_cli_refuses_other_flags_and_values(args):
    proc = _port("-m", "gossip_tpu_torch", "run", *args)
    assert proc.returncode == 2 and not proc.stdout


def test_no_card_no_run():
    _no_card()
    for device in (None, "cuda"):
        for proto in (PULL, ProtocolConfig(mode="pull", rumors=8)):
            with pytest.raises(ValueError, match="needs a CUDA device"):
                run_simulation(proto, TOPO, RunConfig(), device=device)
    for flags in ([], ["--device", "cuda"]):
        proc = _port("-m", "gossip_tpu_torch", "run", "--mode", "pull",
                     "--n", str(N), "--engine", "fused", *flags)
        assert proc.returncode != 0 and not proc.stdout
        assert "needs a CUDA device" in proc.stderr


def test_bench_line_and_no_cpu_row(tmp_path):
    rounds, seconds = bench.run_fused(N, "cpu")
    _, want, _, _ = jax_replay(N, 0, 1, 0.99, 256, 0.0)
    assert rounds == want
    line = bench.measurement_line(N, rounds, seconds,
                                  {"name": "card", "power_limit": "1 W"})
    assert tuple(line) == bench.LINE_KEYS and line["backend"] == "cuda"
    assert line["value"] == N * rounds / seconds
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.card_info()
    proc = _port("-m", "gossip_tpu_torch.bench")
    assert proc.returncode != 0 and not proc.stdout
    # chip_smoke.py prints no result without a card, nor alone
    proc = _port(os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0 and not proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0 and not proc.stdout
