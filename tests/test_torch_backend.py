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

import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.backend import RunReport as JRunReport
from gossip_tpu.backend import run_simulation as jrun_simulation
from gossip_tpu.models.si_packed import simulate_until_packed
from gossip_tpu.ops import pallas_round as J
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import bench
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.config import (ChurnConfig, FaultConfig, LogConfig,
                                     MeshConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from _torch_reference import (as_u32, jax_mr_replay, jax_replay,
                              report_coverage)

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
    tables, rounds, msgs, _ = jax_replay(N, 4, 1, 0.99, 256, drop_prob)
    cov = report_coverage(tables[-1], N)
    assert (rep.rounds, rep.coverage, rep.msgs) == (rounds, cov, float(msgs))
    out = rep.to_dict()
    assert set(out) == {f.name for f in dataclasses.fields(JRunReport)}
    assert out["meta"]["layout"] == "node-packed bitmap"
    assert out["meta"]["engine"] == "fused-plain"
    assert out["backend"] == "torch-cpu"
    assert out["meta"]["launches"] == {"fused_round": 0, "fused_mr_round": 0,
                                       "mr_gather": 0, "sampler": 0}


@pytest.mark.parametrize("fanout,drop_prob", [(1, 0.0), (2, 0.05)])
def test_multirumor_run_matches_reference(fanout, drop_prob):
    fault = FaultConfig(drop_prob=drop_prob) if drop_prob else None
    rep = run_simulation(ProtocolConfig(mode="pull", fanout=fanout,
                                        rumors=8),
                         TOPO, RunConfig(seed=4), fault, device="cpu")
    tables, rounds, msgs, cov = jax_mr_replay(N, 8, 4, fanout, 0.99, 256,
                                              drop_prob)
    assert (rep.rounds, rep.coverage, rep.msgs) == \
        (rounds, report_coverage(tables[-1], N, 8), float(msgs))
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
    tables, rounds, msgs, _ = jax_mr_replay(N, 8, 0, 1, 0.99, 256, 0.0)
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (rounds, report_coverage(tables[-1], N, 8), float(msgs))
    assert out["meta"]["layout"] == "one 32-rumor word per node"


@pytest.mark.parametrize("proto,topo,run,fault,match", [
    (ProtocolConfig(mode="push"), TOPO, RunConfig(), None, "pull rounds"),
    (PULL, TopologyConfig(family="ring", n=N), RunConfig(), None,
     "complete"),
    (ProtocolConfig(mode="pull", rumors=33), TOPO, RunConfig(), None,
     "32"),
    (ProtocolConfig(mode="swim"), TOPO, RunConfig(engine="xla"),
     FaultConfig(churn=ChurnConfig(partitions=((0, 4, N // 2),))),
     "cannot honor partition windows"),
    (PULL, TOPO, RunConfig(),
     FaultConfig(churn=ChurnConfig(events=((1, 1, 4),))), "churn"),
    (PULL, TOPO, RunConfig(engine="native"), None,
     "^engine='native' is the go-native backend's C\\+\\+ event core; "
     "jax-tpu engines are auto\\|xla\\|fused \\(use --backend "
     "go-native\\)$"),
    (PULL, TopologyConfig(n=1 << 31), RunConfig(), None, "2\\^31"),
])
def test_refusals_are_loud(proto, topo, run, fault, match):
    with pytest.raises(ValueError, match=match):
        run_simulation(proto, topo, run, fault, device="cpu")


@pytest.mark.parametrize("plane_stack", [False, True])
def test_fused_churn_refusal_is_the_reference_word_for_word(plane_stack):
    """The single-device fused route refuses a fault program in the
    reference's words (its list of plane surfaces with ``--checkpoint``),
    and ``plane_stack`` (``run --engine fused --checkpoint``,
    ``churn-sweep --engine fused``) takes it on one device, as the
    reference's does."""
    from gossip_tpu.backend import _fused_ineligible_reason
    from gossip_tpu_torch.backend import fused_ineligible_reason
    churn = dict(events=((1, 1, 4),), partitions=((0, 3, N // 2),))
    jf = JC.FaultConfig(churn=JC.ChurnConfig(**churn))
    tf = FaultConfig(churn=ChurnConfig(**churn))
    want = _fused_ineligible_reason(JC.ProtocolConfig(mode="pull"),
                                    JC.TopologyConfig(n=N), jf, 1,
                                    plane_stack=plane_stack)
    got = fused_ineligible_reason(PULL, TOPO, RunConfig(), tf, 1,
                                  plane_stack=plane_stack)
    if plane_stack:
        # the reference's one reason left is its device check ("needs a
        # TPU"), which the port's list leaves to the device it runs on
        assert got is None and "needs a TPU" in want
    else:
        assert got == want
        assert "(--devices > 1, --checkpoint, churn-sweep" in got


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_cfg=MeshConfig(n_devices=2, exchange="sparse")),
     "engine='fused'.*implements no exchange"),
    (dict(mesh_cfg=MeshConfig(exchange="sparse")),
     "needs n_devices > 1"),
    (dict(log_cfg=LogConfig(), txn_cfg=object()), "at most one payload"),
    (dict(txn_cfg=object(), mesh_cfg=MeshConfig()),
     "single-process single-device"),
])
def test_later_slices_are_refused(kw, match):
    """Refused on every engine, in the reference's words; a sparse
    exchange on two devices only on the fused engine, which implements
    no exchange (xla and auto run it:
    ``test_sparse_exchange_runs_on_a_mesh``)."""
    mesh = kw.get("mesh_cfg")
    two = mesh is not None and mesh.n_devices > 1
    for engine in ("fused",) if two else ("xla", "auto", "fused"):
        with pytest.raises(ValueError, match=match):
            run_simulation(PULL, TOPO, RunConfig(engine=engine), device="cpu",
                           **kw)


@pytest.mark.parametrize("engine", ["xla", "auto"])
def test_sparse_exchange_runs_on_a_mesh(engine):
    """``run_simulation(mesh_cfg=MeshConfig(2, exchange='sparse'))`` on
    the xla and auto engines runs the sparse all_to_all exchange on two
    gloo ranks and returns the reference's report values and its meta
    keys (the exchange and its bytes a round), with no kernel launched
    on either rank."""
    kw = dict(mode="pull", rumors=3)
    port = run_simulation(ProtocolConfig(**kw), TopologyConfig(n=1000),
                          RunConfig(seed=5, engine=engine), device="cpu",
                          mesh_cfg=MeshConfig(n_devices=2,
                                              exchange="sparse"))
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**kw),
                          JC.TopologyConfig(n=1000),
                          JC.RunConfig(seed=5, engine=engine), None,
                          JC.MeshConfig(n_devices=2, exchange="sparse"))
    assert (port.rounds, port.coverage, port.msgs) == \
        (ref.rounds, ref.coverage, ref.msgs)
    for key in ("exchange", "ici_bytes_per_round", "devices"):
        assert port.meta[key] == ref.meta[key]
    assert "all_to_all" in port.meta["collective_ms"]
    # no kernel of the port on either rank: the exchange draws by threefry
    assert [sum(r.values()) for r in port.meta["rank_launches"]] == [0, 0]


@pytest.mark.parametrize("args", [
    ["--mode", "swim", "--n", "1000", "--devices", "2", "--exchange",
     "sparse", "--device", "cpu"],
    ["--mode", "pull", "--n", "1000", "--engine", "native"],
    ["--mode", "pull", "--n", "1000", "--engine", "xla", "--devices", "2",
     "--exchange", "halo", "--device", "cpu"],
    ["--mode", "pull", "--n", "1000", "--engine", "fused", "--device",
     "tpu"],
])
def test_cli_refuses_other_flags_and_values(args):
    proc = _port("-m", "gossip_tpu_torch", "run", *args)
    assert proc.returncode == 2 and not proc.stdout


@pytest.mark.parametrize("args", [
    ["--mode", "swim", "--n", "1000", "--devices", "2", "--exchange",
     "sparse"],
    ["--mode", "pull", "--n", "1000", "--engine", "xla", "--devices", "2",
     "--exchange", "halo"],
])
def test_cli_exchange_refusals_match_reference(capsys, args):
    """SWIM on the sparse exchange and the halo exchange on the complete
    graph exit 2 with the reference command's message, word for word."""
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli
    capsys.readouterr()
    assert jcli.main(["run", *args, "--no-compile-cache"]) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(["run", *args, "--device", "cpu"]) == 2
    got = capsys.readouterr()
    assert got.err.strip().splitlines()[-1] == want and not got.out


def test_halo_exchange_runs_on_a_ring():
    """``run_simulation(mesh_cfg=MeshConfig(2, exchange='halo'))`` on a
    ring runs the halo exchange on two gloo ranks: the reference's report
    values (the single-device trajectory) and its ``band``, with no
    kernel launched on either rank."""
    kw = dict(mode="pushpull", fanout=2)
    tc = dict(family="ring", n=1000, k=6)
    port = run_simulation(ProtocolConfig(**kw), TopologyConfig(**tc),
                          RunConfig(seed=5, max_rounds=30, engine="auto"),
                          device="cpu",
                          mesh_cfg=MeshConfig(n_devices=2, exchange="halo"))
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**kw),
                          JC.TopologyConfig(**tc),
                          JC.RunConfig(seed=5, max_rounds=30, engine="auto"),
                          None, JC.MeshConfig(n_devices=2, exchange="halo"))
    assert (port.rounds, port.coverage, port.msgs) == \
        (ref.rounds, ref.coverage, ref.msgs)
    assert (port.meta["exchange"], port.meta["band"]) == ("halo", 3) == \
        (ref.meta["exchange"], ref.meta["band"])
    assert "ppermute" in port.meta["collective_ms"]
    assert [sum(r.values()) for r in port.meta["rank_launches"]] == [0, 0]


def _both(mode, family="complete", engine="xla", fault=None, n=3000,
          curve=False, **proto):
    """The port's and the reference's report for one configuration."""
    kw = dict(mode=mode, fanout=proto.pop("fanout", 1), **proto)
    tk = dict(family=family, n=n, k=4, p=0.004, seed=2)
    rk = dict(engine=engine, seed=3, max_rounds=40)
    port = run_simulation(
        ProtocolConfig(**kw), TopologyConfig(**tk), RunConfig(**rk),
        None if fault is None else FaultConfig(**fault), want_curve=curve,
        device="cpu")
    ref = jrun_simulation(
        "jax-tpu", JC.ProtocolConfig(**kw), JC.TopologyConfig(**tk),
        JC.RunConfig(**rk),
        None if fault is None else JC.FaultConfig(**fault),
        want_curve=curve)
    return port, ref


FAULT = dict(node_death_rate=0.1, drop_prob=0.05, seed=2)


@pytest.mark.parametrize("mode,family,engine,fault,curve,proto", [
    ("pull", "complete", "xla", None, False, {}),
    ("pull", "complete", "xla", FAULT, False, {"rumors": 33}),
    ("antientropy", "complete", "auto", None, False, {"period": 2}),
    ("antientropy", "watts_strogatz", "xla", FAULT, False, {}),
    ("push", "complete", "xla", None, False, {"fanout": 2}),
    ("push", "erdos_renyi", "auto", FAULT, False, {}),
    ("pull", "complete", "xla", None, True, {}),
    ("pushpull", "erdos_renyi", "auto", None, True, {"rumors": 2}),
    ("pull", "ring", "auto", None, False, {}),
])
def test_xla_engine_matches_reference(mode, family, engine, fault, curve,
                                      proto):
    port, ref = _both(mode, family, engine, fault, curve=curve, **proto)
    assert (port.rounds, port.coverage, port.msgs) == (ref.rounds,
                                                       ref.coverage,
                                                       ref.msgs)
    assert port.curve == ref.curve
    assert port.meta.get("engine") == ref.meta.get("engine")
    assert "engine_auto" not in port.meta and "engine_auto" not in ref.meta
    assert set(ref.meta) - set(port.meta) <= {"compile_s"}
    assert port.backend == "torch-cpu" and set(port.meta["launches"]
                                               .values()) == {0}


def test_auto_takes_the_fused_route_where_eligible():
    """Eligible means the configuration and a CUDA device, where the
    hand-written kernel runs, as the reference's ``auto`` takes its
    fused route only where its Pallas kernel runs.  On the CPU ``auto``
    is the xla engine with the reference's values and no
    ``engine_auto``; an explicit ``fused`` there is the plain route."""
    fault = FaultConfig(node_death_rate=0.1)
    rep = run_simulation(PULL, TOPO, RunConfig(engine="auto", seed=4),
                         fault, device="cpu")
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(mode="pull"),
                          JC.TopologyConfig(n=N),
                          JC.RunConfig(engine="auto", seed=4),
                          JC.FaultConfig(node_death_rate=0.1))
    assert (rep.rounds, rep.coverage, rep.msgs) == \
        (ref.rounds, ref.coverage, ref.msgs)
    assert rep.meta["engine"] == ref.meta["engine"] == "bit-packed"
    assert "engine_auto" not in rep.meta and "engine_auto" not in ref.meta
    fused = run_simulation(PULL, TOPO, RunConfig(engine="fused", seed=4),
                           fault, device="cpu")
    assert fused.meta["engine"] == "fused-plain"
    assert "engine_auto" not in fused.meta


@pytest.mark.parametrize("flags,want", [
    (["--mode", "pull", "--n", "100000"],
     (19, 0.9994999766349792, 3800000.0)),
    (["--mode", "pull", "--n", "5000", "--rumors", "7", "--fanout", "3",
      "--seed", "9"], (8, 0.9997999668121338, 240000.0)),
])
def test_cli_default_engine_on_the_cpu_is_the_references(capsys, flags,
                                                         want):
    """``run`` with the default ``--engine auto`` on the CPU prints the
    reference command's rounds, coverage and msgs on the xla engine
    (``bit-packed``); ``--engine fused`` takes the plain fused route."""
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli
    capsys.readouterr()
    assert jcli.main(["run", *flags, "--no-compile-cache"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["run", *flags, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["rounds"], got["coverage"], got["msgs"]) == want == \
        (ref["rounds"], ref["coverage"], ref["msgs"])
    assert got["meta"]["engine"] == ref["meta"]["engine"] == "bit-packed"
    assert "engine_auto" not in got["meta"]
    assert cli.main(["run", *flags, "--engine", "fused", "--device",
                     "cpu"]) == 0
    fused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fused["meta"]["engine"] == "fused-plain"


@pytest.mark.parametrize("rumors", [1, 8])
def test_fused_deaths_match_reference(rumors):
    """node_death_rate on the fused route: the alive tables equal the
    reference's renderings, and the loop equals the reference's round
    replayed on the port's bits with the reference's alive operand."""
    fault = FaultConfig(node_death_rate=0.1)
    jfault = JC.FaultConfig(node_death_rate=0.1)
    # the multi-rumor origins 6..13 are alive under this draw (node 1 is
    # dead: a rumor starting there could never spread)
    origin = 0 if rumors == 1 else 6
    if rumors == 1:
        want, _ = J.fault_masks_node_packed(jfault, N)
        got, _ = FR.fault_masks_node_packed(fault, N, device="cpu")
        _, rounds, msgs, cov = jax_replay(N, 4, 1, 0.99, 256, 0.05, 0.1)
    else:
        want, _ = J.fault_masks_word(jfault, N)
        got, _ = MR.fault_masks_word(fault, N, device="cpu")
        _, rounds, msgs, cov = jax_mr_replay(N, rumors, 4, 1, 0.99, 256,
                                             0.05, 0.1, origin)
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    proto = ProtocolConfig(mode="pull", rumors=rumors)
    faults = FaultConfig(node_death_rate=0.1, drop_prob=0.05)
    rep = run_simulation(proto, TOPO, RunConfig(seed=4, origin=origin),
                         faults, device="cpu")
    assert cov >= np.float32(0.99)
    assert (rep.rounds, rep.coverage, rep.msgs) == (rounds, cov,
                                                    float(msgs))
    curve = run_simulation(proto, TOPO,
                           RunConfig(seed=4, origin=origin,
                                     max_rounds=rounds),
                           faults, want_curve=True, device="cpu")
    assert curve.rounds == rounds and curve.curve[-1] == cov


def test_cli_runs_the_xla_engine():
    flags = ["--mode", "antientropy", "--n", "2000", "--engine", "xla",
             "--family", "erdos_renyi", "--p", "0.005", "--period", "2",
             "--seed", "3", "--origin", "5", "--target", "0.95",
             "--max-rounds", "30", "--death", "0.1", "--drop-prob", "0.05",
             "--fanout", "2", "--device", "cpu"]
    proc = _port("-m", "gossip_tpu_torch", "run", *flags)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = jrun_simulation(
        "jax-tpu", JC.ProtocolConfig(mode="antientropy", fanout=2, period=2),
        JC.TopologyConfig(family="erdos_renyi", n=2000, p=0.005, seed=3),
        JC.RunConfig(target_coverage=0.95, max_rounds=30, seed=3, origin=5,
                     engine="xla"),
        JC.FaultConfig(node_death_rate=0.1, drop_prob=0.05, seed=3))
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (ref.rounds, ref.coverage, ref.msgs)
    assert out["meta"]["engine"] == "bit-packed"
    proc = _port("-m", "gossip_tpu_torch", "run", "--mode", "flood", "--n",
                 "500", "--engine", "auto", "--family", "grid", "--curve",
                 "--max-rounds", "5", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert len(json.loads(proc.stdout.strip().splitlines()[-1])["curve"]) \
        == 5


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
    # the XLA engine's packed loop: the reference's rounds, and the
    # kernel sampler's within two of them
    rounds, _ = bench.run_xla_packed(N, "cpu")
    want, _, _, _ = simulate_until_packed(
        JC.ProtocolConfig(mode="pull"), JG.complete(N),
        JC.RunConfig(max_rounds=128))
    assert rounds == want
    kernel_rounds, _ = bench.run_xla_packed(N, "cpu", "kernel")
    assert abs(kernel_rounds - want) <= 2
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


# -- the node mesh --------------------------------------------------------

def test_cli_runs_devices_on_gloo():
    """``run --devices 2 --device cpu`` end to end: two spawned gloo ranks
    of the packed sharded driver print the JAX package's values for the
    same command on its 2-device mesh."""
    flags = ["--mode", "pull", "--n", "3001", "--rumors", "3", "--engine",
             "xla", "--seed", "4", "--drop", "0.05"]
    proc = _port("-m", "gossip_tpu_torch", "run", "--devices", "2",
                 "--device", "cpu", *flags)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = jrun_simulation(
        "jax-tpu", JC.ProtocolConfig(mode="pull", rumors=3),
        JC.TopologyConfig(n=3001, seed=4),
        JC.RunConfig(seed=4, engine="xla"),
        JC.FaultConfig(drop_prob=0.05, seed=4), JC.MeshConfig(n_devices=2))
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (ref.rounds, ref.coverage, ref.msgs)
    meta = out["meta"]
    assert (meta["devices"], meta["engine"], meta["process_group"]) == \
        (2, "bit-packed", "gloo")
    assert meta["coverage_total"] == 3001
    assert meta["collective_ms"]["all_gather"]["calls"] >= out["rounds"]


@pytest.mark.parametrize("k", [2, 4])
def test_run_simulation_on_a_mesh(k):
    """``run_simulation(mesh_cfg=MeshConfig(n_devices=K))`` spawns K gloo
    ranks of the dense driver (push-pull with a curve) and returns the
    reference's report values."""
    kw = dict(mode="pushpull", fanout=2, rumors=2)
    port = run_simulation(ProtocolConfig(**kw), TopologyConfig(n=1001),
                          RunConfig(seed=7, max_rounds=14, engine="auto"),
                          want_curve=True, device="cpu",
                          mesh_cfg=MeshConfig(n_devices=k))
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**kw),
                          JC.TopologyConfig(n=1001),
                          JC.RunConfig(seed=7, max_rounds=14, engine="auto"),
                          None, JC.MeshConfig(n_devices=k), want_curve=True)
    assert (port.rounds, port.coverage, port.msgs, port.curve) == \
        (ref.rounds, ref.coverage, ref.msgs, ref.curve)
    assert port.meta["devices"] == ref.meta["devices"] == k
    assert "engine" not in port.meta


@pytest.mark.parametrize("proto,kw,match", [
    (ProtocolConfig(mode="swim"), {}, None),
    (ProtocolConfig(mode="rumor"), {}, None),
    (PULL, dict(log_cfg=LogConfig()), "single-process single-device"),
    (ProtocolConfig(mode="push"), dict(run=RunConfig(engine="fused")),
     "implements pull rounds only"),
    (PULL, dict(exchange="halo"), "needs an explicit neighbor table"),
    (ProtocolConfig(mode="swim"), dict(exchange="sparse"),
     "not implemented for swim"),
])
def test_mesh_refusals_name_their_item(proto, kw, match):
    """What the reference refuses on a mesh is refused in its words (the
    log workload: it shards through the library API; the fused rumor
    planes on push rounds; the halo exchange on the implicit complete
    graph; SWIM on the sparse exchange), before any rank is spawned; SWIM and rumor mongering
    (``match`` None) run on two gloo ranks and answer as the reference's
    sharded drivers on its 2-device mesh."""
    mesh = MeshConfig(n_devices=2, exchange=kw.pop("exchange", "dense"))
    run = kw.pop("run", RunConfig(engine="xla"))
    if match is not None:
        with pytest.raises(ValueError, match=match):
            run_simulation(proto, TopologyConfig(n=256), run, device="cpu",
                           mesh_cfg=mesh, **kw)
        return
    port = run_simulation(proto, TopologyConfig(n=256), run, device="cpu",
                          mesh_cfg=mesh)
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(mode=proto.mode),
                          JC.TopologyConfig(n=256),
                          JC.RunConfig(engine="xla"), None,
                          JC.MeshConfig(n_devices=2))
    assert (port.rounds, port.coverage, port.msgs) == \
        (ref.rounds, ref.coverage, ref.msgs)
    same = {k: v for k, v in ref.meta.items()
            if not k.endswith("_s") and k != "compile_cache"}
    assert {k: port.meta[k] for k in same} == same
    assert port.meta["devices"] == 2 and port.meta["process_group"] == "gloo"


@pytest.mark.parametrize("args", [
    ["--mode", "swim", "--n", "500", "--family", "power_law", "--k", "3",
     "--degree-cap", "64", "--fanout", "2", "--swim-suspect-rounds", "24",
     "--max-rounds", "40"],
    ["--mode", "rumor", "--n", "3001", "--rumor-k", "2", "--curve",
     "--max-rounds", "30"],
])
def test_cli_swim_and_rumor_on_a_mesh(args):
    """``python -m gossip_tpu_torch run --mode swim|rumor --devices 2
    --device cpu`` exits 0 and prints the JAX package's values for the
    same command on its 2-device mesh."""
    proc = _port("-m", "gossip_tpu_torch", "run", *args, "--devices", "2",
                 "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jp = dict(mode=args[1], fanout=2 if args[1] == "swim" else 1)
    if args[1] == "swim":
        jp.update(swim_suspect_rounds=24)
        tc = JC.TopologyConfig(family="power_law", n=500, k=3,
                               degree_cap=64)
        run = JC.RunConfig(max_rounds=40)
    else:
        jp.update(rumor_k=2)
        tc, run = JC.TopologyConfig(n=3001), JC.RunConfig(max_rounds=30)
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**jp), tc, run,
                          None, JC.MeshConfig(n_devices=2),
                          want_curve="--curve" in args)
    assert (out["rounds"], out["coverage"], out["msgs"], out["curve"]) == \
        (ref.rounds, ref.coverage, ref.msgs, ref.curve)
    assert out["meta"]["devices"] == 2


def test_more_ranks_than_cards_are_refused(monkeypatch):
    """On CUDA each rank takes a card of its own (NCCL): more ranks than
    cards are refused in the reference's words, unless the ranks share
    one card under gloo; the CPU takes any number of gloo ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                                         "available"):
        GR.plan(2, "cuda")
    with pytest.raises(ValueError, match="requested 4 devices, only 1 "
                                         "available"):
        run_simulation(PULL, TopologyConfig(n=256), RunConfig(engine="xla"),
                       mesh_cfg=MeshConfig(n_devices=4))
    assert GR.plan(1, "cuda") == ("nccl", [torch.device("cuda", 0)])
    assert GR.plan(2, "cuda", shared_card=True) == \
        ("gloo", [torch.device("cuda", 0)] * 2)
    assert GR.plan(3, "cpu") == ("gloo", [torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        MeshConfig(n_devices=0)


def test_cli_save_curve(tmp_path):
    """``run --save-curve PATH`` writes the reference's JSONL (the report
    as its meta line, one row a round) and, without ``--curve``, prints
    no curve."""
    path = tmp_path / "curve.jsonl"
    proc = _port("-m", "gossip_tpu_torch", "run", "--mode", "push", "--n",
                 "500", "--engine", "xla", "--max-rounds", "9",
                 "--save-curve", str(path), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["curve"] is None
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0]["meta"]["rounds"] == out["rounds"]
    assert "curve" not in rows[0]["meta"]
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(mode="push"),
                          JC.TopologyConfig(n=500),
                          JC.RunConfig(max_rounds=9, engine="xla"),
                          want_curve=True)
    assert [r["coverage"] for r in rows[1:]] == ref.curve
    assert [r["round"] for r in rows[1:]] == list(range(1, 10))
