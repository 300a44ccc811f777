"""The port's rumor mongering (gossip_tpu_torch/models/rumor.py, its loops
and its run reports) against the JAX package's, bitwise (tolerance 0).

Both packages run the same configuration from the same seed, the port on
the CPU and the reference's round under ``jax.jit``: every field of the
state after every round (seen, hot, cnt, round, key, msgs, and under a
fault program the round's ``lost``) must be equal, for the feedback and
blind counters on the complete graph and on neighbour tables, under
static deaths and drops and under the JAX package's ``churn_heal``
program; so must the loops' coverage, hot fraction and msgs (the curve
path's extinction round included), the run reports and the ``run``
command line.  The reference's own single-device cases (the exact two-node
runs, the blind message bound, the refusals) run on the port too.  The
reference runs live, its executable store off.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.backend import run_simulation as jrun_simulation
from gossip_tpu.models import rumor as JR
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import bench
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.models import rumor as R
from gossip_tpu_torch.models.si import make_si_round
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 400


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _topos(family, n=N):
    if family == "complete":
        return JG.complete(n), G.complete(n)
    if family == "watts_strogatz":
        return (JG.watts_strogatz(n, 6, 0.1, seed=0),
                G.watts_strogatz(n, 6, 0.1, seed=0, device=CPU))
    return (JG.erdos_renyi(n, 0.02, seed=2),
            G.erdos_renyi(n, 0.02, seed=2, device=CPU))


def _heal(n):
    """The JAX package's ``churn_heal`` program in both packages."""
    tf = bench.heal_fault(n)
    ch = tf.churn
    return JC.FaultConfig(drop_prob=tf.drop_prob, seed=tf.seed,
                          churn=JC.ChurnConfig(
                              events=ch.events, partitions=ch.partitions,
                              ramp=ch.ramp)), tf


def _faults(fault, n=N):
    if fault is None:
        return None, None
    if fault == "heal":
        return _heal(n)
    return JC.FaultConfig(**fault), TC.FaultConfig(**fault)


def _assert_same(js, ts):
    for f in ("seen", "hot", "cnt"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.round == int(js.round)
    np.testing.assert_array_equal(
        threefry.key_to_words(ts.base_key),
        np.asarray(jax.random.key_data(js.base_key)))
    assert np.float32(ts.msgs.item()) == np.float32(js.msgs)


def _protos(**kw):
    kw = dict(mode="rumor", **kw)
    return JC.ProtocolConfig(**kw), TC.ProtocolConfig(**kw)


ROUND_CASES = [
    ("feedback", "complete", None, 1),
    ("blind", "complete", None, 1),
    ("feedback", "erdos_renyi", None, 1),
    ("blind", "erdos_renyi", dict(drop_prob=0.1, seed=3), 1),
    ("feedback", "complete", dict(node_death_rate=0.2, drop_prob=0.05,
                                  seed=1), 3),
    ("feedback", "complete", "heal", 1),
    ("blind", "erdos_renyi", "heal", 2),
]


@pytest.mark.parametrize("variant,family,fault,rumors", ROUND_CASES)
def test_round_matches_reference(variant, family, fault, rumors):
    jp, tp = _protos(fanout=2, rumor_k=2, rumor_variant=variant,
                     rumors=rumors)
    jt, tt = _topos(family)
    jf, tf = _faults(fault)
    run = dict(seed=4, origin=5, max_rounds=64)
    jstep = jax.jit(JR.make_rumor_round(jp, jt, jf, origin=5))
    tstep = R.make_rumor_round(tp, tt, tf, origin=5, device=CPU)
    js = JR.init_rumor_state(JC.RunConfig(**run), jp, N)
    ts = R.init_rumor_state(TC.RunConfig(**run), tp, N, CPU)
    _assert_same(js, ts)
    churn = fault == "heal"
    for _ in range(12):
        jo, to = jstep(js), tstep(ts)
        if churn:
            (js, jl), (ts, tl) = jo, to
            assert np.float32(tl.item()) == np.float32(jl)
        else:
            js, ts = jo, to
        _assert_same(js, ts)


@pytest.mark.parametrize("fault", [None, dict(node_death_rate=0.1, seed=2),
                                   "heal"])
def test_loops_match_reference(fault):
    """The until loop's rounds, coverage, residue and msgs, and the curve
    loop's coverage, hot fraction and msgs after every round: without
    deaths a mean, with random deaths a quotient, under the program a
    product with the folded denominator's reciprocal."""
    jp, tp = _protos(fanout=1, rumor_k=2)
    jt, tt = _topos("complete", 1000)
    jf, tf = _faults(fault, 1000)
    jrun, trun = JC.RunConfig(max_rounds=48, seed=3), \
        TC.RunConfig(max_rounds=48, seed=3)
    want = JR.simulate_until_rumor(jp, jt, jrun, jf)
    got = R.simulate_until_rumor(tp, tt, trun, tf, CPU)
    assert got[:4] == (int(want[0]),) + tuple(want[1:4])
    _assert_same(want[4], got[4])
    jc, jh, jm, jfin = JR.simulate_curve_rumor(jp, jt, jrun, jf)
    tcv, th, tm, tfin = R.simulate_curve_rumor(tp, tt, trun, tf, CPU)
    np.testing.assert_array_equal(tcv, np.asarray(jc))
    np.testing.assert_array_equal(th, np.asarray(jh))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    _assert_same(jfin, tfin)
    assert th[-1] == 0.0                     # the wave died out


def test_two_node_runs_are_exact():
    """The reference's exact two-node cases: feedback stops after 3
    rounds and 5 pushes, blind after 3 rounds and 4."""
    for variant, msgs in (("feedback", 5.0), ("blind", 4.0)):
        _, tp = _protos(rumor_k=2, rumor_variant=variant)
        rounds, cov, residue, got, final = R.simulate_until_rumor(
            tp, G.complete(2), TC.RunConfig(max_rounds=256), device=CPU)
        assert (rounds, got, cov, residue) == (3, msgs, 1.0, 0.0)
        assert not bool(final.hot.any())


def test_blind_message_bound_and_tables():
    """Blind at k pushes at most ``k + fanout - 1`` times a pair, and the
    run on a Watts-Strogatz table equals the reference's."""
    n, k, fanout = 4096, 2, 2
    _, tp = _protos(fanout=fanout, rumor_k=k, rumor_variant="blind")
    _, _, _, msgs, _ = R.simulate_until_rumor(
        tp, G.complete(n), TC.RunConfig(), device=CPU)
    assert msgs <= n * (k + fanout - 1)
    jp, tp = _protos(fanout=2, rumor_k=3)
    jt, tt = _topos("watts_strogatz", 2048)
    want = JR.simulate_until_rumor(jp, jt, JC.RunConfig())
    got = R.simulate_until_rumor(tp, tt, TC.RunConfig(), device=CPU)
    assert got[:4] == (int(want[0]),) + tuple(want[1:4])


TIMING = {"compile_s", "build_s", "steady_wall_s", "driver_overhead_s",
          "topo_build_s", "device", "launches"}


@pytest.mark.parametrize("proto,family,fault,curve", [
    (dict(rumor_k=2), "complete", None, False),
    (dict(rumor_k=2, rumor_variant="blind"), "complete", None, True),
    (dict(rumor_k=2), "complete", "heal", False),
    (dict(rumor_k=2), "complete", "heal", True),
    (dict(rumor_k=3, fanout=2), "erdos_renyi",
     dict(node_death_rate=0.1, drop_prob=0.05, seed=2), True),
])
def test_run_simulation_matches_reference(proto, family, fault, curve):
    """RM1-RM3 of the JAX package's rumor runs at 3000 nodes, on the
    until and the curve paths, and a table under static faults."""
    n = 3000
    jf, tf = _faults(fault, n)
    kw = dict(mode="rumor", fanout=proto.pop("fanout", 1), **proto)
    tk = dict(family=family, n=n, p=0.004, seed=2)
    rk = dict(engine="auto", seed=3, max_rounds=60)
    port = run_simulation(TC.ProtocolConfig(**kw), TC.TopologyConfig(**tk),
                          TC.RunConfig(**rk), tf, want_curve=curve,
                          device="cpu")
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**kw),
                          JC.TopologyConfig(**tk), JC.RunConfig(**rk), jf,
                          want_curve=curve)
    assert (port.rounds, port.coverage, port.msgs, port.curve) == \
        (ref.rounds, ref.coverage, ref.msgs, ref.curve)
    strip = lambda m: {k: v for k, v in m.items() if k not in TIMING}
    assert strip(port.meta) == strip(ref.meta)
    assert port.meta["terminated"] and port.rounds > 0


def test_refusals_match_reference():
    _, tp = _protos()
    with pytest.raises(ValueError, match="pull rounds only"):
        run_simulation(tp, TC.TopologyConfig(n=1024),
                       TC.RunConfig(engine="fused"), device="cpu")
    with pytest.raises(ValueError, match="rumor"):
        make_si_round(tp, G.complete(64), device=CPU)
    with pytest.raises(ValueError, match="mode='rumor'"):
        R.make_rumor_round(TC.ProtocolConfig(mode="push"), G.complete(64),
                           device=CPU)
    # the fused rumor planes on two devices refuse rumor mongering in
    # the reference's words, as the single-device fused route does
    with pytest.raises(ValueError, match="pull rounds only"):
        run_simulation(tp, TC.TopologyConfig(n=1024), TC.RunConfig(),
                       mesh_cfg=TC.MeshConfig(n_devices=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            run_simulation(tp, TC.TopologyConfig(n=1024),
                           TC.RunConfig(engine="auto"))


def _port_cli(args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "gossip_tpu_torch", "run",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)


def test_cli_runs_the_churn_program_as_the_reference(capsys):
    """RM3's command line (the JAX package's spelling: ``--drop``, no
    ``--engine``) at 2000 nodes, the cut at n / 2, through ``python -m
    gossip_tpu_torch run --device cpu`` and the reference's ``run``."""
    from gossip_tpu.cli import main as jmain
    args = ["--mode", "rumor", "--n", "2000", "--fanout", "1", "--rumor-k",
            "2", "--rumor-variant", "feedback", "--max-rounds", "128",
            "--drop", "0.02", "--churn-event", "1:1:4", "--churn-event",
            "2:2", "--partition", "0:6:1000", "--drop-ramp", "0:4:0:0.1"]
    proc = _port_cli([*args, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert jmain(["run", *args]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (port["rounds"], port["coverage"], port["msgs"]) == \
        (ref["rounds"], ref["coverage"], ref["msgs"])
    assert {k: port["meta"][k] for k in ref["meta"] if k not in TIMING} == \
        {k: v for k, v in ref["meta"].items() if k not in TIMING}


def test_cli_refuses_swim_partitions():
    proc = _port_cli(["--mode", "swim", "--n", "200", "--partition",
                      "0:4:100", "--device", "cpu"])
    assert proc.returncode == 2 and not proc.stdout
    assert "cannot honor partition windows" in proc.stderr

