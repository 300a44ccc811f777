"""The port's SWIM failure detection (gossip_tpu_torch/models/swim.py, its
loops and its run reports) against the JAX package's, bitwise
(tolerance 0).

Both packages run the same configuration from the same seed, the port on
the CPU and the reference's round under ``jax.jit``: every field of the
state after every round (wire, timer, round, key, msgs) must be equal,
on the complete graph and on power-law and Erdos-Renyi tables, for each
dissemination lowering (scatter, sort, pack) and both rngs (split, and
packed with and without drops), under scripted and static deaths, a
rotating window and a churn program with a drop ramp.  The draws are
pinned one by one against ``jax.random`` (a scalar ``randint`` per node
key, proxies on ``[0, n)``, ``bits`` of odd widths, both coin
thresholds), and the detection quotient at an ulp-boundary count against
the reference's compiled condition.  The reference runs live, its
executable store off.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.backend import run_simulation as jrun_simulation
from gossip_tpu.backend import swim_scenario as j_swim_scenario
from gossip_tpu.models import swim as JSW
from gossip_tpu.runtime import simulator as JS
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.backend import run_simulation, swim_scenario
from gossip_tpu_torch.models import swim as SW
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 240
PROTO = dict(mode="swim", fanout=2, swim_proxies=2, swim_suspect_rounds=4,
             swim_subjects=4)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _topos(family, n=N):
    if family == "complete":
        return None, None
    if family == "power_law":
        return (JG.power_law(n, 3, seed=1, degree_cap=16),
                G.power_law(n, 3, seed=1, degree_cap=16, device=CPU))
    return (JG.erdos_renyi(n, 0.05, seed=6),
            G.erdos_renyi(n, 0.05, seed=6, device=CPU))


def _faults(fault):
    if fault is None:
        return None, None
    return JC.FaultConfig(**fault), TC.FaultConfig(**fault)


def _assert_same(js, ts):
    np.testing.assert_array_equal(ts.wire.numpy(), np.asarray(js.wire))
    np.testing.assert_array_equal(ts.timer.numpy(), np.asarray(js.timer))
    assert ts.round == int(js.round)
    np.testing.assert_array_equal(
        threefry.key_to_words(ts.base_key),
        np.asarray(jax.random.key_data(js.base_key)))
    assert np.float32(ts.msgs.item()) == np.float32(js.msgs)


def _trajectories(proto, rounds, n=N, dead=(), fail_round=0, fault=None,
                  family="complete", max_rounds=None, seed=9):
    """Both rounds from both initial states for ``rounds`` rounds, the
    states compared after each; returns the final pair."""
    jt, tt = _topos(family, n)
    jf, tf = _faults(fault)
    jstep = jax.jit(JSW.make_swim_round(JC.ProtocolConfig(**proto), n, dead,
                                        fail_round, jf, jt,
                                        max_rounds=max_rounds))
    tstep = SW.make_swim_round(TC.ProtocolConfig(**proto), n, dead,
                               fail_round, tf, tt, max_rounds=max_rounds,
                               device=CPU)
    js = JSW.init_swim_state(n, proto["swim_subjects"], seed)
    ts = SW.init_swim_state(n, proto["swim_subjects"], seed, CPU)
    _assert_same(js, ts)
    for _ in range(rounds):
        js, ts = jstep(js), tstep(ts)
        _assert_same(js, ts)
    return js, ts


# -- the configuration and the helpers ------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(swim_subjects=0), "swim_subjects"),
    (dict(swim_epoch_rounds=-1), "swim_epoch_rounds"),
    (dict(swim_diss="tree"), "swim_diss"),
    (dict(swim_rng="philox"), "swim_rng"),
    (dict(rumor_k=0), "rumor_k"),
    (dict(rumor_variant="lazy"), "rumor_variant"),
])
def test_protocol_config_checks_match_reference(kw, match):
    msgs = []
    for cfg in (JC.ProtocolConfig, TC.ProtocolConfig):
        with pytest.raises(ValueError, match=match) as e:
            cfg(mode="swim", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_config_defaults_match_reference():
    fields = ("swim_proxies", "swim_suspect_rounds", "swim_subjects",
              "swim_rotate", "swim_epoch_rounds", "swim_diss", "swim_rng",
              "rumor_k", "rumor_variant")
    j, t = JC.ProtocolConfig(), TC.ProtocolConfig()
    assert [getattr(j, f) for f in fields] == [getattr(t, f) for f in fields]
    jf = JC.FaultConfig(dead_nodes=[3, 1], fail_round=2)
    tf = TC.FaultConfig(dead_nodes=[3, 1], fail_round=2)
    assert (tf.dead_nodes, tf.fail_round) == (jf.dead_nodes, jf.fail_round)
    for kw, match in ((dict(dead_nodes=(-1,)), "dead_nodes"),
                      (dict(fail_round=-1), "fail_round")):
        for cfg in (JC.FaultConfig, TC.FaultConfig):
            with pytest.raises(ValueError, match=match):
                cfg(**kw)


def test_helpers_match_reference():
    for n in (2, 3, 96, 1000, 1_000_000, 10_000_000):
        for fanout in (1, 2, 3):
            assert SW.suggested_suspect_rounds(n, fanout) == \
                JSW.suggested_suspect_rounds(n, fanout)
            assert SW.suggested_epoch_rounds(n, fanout, 7) == \
                JSW.suggested_epoch_rounds(n, fanout, 7)
    for m in (None, 0, 12, 125, 126, 200, 32765, 32766):
        assert SW.pack_width(m) == JSW.pack_width(m)
        for impl in ("scatter", "sort", "pack"):
            assert SW.effective_diss(impl, m) == JSW.effective_diss(impl, m)
    rot = dict(PROTO, swim_rotate=True, swim_subjects=8)
    for n in (50, 96):
        e = SW.resolve_epoch_rounds(TC.ProtocolConfig(**rot), n)
        assert e == JSW.resolve_epoch_rounds(JC.ProtocolConfig(**rot), n)
        for r in (0, 1, e - 1, e, 3 * e + 2, 40 * e):
            for rotate in (False, True):
                np.testing.assert_array_equal(
                    SW.subject_window(r, 8, n, rotate, e).numpy(),
                    np.asarray(JSW.subject_window(r, 8, n, rotate, e)))
    wire = torch.tensor([[0, 1, 2, 5, SW.DEAD_WIRE]], dtype=torch.int32)
    np.testing.assert_array_equal(
        SW.decode_status(wire).numpy(),
        np.asarray(JSW.decode_status(jnp.asarray(wire.numpy()))))


@pytest.mark.parametrize("fault", [
    None,
    dict(node_death_rate=0.2, seed=4),
    dict(churn=dict(events=((5, 1, 4), (9, 2, -1)))),
    dict(node_death_rate=0.1, seed=1, dead_nodes=(3,),
         churn=dict(events=((7, 0, -1),))),
])
def test_scenario_masks_match_reference(fault):
    jf, tf = _faults(fault)
    dead = (2, 11)
    np.testing.assert_array_equal(SW.base_alive(N, dead, tf, CPU).numpy(),
                                  np.asarray(JSW.base_alive(N, dead, jf)))
    np.testing.assert_array_equal(
        SW.observer_alive(N, dead, tf, CPU).numpy(),
        np.asarray(JSW.observer_alive(N, dead, jf)))
    assert SW.detection_targets(dead, tf) == JSW.detection_targets(dead, jf)
    proto = dict(PROTO, swim_subjects=16)
    assert swim_scenario(TC.ProtocolConfig(**proto), N, tf) == \
        j_swim_scenario(JC.ProtocolConfig(**proto), N, jf)


# -- the draws ---------------------------------------------------------------

def _keys(seed=3, round_=5):
    return (jax.random.fold_in(jax.random.key(seed), round_),
            threefry.fold_in(threefry.key(seed, CPU), round_))


@pytest.mark.parametrize("n,s_count,proxies,drop", [
    (97, 4, 2, 0.0),           # proxies below 2^16: both randint words
    (70_001, 8, 3, 0.15),      # above 2^16: the lower word alone
    (300, 5, 1, "ramp"),       # a traced float32 probability
])
def test_split_draws_match_jax_random(n, s_count, proxies, drop):
    jk, tk = _keys()
    m = 257
    gids_j = jnp.arange(m, dtype=jnp.int32) * 3
    gids_t = torch.arange(m, dtype=torch.int64) * 3
    force = drop == "ramp"
    jp = jnp.float32(0.3) if force else drop
    tp = torch.tensor(0.3, dtype=torch.float32) if force else drop
    want = JSW.probe_draws(jk, gids_j, s_count, n, proxies, jp, force=force)
    got = SW.probe_draws(tk, gids_t, s_count, n, proxies, tp, force=force)
    assert got[0].shape == (m,) and got[2].shape == (m, proxies)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("family,fanout,proxies,drop", [
    ("complete", 2, 3, 0.0),           # w = 6
    ("complete", 2, 3, 0.05),          # w = 13
    ("erdos_renyi", 1, 2, 0.3),        # w = 9 on a table
    ("power_law", 3, 1, "ramp"),       # forced threshold on a table
])
def test_packed_draws_match_jax_random(family, fanout, proxies, drop):
    jk, tk = _keys(7, 2)
    jt, tt = _topos(family)
    force = drop == "ramp"
    jp = jnp.float32(0.37) if force else drop
    tp = torch.tensor(0.37, dtype=torch.float32) if force else drop
    ids_j = jnp.arange(N, dtype=jnp.int32)
    ids_t = torch.arange(N, dtype=torch.int64)
    want = JSW.packed_round_draws(
        jk, ids_j, 4, N, proxies, fanout, jp,
        nbrs=None if jt is None else jt.nbrs,
        deg=None if jt is None else jt.deg, sentinel=N, force=force)
    got = SW.packed_round_draws(
        tk, ids_t, 4, N, proxies, fanout, tp,
        nbrs=None if tt is None else tt.nbrs,
        deg=None if tt is None else tt.deg, sentinel=N, force=force)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_packed_thresholds_match_reference():
    """The static threshold is Python's ``int(p * 2**32)``; the forced
    one the reference's float32 arithmetic and convert, under jax.jit."""
    ps = [0.0, 1e-10, 0.02, 0.05, 0.1, 1 / 3, 0.5, 0.9999999,
          0.99999999, 1.0]

    @jax.jit
    def forced(p):
        dp = jnp.asarray(p, jnp.float32)
        return jnp.where(dp >= 1.0, jnp.uint32(0xFFFFFFFF),
                         jnp.minimum(dp * jnp.float32(4294967296.0),
                                     jnp.float32(4294967040.0)
                                     ).astype(jnp.uint32))

    for p in ps:
        assert int(SW.packed_threshold(p, False)) == \
            min(int(p * 2 ** 32), 2 ** 32 - 1)
        got = int(SW.packed_threshold(torch.tensor(np.float32(p)), True))
        assert got == int(forced(np.float32(p)))


def test_disseminate_max_lowerings_match_reference():
    """Every lowering equals the reference's scatter on adversarial rows
    (DEAD_WIRE rows, sentinel targets, an odd S, wires at the proof
    bound), at both lane widths and without a bound."""
    rng = np.random.default_rng(3)
    for max_rounds in (None, 60, 500):
        bound = 2 * (max_rounds or 60) + 2
        n, fanout, s = 257, 3, 5
        targets = rng.integers(0, n + 1, size=(n, fanout))
        w = rng.integers(0, bound, size=(n, s)).astype(np.int32)
        w[rng.random((n, s)) < 0.1] = SW.DEAD_WIRE
        want = np.asarray(JSW.disseminate_max(
            jnp.asarray(targets, jnp.int32), jnp.asarray(w), n, "scatter"))
        for impl in ("scatter", "sort", "pack"):
            got = SW.disseminate_max(torch.from_numpy(targets),
                                     torch.from_numpy(w), n, impl,
                                     max_rounds)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


# -- the round ---------------------------------------------------------------

@pytest.mark.parametrize("diss", ["scatter", "sort", "pack"])
@pytest.mark.parametrize("family", ["complete", "power_law"])
def test_split_round_matches_reference(diss, family):
    _trajectories(dict(PROTO, swim_diss=diss), 12, dead=(0, 2),
                  fail_round=4, fault=dict(drop_prob=0.15, seed=8),
                  family=family, max_rounds=12)


@pytest.mark.parametrize("family,fault", [
    ("complete", None),
    ("complete", dict(drop_prob=0.15, seed=8)),
    ("erdos_renyi", dict(drop_prob=0.2, seed=3)),
])
def test_packed_rng_round_matches_reference(family, fault):
    _trajectories(dict(PROTO, swim_rng="packed"), 12, dead=(0, 2),
                  fail_round=4, fault=fault, family=family)


def test_static_deaths_and_refutation_match_reference():
    """Static deaths with loss, a long suspicion timeout: false
    suspicions are raised and refuted (incarnations above 0)."""
    js, _ = _trajectories(
        dict(PROTO, swim_suspect_rounds=10, swim_subjects=2,
             swim_proxies=1), 30, n=64, dead=(1,), fail_round=3,
        fault=dict(drop_prob=0.3, node_death_rate=0.1, seed=5))
    assert (np.asarray(js.wire) // 2).max() >= 1


@pytest.mark.parametrize("rng", ["split", "packed"])
def test_churn_program_round_matches_reference(rng):
    """Churn events (a recovery and a permanent crash) and a drop ramp:
    the coins read the round's probability from the schedule."""
    fault = dict(drop_prob=0.05, seed=2,
                 churn=dict(events=((1, 2, -1), (3, 1, 6)),
                            ramp=(0, 4, 0.0, 0.2)))
    _trajectories(dict(PROTO, swim_rng=rng), 10, dead=(0,), fail_round=1,
                  fault=fault, family="power_law")


def test_rotating_window_matches_reference():
    """Across two epoch boundaries, with a dead node outside the first
    window."""
    proto = dict(PROTO, swim_subjects=8, swim_rotate=True)
    e = SW.resolve_epoch_rounds(TC.ProtocolConfig(**proto), 96)
    _trajectories(proto, 2 * e + 3, n=96, dead=(57,), fail_round=0)


@pytest.mark.parametrize("msgs0", [16777217.0 * 1.5, 1.0e8 + 7.0])
def test_msgs_above_2_24_grow_in_the_reference_order(msgs0):
    """Above 2^24 a float32 sum depends on its order: from a count there,
    each round adds the probe messages, then the dissemination's, as the
    reference does."""
    proto = dict(PROTO, swim_proxies=3)
    jstep = jax.jit(JSW.make_swim_round(JC.ProtocolConfig(**proto), N, (1,),
                                        2))
    tstep = SW.make_swim_round(TC.ProtocolConfig(**proto), N, (1,), 2,
                               device=CPU)
    js = JSW.init_swim_state(N, 4, 3)._replace(msgs=jnp.float32(msgs0))
    ts = SW.init_swim_state(N, 4, 3, CPU)._replace(
        msgs=torch.tensor(np.float32(msgs0)))
    for _ in range(6):
        js, ts = jstep(js), tstep(ts)
        _assert_same(js, ts)


# -- the loops and the reports ------------------------------------------------

@pytest.mark.parametrize("proto,fault,family", [
    (PROTO, None, "power_law"),
    (dict(PROTO, swim_subjects=8, swim_rotate=True), None, "complete"),
    (dict(PROTO, swim_rng="packed", swim_diss="pack"),
     dict(drop_prob=0.1, seed=1), "complete"),
])
def test_loops_match_reference(proto, fault, family):
    n, rounds = 300, 40
    jt, tt = _topos(family, n)
    jf, tf = _faults(fault)
    jp, tp = JC.ProtocolConfig(**proto), TC.ProtocolConfig(**proto)
    kw = dict(dead_nodes=(1,), fail_round=2, seed=5)
    jfr, jfin = JS.simulate_swim_curve(jp, n, rounds, fault=jf, topo=jt,
                                       **kw)
    tfr, tfin = TS.simulate_swim_curve(tp, n, rounds, fault=tf, topo=tt,
                                       device=CPU, **kw)
    np.testing.assert_array_equal(tfr, np.asarray(jfr))
    _assert_same(jfin, tfin)
    jr, jd, jpk, jst = JS.simulate_swim_until(jp, n, rounds, 0.99,
                                              fault=jf, topo=jt, **kw)
    tr, td, tpk, tst = TS.simulate_swim_until(tp, n, rounds, 0.99,
                                              fault=tf, topo=tt, device=CPU,
                                              **kw)
    assert (tr, td, tpk) == (jr, jd, jpk)
    _assert_same(jst, tst)


TIMING = {"compile_s", "build_s", "steady_wall_s", "driver_overhead_s",
          "topo_build_s", "device", "launches"}


def _reports(proto, topo, run, fault=None, curve=False):
    jf, tf = _faults(fault)
    port = run_simulation(TC.ProtocolConfig(**proto),
                          TC.TopologyConfig(**topo), TC.RunConfig(**run),
                          tf, want_curve=curve, device="cpu")
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**proto),
                          JC.TopologyConfig(**topo), JC.RunConfig(**run),
                          jf, want_curve=curve)
    assert (port.rounds, port.coverage, port.msgs, port.curve) == \
        (ref.rounds, ref.coverage, ref.msgs, ref.curve)
    strip = lambda m: {k: v for k, v in m.items() if k not in TIMING}
    assert strip(port.meta) == strip(ref.meta)
    return port, ref


SW1 = dict(mode="swim", fanout=2, swim_subjects=8, swim_proxies=3,
           swim_suspect_rounds=24)
PL = dict(family="power_law", n=3000, k=3, degree_cap=256)


@pytest.mark.parametrize("proto,fault,curve", [
    (SW1, None, False),
    (dict(SW1, swim_diss="pack"), None, False),
    (dict(SW1, swim_rng="packed"), None, True),
    (SW1, dict(churn=dict(events=((1, 2, -1), (3, 1, 6)),
                          ramp=(0, 4, 0.0, 0.05))), False),
    (dict(SW1, swim_rotate=True), dict(dead_nodes=(5,), fail_round=0),
     True),
])
def test_run_simulation_matches_reference(proto, fault, curve):
    """SW1-SW4 of the JAX package's SWIM runs at 3000 nodes, and a
    rotating window whose detection falls back to 0 once the window has
    left the dead node: the peak stays."""
    port, _ = _reports(proto, PL, dict(max_rounds=60, engine="auto"), fault,
                       curve)
    assert port.meta["swim_diss_effective"] == (
        "pack" if proto.get("swim_diss") == "pack" else "sort")
    if proto.get("swim_rotate"):
        assert port.meta["peak_detection"] > 0.9 and port.coverage == 0.0


# -- the detection quotient ---------------------------------------------------

def _boundary_counts(denom):
    """Counts where float32(c) / float32(d) and float32(c) * float32(1/d)
    differ."""
    d = np.float32(denom)
    return [c for c in range(denom + 1)
            if np.float32(c) / d != np.float32(c) * (np.float32(1) / d)]


def test_detection_is_the_compiled_quotient():
    """At n = 1000 with node 1 dead (the default scenario), the
    reference's detection under ``jax.jit``, alone and inside a while
    loop with its observers built in the trace, is the float32 quotient
    at every count where quotient and reciprocal product differ; the
    port gives the same."""
    n, s_count, dead = 1000, 8, (1,)
    counts = _boundary_counts(n - 1)
    assert len(counts) >= 40
    counts = counts[:40]

    def wire_at(c):
        w = np.zeros((n, s_count), np.int32)
        rows = [i for i in range(n) if i != 1][:c]
        w[rows, 1] = int(JSW.DEAD_WIRE)
        return w

    @jax.jit
    def alone(wire):
        alive = JSW.observer_alive(n, dead, None)
        st = JSW.SwimState(wire, wire, jnp.int32(1), jax.random.key(0),
                           jnp.float32(0))
        return JSW.detection_fraction(st, dead, alive,
                                      subj_gids=JSW.subject_window(
                                          0, s_count, n, False, 1))

    @jax.jit
    def looped(wire):
        alive = JSW.observer_alive(n, dead, None)

        def body(c):
            w, det, r = c
            st = JSW.SwimState(w, w, r, jax.random.key(0), jnp.float32(0))
            return w, JSW.detection_fraction(
                st, dead, alive, subj_gids=JSW.subject_window(
                    r, s_count, n, False, 1)), r + 1

        return jax.lax.while_loop(
            lambda c: (c[1] < jnp.float32(2.0)) & (c[2] < 1), body,
            (wire, jnp.float32(0), jnp.int32(0)))[1]

    observers = SW.observer_alive(n, dead, None, CPU)
    window = SW.subject_window(0, s_count, n, False, 1)
    for c in counts:
        w = wire_at(c)
        quotient = float(np.float32(c) / np.float32(n - 1))
        assert float(alone(jnp.asarray(w))) == quotient
        assert float(looped(jnp.asarray(w))) == quotient
        st = SW.SwimState(torch.from_numpy(w), torch.from_numpy(w), 1,
                          threefry.key(0), torch.zeros(()))
        assert SW.detection_fraction(st, dead, observers, window) == quotient
        assert SW.detection_quotient(*SW.detection_counts(
            st.wire, dead, observers, window)) == quotient


# -- refusals ----------------------------------------------------------------

def test_refusals_match_reference():
    # a partition under SWIM, in the reference's words
    fault = dict(churn=dict(partitions=((0, 4, 100),)))
    jf, tf = _faults(fault)
    msgs = []
    for make, cfg, f in ((JSW.make_swim_round, JC.ProtocolConfig, jf),
                         (SW.make_swim_round, TC.ProtocolConfig, tf)):
        with pytest.raises(ValueError, match="partition") as e:
            make(cfg(**PROTO), N, fault=f)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a window wider than the membership
    with pytest.raises(ValueError, match="swim_subjects"):
        SW.make_swim_round(TC.ProtocolConfig(mode="swim", swim_subjects=16),
                           8, device=CPU)
    # a dead node outside the fixed window
    st = SW.init_swim_state(16, 4, seed=0, device=CPU)
    with pytest.raises(ValueError, match="swim_rotate"):
        SW.detection_fraction(st, (9,))
    with pytest.raises(ValueError, match="swim-rotate"):
        run_simulation(TC.ProtocolConfig(**PROTO), TC.TopologyConfig(n=N),
                       TC.RunConfig(engine="xla"),
                       TC.FaultConfig(dead_nodes=(9,)), device="cpu")
    # the fused engine runs pull rounds only
    with pytest.raises(ValueError, match="pull rounds only"):
        run_simulation(TC.ProtocolConfig(**PROTO), TC.TopologyConfig(n=N),
                       TC.RunConfig(engine="fused"), device="cpu")


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    with pytest.raises(ValueError, match="CUDA device"):
        run_simulation(TC.ProtocolConfig(**PROTO), TC.TopologyConfig(n=N),
                       TC.RunConfig(engine="auto"))


def test_cli_runs_swim_as_the_reference(capsys):
    """SW1's command line at 3000 nodes through ``python -m
    gossip_tpu_torch run --device cpu`` and the reference's ``run``."""
    from gossip_tpu.cli import main as jmain
    args = ["--mode", "swim", "--n", "3000", "--family", "power_law",
            "--k", "3", "--degree-cap", "256", "--fanout", "2",
            "--swim-subjects", "8", "--swim-proxies", "3",
            "--swim-suspect-rounds", "24", "--max-rounds", "60"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "gossip_tpu_torch", "run",
                           *args, "--device", "cpu"], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert jmain(["run", *args]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (port["rounds"], port["coverage"], port["msgs"]) == \
        (ref["rounds"], ref["coverage"], ref["msgs"])
    assert port["meta"]["swim_diss_effective"] == "sort"


def test_topology_device_takes_an_index_less_cuda_device():
    """A table on ``cuda:0`` runs under ``device="cuda"`` (the command
    line's default), and refuses another device."""
    from types import SimpleNamespace

    from gossip_tpu_torch.models.si import topology_device
    on_card = G.Topology(nbrs=SimpleNamespace(device=torch.device("cuda", 0)),
                         deg=None, n=4, family="ring")
    assert topology_device(on_card, "cuda") == torch.device("cuda", 0)
    assert topology_device(on_card, None) == torch.device("cuda", 0)
    for other in ("cuda:1", "cpu"):
        with pytest.raises(ValueError, match="table is on"):
            topology_device(on_card, other)
