"""The sweep axis (``gossip_tpu_torch.parallel.sweep``): seed ensembles,
churn sweeps and the fused churn sweep, their meshes, ``run --ensemble``
and ``churn-sweep``, against the JAX package's ``parallel/sweep.py`` on
the CPU and against the port's own solo runs.

Every multi-rank port call of this file and of
``tests/test_torch_config_sweep.py`` (the config axis and the pod sweep)
runs once a test session, in one spawn for each K in {2, 4} under gloo
(:func:`port_runs`; under xdist the first worker to need it computes it
and the others read it).  The spawned ranks import this module for
:func:`_port_worker`, so its top level imports torch, numpy and the port
only; the JAX package comes in through the ``ref`` fixture, with its
executable store off, on its 8 virtual CPU devices.

Inputs come from numpy seeds; tolerance 0 everywhere (curves, msgs,
rounds to the target, dropped counts, exact counts, planes).  Every sum
here stays below 2^24, where the float32 rule of
``gossip_tpu_torch.ops.common`` makes them exact.
"""

import dataclasses
import json
import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import cli as TCLI
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models.rumor import simulate_curve_rumor
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import multislice as MSL
from gossip_tpu_torch.parallel import sharded_fused as SF
from gossip_tpu_torch.parallel import sweep as SWP
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

KS = (2, 4)
CPU = torch.device("cpu")
ROUNDS = 10
SEEDS = [3, 4, 5, 6]


def _heal(cut):
    """A churn_heal-style program: a crash that recovers, a permanent
    crash, a cut window, a drop ramp."""
    return dict(drop_prob=0.02, seed=3, churn=dict(
        events=((1, 1, 4), (2, 2, -1)), partitions=((0, 6, cut),),
        ramp=(0, 4, 0.0, 0.1)))


# (name, proto, topology, fault): the SI ensembles
ENSEMBLES = [
    ("pushpull", dict(mode="pushpull", fanout=2, rumors=2),
     ("complete", 128 * 8), None),
    ("pull-death-drop", dict(mode="pull", fanout=1),
     ("complete", 128 * 8 - 37), dict(node_death_rate=0.1, drop_prob=0.2,
                                      seed=3)),
    ("ae-heal", dict(mode="antientropy", fanout=1, period=2),
     ("complete", 128 * 8), _heal(512)),
    ("push-heal-death", dict(mode="push", fanout=2),
     ("erdos_renyi", 128 * 8, 0.02, 1),
     dict(_heal(400), node_death_rate=0.1)),
    ("flood-ring", dict(mode="flood"), ("ring", 128 * 8, 4), None),
]
ENSEMBLE_IDS = [e[0] for e in ENSEMBLES]

# the churn sweep: K mixed programs over one config, n not dyadic
CHURN_N = 128 * 12 - 37
CHURN_PROTO = dict(mode="pushpull", fanout=2)
CHURN_K = 4

SWIM_PROTO = dict(mode="swim", fanout=2, swim_suspect_rounds=4)

# the fused churn sweep: README.md:412's four shapes, cuts scaled to n
FUSED_N, FUSED_RUMORS, FUSED_ROUNDS = 128 * 8, 64, 6
FUSED_SCENARIOS = ["event=3:1:4", "partition=0:3:512", "ramp=0:4:0.0:0.2",
                   "event=9:1:-1;partition=1:4:256"]


def _topo(spec, gen, **device):
    kind, n, *rest = spec
    return {"complete": lambda: gen.complete(n),
            "ring": lambda: gen.ring(n, *rest, **device),
            "erdos_renyi": lambda: gen.erdos_renyi(n, rest[0], seed=rest[1],
                                                   **device)}[kind]()


def _fault(spec, cfg):
    if spec is None:
        return None
    spec = dict(spec)
    churn = spec.pop("churn", None)
    if churn is not None:
        spec["churn"] = cfg.ChurnConfig(**churn)
    return cfg.FaultConfig(**spec)


def _churn_faults(nem):
    return nem.mixed_scenarios(CHURN_K, CHURN_N, salt=1, drop_prob=0.01,
                               seed=0, ramp_to=0.09)


def _fused_faults(cfg):
    a = TCLI.build_parser().parse_args(
        ["churn-sweep", *[x for s in FUSED_SCENARIOS
                          for x in ("--scenario", s)]])
    return [cfg.FaultConfig(churn=cfg.ChurnConfig(
        events=f.churn.events, partitions=f.churn.partitions,
        ramp=f.churn.ramp)) for f in TCLI.churn_sweep_configs(a)[3]]


# -- the spawned ranks ------------------------------------------------------

def _port_worker(k, group):
    """One rank's share of every multi-rank port call of this file and
    of ``tests/test_torch_config_sweep.py`` (runs in the spawned
    ranks)."""
    import test_torch_config_sweep as CS
    torch.set_num_threads(1)
    out = {}
    for name, proto, topo, fault in ENSEMBLES:
        res = SWP.ensemble_curves(TC.ProtocolConfig(**proto),
                                  _topo(topo, G, device=CPU),
                                  TC.RunConfig(max_rounds=ROUNDS), SEEDS,
                                  _fault(fault, TC), group=group)
        out[f"ens-{name}"] = (res.curves, res.msgs)
    res = SWP.churn_sweep_curves(TC.ProtocolConfig(**CHURN_PROTO),
                                 G.complete(CHURN_N),
                                 TC.RunConfig(seed=2, max_rounds=ROUNDS),
                                 _churn_faults(NE), group=group)
    out["churn"] = (res.curves, res.msgs, res.dropped, res.counts)
    res = SWP.ensemble_rumor_curves(
        TC.ProtocolConfig(mode="rumor", fanout=1, rumor_k=2),
        G.complete(CHURN_N), TC.RunConfig(max_rounds=ROUNDS), SEEDS,
        group=group)
    out["rumor"] = (res.curves, res.hot, res.msgs)
    res = SWP.ensemble_swim_curves(TC.ProtocolConfig(**SWIM_PROTO), CHURN_N,
                                   TC.RunConfig(max_rounds=ROUNDS * 2), SEEDS,
                                   dead_nodes=(1,), fail_round=2,
                                   group=group)
    out["swim"] = (res.curves, res.msgs)
    if k == 2:
        res = SWP.fused_churn_sweep_curves(
            FUSED_N, FUSED_RUMORS, TC.RunConfig(max_rounds=FUSED_ROUNDS),
            _fused_faults(TC), group, fanout=2)
        out["fused"] = (res.curves, res.msgs)
    out.update(CS.port_mesh_calls(k, group))
    return out


def session_runs(tmp_path_factory):
    """``{K: {name: per-rank results}}``: one spawn for each K, once a
    session (shared through a file by the xdist workers of one run)."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_sweep_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _port_worker, k, k,
                                     device="cpu") for k in KS}
            runs = {k: {name: [r[name] for r in f.result()]
                        for name in f.result()[0]}
                    for k, f in spawns.items()}
        path.write_bytes(pickle.dumps(runs))
    return runs


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    return session_runs(tmp_path_factory)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here: the spawned ranks import
    this module)."""
    import jax
    import jax.numpy as jnp
    from gossip_tpu import config as JC
    from gossip_tpu.models import si as JSI
    from gossip_tpu.ops import nemesis as JNE
    from gossip_tpu.ops import pallas_round as J
    from gossip_tpu.parallel import sweep as JS
    from gossip_tpu.topology import generators as JG
    return types.SimpleNamespace(jax=jax, jnp=jnp, C=JC, SI=JSI, NE=JNE,
                                 J=J, S=JS, G=JG)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module's tests run: the batches
    pass torch's parallel grain, and the xdist workers' thread pools
    would otherwise contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


_REF_CACHE = {}


def _ref_ensemble(ref, name):
    """The reference's batch of an ensemble case, once a worker."""
    if name not in _REF_CACHE:
        _, proto, topo, fault = next(e for e in ENSEMBLES if e[0] == name)
        _REF_CACHE[name] = ref.S.ensemble_curves(
            ref.C.ProtocolConfig(**proto), _topo(topo, ref.G),
            ref.C.RunConfig(max_rounds=ROUNDS), SEEDS, _fault(fault, ref.C))
    return _REF_CACHE[name]


def _port_ensemble(name):
    """The port's batch of an ensemble case, once a worker."""
    if ("port", name) not in _REF_CACHE:
        _, proto, topo, fault = next(e for e in ENSEMBLES if e[0] == name)
        _REF_CACHE[("port", name)] = SWP.ensemble_curves(
            TC.ProtocolConfig(**proto), _topo(topo, G, device=CPU),
            TC.RunConfig(max_rounds=ROUNDS), SEEDS, _fault(fault, TC),
            device=CPU)
    return _REF_CACHE[("port", name)]


# -- the SI ensembles -------------------------------------------------------

@pytest.mark.parametrize("name", ENSEMBLE_IDS)
def test_ensemble_equals_reference(ref, name):
    """Every seed's curve, msgs and rounds to the target equal the
    reference's ``ensemble_curves`` (its jitted scan)."""
    got, want = _port_ensemble(name), _ref_ensemble(ref, name)
    np.testing.assert_array_equal(got.curves, want.curves)
    np.testing.assert_array_equal(got.msgs, want.msgs)
    np.testing.assert_array_equal(got.rounds_to_target,
                                  want.rounds_to_target)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("name", ENSEMBLE_IDS)
def test_ensemble_points_are_solo_runs(name):
    """Every seed of the batch is the port's solo ``simulate_curve``."""
    _, proto, topo, fault = next(e for e in ENSEMBLES if e[0] == name)
    got = _port_ensemble(name)
    for i, seed in enumerate(SEEDS):
        one = TS.simulate_curve(TC.ProtocolConfig(**proto),
                                _topo(topo, G, device=CPU),
                                TC.RunConfig(seed=seed, max_rounds=ROUNDS),
                                _fault(fault, TC), CPU)
        np.testing.assert_array_equal(got.curves[i], one.coverage)
        np.testing.assert_array_equal(got.msgs[i], one.msgs)
        assert got.rounds_to_target[i] == one.rounds_to_target


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ENSEMBLE_IDS)
def test_ensemble_seed_axis_mesh(port_runs, k, name):
    """The seed axis over K ranks: every rank holds the whole batch,
    equal to the single-device one."""
    got = _port_ensemble(name)
    for curves, msgs in port_runs[k][f"ens-{name}"]:
        np.testing.assert_array_equal(curves, got.curves)
        np.testing.assert_array_equal(msgs, got.msgs)


@pytest.mark.parametrize("kind", ["si", "churn", "rumor", "swim"])
def test_chunked_batch_equals_one_batch(monkeypatch, kind):
    """A batch past the memory budget runs in chunks of points, one
    after another: the same trajectories."""
    def run():
        if kind == "si":
            _, proto, topo, fault = ENSEMBLES[2]
            return SWP.ensemble_curves(
                TC.ProtocolConfig(**proto), _topo(topo, G, device=CPU),
                TC.RunConfig(max_rounds=ROUNDS), SEEDS, _fault(fault, TC),
                device=CPU)
        if kind == "churn":
            return SWP.churn_sweep_curves(
                TC.ProtocolConfig(**CHURN_PROTO), G.complete(CHURN_N),
                TC.RunConfig(seed=2, max_rounds=ROUNDS), _churn_faults(NE),
                device=CPU)
        if kind == "rumor":
            return SWP.ensemble_rumor_curves(
                TC.ProtocolConfig(mode="rumor", fanout=1, rumor_k=2),
                G.complete(CHURN_N), TC.RunConfig(max_rounds=ROUNDS), SEEDS,
                device=CPU)
        return SWP.ensemble_swim_curves(
            TC.ProtocolConfig(**SWIM_PROTO), CHURN_N,
            TC.RunConfig(max_rounds=ROUNDS), SEEDS, dead_nodes=(1,),
            fail_round=2, device=CPU)
    one = run()
    monkeypatch.setattr(SWP, "BATCH_BYTES", 1)
    got = run()
    assert got.meta["batch_chunks"] > one.meta["batch_chunks"] == 1
    np.testing.assert_array_equal(got.curves, one.curves)
    np.testing.assert_array_equal(got.msgs, one.msgs)


@pytest.mark.parametrize("which", ["rumor", "swim"])
def test_rumor_swim_ensembles_equal_reference(ref, which):
    """The rumor-mongering and SWIM ensembles (loops over the seeds)
    equal the reference's batches and the port's solo runs."""
    n, run = CHURN_N, TC.RunConfig(max_rounds=ROUNDS * 2)
    jrun = ref.C.RunConfig(max_rounds=ROUNDS * 2)
    if which == "rumor":
        kw = dict(mode="rumor", fanout=1, rumor_k=2)
        got = SWP.ensemble_rumor_curves(TC.ProtocolConfig(**kw),
                                        G.complete(n), run, SEEDS,
                                        device=CPU)
        want = ref.S.ensemble_rumor_curves(ref.C.ProtocolConfig(**kw),
                                           ref.G.complete(n), jrun, SEEDS)
        np.testing.assert_array_equal(got.hot, want.hot)
        assert got.summary() == want.summary()
        covs, hots, msgs, _ = simulate_curve_rumor(
            TC.ProtocolConfig(**kw), G.complete(n),
            dataclasses.replace(run, seed=SEEDS[-1]), None, CPU)
        np.testing.assert_array_equal(got.curves[-1], covs)
        np.testing.assert_array_equal(got.msgs[-1], msgs)
    else:
        kw = dict(mode="swim", fanout=2, swim_suspect_rounds=4)
        got = SWP.ensemble_swim_curves(TC.ProtocolConfig(**kw), n, run,
                                       SEEDS, dead_nodes=(1,), fail_round=2,
                                       device=CPU)
        want = ref.S.ensemble_swim_curves(ref.C.ProtocolConfig(**kw), n,
                                          jrun, SEEDS, dead_nodes=(1,),
                                          fail_round=2)
        np.testing.assert_array_equal(got.rounds_to_target,
                                      want.rounds_to_target)
        fr, final = TS.simulate_swim_curve(
            TC.ProtocolConfig(**kw), n, run.max_rounds, dead_nodes=(1,),
            fail_round=2, seed=SEEDS[-1], device=CPU)
        np.testing.assert_array_equal(got.curves[-1], fr)
        assert got.msgs[-1, -1] == np.float32(final.msgs.item())
    np.testing.assert_array_equal(got.curves, want.curves)
    np.testing.assert_array_equal(got.msgs, want.msgs)


@pytest.mark.parametrize("case", ["rotate", "churn-drop"])
def test_swim_ensemble_scenarios_equal_reference(ref, case):
    """SWIM ensembles on the rotating window (a dead node past the first
    window) and under a program with a ramp and static drops."""
    n, rounds = 600, 40
    kw = dict(mode="swim", fanout=2, swim_suspect_rounds=4,
              swim_rotate=case == "rotate", swim_epoch_rounds=12)
    if case == "rotate":
        dead, fail_round, spec = (54,), 0, None
    else:
        dead, fail_round = (), 0
        spec = dict(drop_prob=0.05, seed=2, churn=dict(
            events=((3, 1, -1), (5, 2, 6)), ramp=(0, 6, 0.0, 0.2)))
    got = SWP.ensemble_swim_curves(
        TC.ProtocolConfig(**kw), n, TC.RunConfig(max_rounds=rounds), SEEDS,
        dead_nodes=dead, fail_round=fail_round, fault=_fault(spec, TC),
        device=CPU)
    want = ref.S.ensemble_swim_curves(
        ref.C.ProtocolConfig(**kw), n, ref.C.RunConfig(max_rounds=rounds),
        SEEDS, dead_nodes=dead, fail_round=fail_round,
        fault=_fault(spec, ref.C))
    np.testing.assert_array_equal(got.curves, want.curves)
    np.testing.assert_array_equal(got.msgs, want.msgs)


@pytest.mark.parametrize("k", KS)
def test_swim_ensemble_seed_axis_mesh(port_runs, k):
    got = SWP.ensemble_swim_curves(TC.ProtocolConfig(**SWIM_PROTO), CHURN_N,
                                   TC.RunConfig(max_rounds=ROUNDS * 2), SEEDS,
                                   dead_nodes=(1,), fail_round=2, device=CPU)
    for curves, msgs in port_runs[k]["swim"]:
        np.testing.assert_array_equal(curves, got.curves)
        np.testing.assert_array_equal(msgs, got.msgs)


@pytest.mark.parametrize("k", KS)
def test_rumor_ensemble_seed_axis_mesh(port_runs, k):
    got = SWP.ensemble_rumor_curves(
        TC.ProtocolConfig(mode="rumor", fanout=1, rumor_k=2),
        G.complete(CHURN_N), TC.RunConfig(max_rounds=ROUNDS), SEEDS,
        device=CPU)
    for curves, hot, msgs in port_runs[k]["rumor"]:
        np.testing.assert_array_equal(curves, got.curves)
        np.testing.assert_array_equal(hot, got.hot)
        np.testing.assert_array_equal(msgs, got.msgs)


# -- the coverage choosers at ulp-boundary counts -------------------------

def _boundary(total):
    """The first count c of ``total`` whose folded product and quotient
    differ (None if there is none)."""
    inv = np.float32(1) / np.float32(total)
    return next((c for c in range(1, total)
                 if np.float32(c) * inv != np.float32(c) / np.float32(total)),
                None)


@pytest.mark.parametrize("fault", ["none", "death", "heal", "heal-death"])
def test_ensemble_chooser_at_ulp_boundary(ref, fault):
    """At a count whose folded product and quotient differ, the
    ensemble's readout equals the reference's scan body's
    ``coverage(x.seen, NE.metric_alive(...))`` under ``jax.jit``: the
    product without deaths (the alive set is a constant), the quotient
    with a drawn death mask."""
    spec = {"none": None, "death": dict(node_death_rate=0.1, seed=2),
            "heal": _heal(700),
            "heal-death": dict(_heal(700), node_death_rate=0.1)}[fault]
    tf, jf = _fault(spec, TC), _fault(spec, ref.C)
    for n in (128 * 12 - 37, 1600, 1000, 1291):   # a total with a boundary
        alive, total, folded = SWP.ensemble_readout(tf, n, 0, CPU)
        c = _boundary(total)
        if c is not None:
            break
    keep = (np.arange(n) if alive is None
            else np.flatnonzero(alive.numpy()))[:c]
    seen = np.zeros((2, n, 1), bool)
    seen[:, keep] = True
    want = ref.jax.jit(lambda s: ref.jax.vmap(lambda x: ref.SI.coverage(
        x, ref.NE.metric_alive(jf, n, 0)))(s))(seen)
    got = SWP._fractions(np.asarray([[c], [c]]), total, folded)
    assert got[:, 0].tolist() == np.asarray(want).tolist()
    assert float(got[0, 0]) == (f32_mean(c, total) if folded
                                else f32_fraction(c, total))


def test_churn_sweep_chooser_is_the_quotient():
    """The churn sweep divides its exact count once on the host (the
    reference's true division), where the solo loop's compiled chooser
    multiplies: at a boundary count they differ by an ulp."""
    total = 1600
    c = _boundary(total)
    got = SWP._fractions(np.asarray([[c]]), np.asarray([total]), False)
    assert float(got[0, 0]) == f32_fraction(c, total) != f32_mean(c, total)


# -- the churn sweep --------------------------------------------------------

@pytest.fixture(scope="module")
def churn_pair(ref):
    run = dict(seed=2, max_rounds=ROUNDS)
    got = SWP.churn_sweep_curves(TC.ProtocolConfig(**CHURN_PROTO),
                                 G.complete(CHURN_N), TC.RunConfig(**run),
                                 _churn_faults(NE), device=CPU)
    want = ref.S.churn_sweep_curves(ref.C.ProtocolConfig(**CHURN_PROTO),
                                    ref.G.complete(CHURN_N),
                                    ref.C.RunConfig(**run),
                                    _churn_faults(ref.NE))
    return got, want


@pytest.mark.parametrize("field", ["curves", "msgs", "dropped",
                                   "rounds_to_target", "summaries"])
def test_churn_sweep_equals_reference(churn_pair, field):
    got, want = churn_pair
    if field == "summaries":
        assert got.summaries() == want.summaries()
    else:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("i", range(CHURN_K))
def test_churn_sweep_scenarios_are_solo_steps(churn_pair, i):
    """Scenario i's exact counts, msgs and dropped count equal the solo
    step's under its program, round by round (the solo trajectory)."""
    from gossip_tpu_torch.models.si import coverage_count, make_si_round
    from gossip_tpu_torch.models.state import init_state
    got, _ = churn_pair
    fault = _churn_faults(NE)[i]
    proto, run = TC.ProtocolConfig(**CHURN_PROTO), TC.RunConfig(
        seed=2, max_rounds=ROUNDS)
    step = make_si_round(proto, G.complete(CHURN_N), fault, 0, CPU)
    alive = NE.metric_alive(fault, CHURN_N, 0, CPU)
    state = init_state(run, proto, CHURN_N, CPU)
    for r in range(ROUNDS):
        state, lost = step(state)
        assert got.counts[i, r] == coverage_count(state.seen, alive)[0]
        assert got.msgs[i, r] == np.float32(state.msgs.item())
        assert got.dropped[i, r] == np.float32(lost.item())
    one = TS.simulate_curve(proto, G.complete(CHURN_N), run, fault, CPU)
    np.testing.assert_array_equal(got.msgs[i], one.msgs)


@pytest.mark.parametrize("k", KS)
def test_churn_sweep_scenario_axis_mesh(port_runs, churn_pair, k):
    got, _ = churn_pair
    for curves, msgs, dropped, counts in port_runs[k]["churn"]:
        np.testing.assert_array_equal(curves, got.curves)
        np.testing.assert_array_equal(msgs, got.msgs)
        np.testing.assert_array_equal(dropped, got.dropped)
        np.testing.assert_array_equal(counts, got.counts)


@pytest.mark.parametrize("case", ["static", "empty", "no-churn",
                                  "fused-static", "fused-no-churn"])
def test_churn_sweep_refusals(ref, case):
    """The reference's refusals, in its words."""
    faults = _churn_faults(NE)
    jfaults = _churn_faults(ref.NE)
    if case in ("static", "fused-static"):
        faults[1] = dataclasses.replace(faults[1], node_death_rate=0.1)
        jfaults[1] = dataclasses.replace(jfaults[1], node_death_rate=0.1)
        phrase = "must share the STATIC fault structure"
    elif case == "empty":
        faults = jfaults = []
        phrase = "need at least one churn FaultConfig"
    else:
        faults[2] = TC.FaultConfig(drop_prob=0.01)
        jfaults[2] = ref.C.FaultConfig(drop_prob=0.01)
        phrase = ("must each carry a churn schedule" if case.startswith(
            "fused") else "carry no churn schedule")
    run = TC.RunConfig(max_rounds=4)
    if case.startswith("fused"):
        with GR.local("cpu") as g, pytest.raises(ValueError) as e:
            SWP.fused_churn_sweep_curves(CHURN_N, 32, run, faults, g)
        with pytest.raises(ValueError) as je:
            ref.S.fused_churn_sweep_curves(CHURN_N, 32,
                                           ref.C.RunConfig(max_rounds=4),
                                           jfaults, None)
    else:
        with pytest.raises(ValueError) as e:
            SWP.churn_sweep_curves(TC.ProtocolConfig(**CHURN_PROTO),
                                   G.complete(CHURN_N), run, faults,
                                   device=CPU)
        with pytest.raises(ValueError) as je:
            ref.S.churn_sweep_curves(ref.C.ProtocolConfig(**CHURN_PROTO),
                                     ref.G.complete(CHURN_N),
                                     ref.C.RunConfig(max_rounds=4), jfaults)
    assert phrase in str(e.value)
    assert str(e.value) == str(je.value)


def test_build_stack_equals_reference(ref):
    """The stacked schedule: every table of every scenario equals the
    reference's ``build_stack`` (padded to the largest horizon)."""
    faults = _churn_faults(NE)
    faults[0] = dataclasses.replace(faults[0], churn=TC.ChurnConfig(
        events=((5, 1, 40),), ramp=(0, 50, 0.0, 0.2)))
    jfaults = _churn_faults(ref.NE)
    jfaults[0] = dataclasses.replace(jfaults[0], churn=ref.C.ChurnConfig(
        events=((5, 1, 40),), ramp=(0, 50, 0.0, 0.2)))
    got = NE.build_stack(faults, CHURN_N, device=CPU)
    want = ref.NE.build_stack(jfaults, CHURN_N)
    for field in ("die", "rec", "cut_tbl", "drop_tbl"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


# -- the fused churn sweep ---------------------------------------------------

def _fused_replay(ref, fault, rounds):
    """The reference's fused curve driver under a program, stepped on the
    host on the port's Philox bits (its interpreter draws zeros): each
    plane of each round through ``fused_multirumor_pull_round(interpret=
    True)`` with the round's operands, the curve through the jitted
    ``coverage_planes_masked`` (``tests/test_torch_fused_planes.py``'s
    replay)."""
    from gossip_tpu.parallel import sharded_fused as JSF
    n, J, JNE = FUSED_N, ref.J, ref.NE
    planes = np.asarray(JSF.init_plane_state(n, FUSED_RUMORS,
                                             JSF.make_plane_mesh(2), 0))
    cov = ref.jax.jit(lambda p, w: JSF.coverage_planes_masked(p, n, w))
    base = JNE.fused_base_words(fault, n, 0)
    die, rec = JNE.fused_word_tables(fault, n)
    words = JNE.fused_eventual_words(base, die, rec)
    cut_np, thr_np = JNE.fused_sched_tables(fault, n)
    covs = []
    for r in range(rounds):
        i = min(r, len(cut_np) - 1)
        alive = JNE.fused_alive_words_at(base, die, rec, r)
        sb, rb = MR.draw_mr_round_bits(0, r, planes.shape[1], 2, device=CPU)
        u32 = (lambda t: t.numpy().view(np.uint32))
        planes = np.stack([np.asarray(J.fused_multirumor_pull_round(
            p, 0, r, n, 2, interpret=True, inject_bits=(u32(sb), u32(rb)),
            drop_threshold=int(thr_np[i]), alive_words=alive,
            cut_words=J.render_cut_words(int(cut_np[i]), n)))
            for p in planes])
        covs.append(float(cov(planes, words)))
    return np.asarray(covs, np.float32)


@pytest.mark.parametrize("i", [1, 3])
def test_fused_churn_sweep_equals_reference_replay(ref, port_runs, i):
    """Scenario i of the fused sweep at K = 2 (fanout 2, the command's
    default) equals the reference's fused curve driver replayed on the
    port's bits; msgs are the closed form."""
    curves, msgs = port_runs[2]["fused"][0]
    jf = _fused_faults(ref.C)[i]
    np.testing.assert_array_equal(curves[i], _fused_replay(ref, jf,
                                                           FUSED_ROUNDS))
    np.testing.assert_array_equal(
        msgs[i], 2.0 * 2 * FUSED_N * np.arange(1, FUSED_ROUNDS + 1,
                                               dtype=np.float32))


def test_fused_churn_sweep_is_the_curve_driver(port_runs):
    """Every scenario of the fused sweep is the port's
    ``simulate_curve_sharded_fused`` under its program (one rank: the
    same planes as K = 2's)."""
    curves, _ = port_runs[2]["fused"][0]
    run = TC.RunConfig(max_rounds=FUSED_ROUNDS)
    with GR.local("cpu") as g:
        for k, f in enumerate(_fused_faults(TC)):
            covs, _ = SF.simulate_curve_sharded_fused(FUSED_N, FUSED_RUMORS,
                                                      run, g, 2, f)
            np.testing.assert_array_equal(curves[k], covs)


# -- the command lines -------------------------------------------------------

def _ref_cli(ref, capsys, argv):
    from gossip_tpu import cli as JCLI
    assert JCLI.main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _port_cli(capsys, argv):
    assert TCLI.main([*argv, "--device", "cpu"]) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


ENSEMBLE_LINES = [
    ["run", "--mode", "pushpull", "--n", "1000", "--ensemble", "4",
     "--max-rounds", "24", "--curve"],
    ["run", "--mode", "pull", "--n", "1000", "--ensemble", "3",
     "--max-rounds", "24", "--drop", "0.1", "--churn-event", "3:1:4",
     "--seed", "7"],
    ["run", "--mode", "rumor", "--n", "1000", "--ensemble", "3",
     "--max-rounds", "30", "--rumor-k", "2"],
    ["run", "--mode", "swim", "--n", "600", "--ensemble", "2",
     "--max-rounds", "24", "--swim-suspect-rounds", "4"],
]


@pytest.mark.parametrize("argv", ENSEMBLE_LINES,
                         ids=["pushpull", "pull-heal", "rumor", "swim"])
def test_run_ensemble_command_equals_reference(ref, capsys, argv):
    """``run --ensemble S``: the reference command's keys and values
    (the ensemble summary, the mode's keys, the curve's mean), then the
    port's own keys."""
    want = _ref_cli(ref, capsys, argv)[-1]
    got = _port_cli(capsys, argv)[-1]
    assert got["backend"] == "torch-cpu"
    for key in set(want) - {"backend"}:
        assert got[key] == want[key], key
    assert got["devices"] == 1 and got["device"] == "cpu"


def test_churn_sweep_command_equals_reference(ref, capsys):
    argv = ["churn-sweep", "--n", "1000", "--max-rounds", "20", "--curve",
            "--drop", "0.01", "--scenario", "event=3:1:4",
            "--scenario", "partition=0:3:500",
            "--scenario", "ramp=0:4:0.0:0.2",
            "--scenario", "event=9:1:-1;partition=1:4:250"]
    want = _ref_cli(ref, capsys, argv)[-1]
    got = _port_cli(capsys, argv)[-1]
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("argv,phrase", [
    (["run", "--ensemble", "4", "--engine", "fused"],
     "ensembles run the threefry XLA kernels; engine='fused' is "
     "single-run only"),
    (["run", "--ensemble", "4", "--devices", "2", "--exchange", "sparse"],
     "--ensemble shards the SEED axis; --exchange does not apply "
     "(drop it)"),
    (["churn-sweep", "--engine", "fused", "--mode", "push", "--scenario",
      "event=3:1:4"], "engine='fused' implements pull rounds only"),
    (["churn-sweep", "--devices", "2", "--scenario", "event=3:1:4",
      "--scenario", "event=4:1:4", "--scenario", "event=5:1:4"],
     "3 scenarios do not divide over 2 devices"),
], ids=["ensemble-fused", "ensemble-exchange", "fused-push",
        "scenarios-divide"])
def test_sweep_command_refusals(ref, capsys, argv, phrase):
    """Refused with exit code 2, in the reference command's words."""
    assert TCLI.main([*argv, "--device", "cpu"]) == 2
    assert phrase in capsys.readouterr().err
    from gossip_tpu import cli as JCLI
    if argv[0] == "run":
        argv = [*argv, "--backend", "jax-tpu"]
    try:
        rc = JCLI.main(argv)
    except ValueError as e:          # the reference raises past main
        rc, err = 2, str(e)
    else:
        err = capsys.readouterr().err
    assert rc == 2 and phrase in err


def test_seed_divisibility_refusal(ref):
    """The seed axis refuses a batch its ranks do not divide, in the
    reference's words (``_shard_ensemble``)."""
    g = types.SimpleNamespace(size=3, rank=0)
    with pytest.raises(ValueError, match="4 seeds do not divide over the "
                       "seed mesh axis of size 3; pad the seed list or "
                       "change the mesh"):
        SWP.ensemble_curves(TC.ProtocolConfig(), G.complete(64),
                            TC.RunConfig(max_rounds=2), SEEDS, group=g)


def test_hybrid_mesh_sweep_shapes():
    """The pod sweep's grid: configs ride the rows (the outer axis),
    nodes the columns (``make_hybrid_mesh``'s inner axis)."""
    devs = [MSL.RankSlot(i, 0) for i in range(4)]
    grid = MSL._hybrid_device_grid(devs, 2, 2)
    assert [[d.id for d in row] for row in grid] == [[0, 1], [2, 3]]
