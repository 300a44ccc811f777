"""The port's go-native backend against the JAX package's.

The event simulator (``runtime/gonative.GoNativeSim``), its C++ core
(``runtime/native_sim.NativeGoSim`` on ``native/eventsim.cpp``, built
into the port's build directory) and ``backend.run_gonative`` run the
same graphs as the reference's: every delivery, hop depth, message count,
clock and node log must be equal (exact equality).  The port's flood
round is the exact BFS ball and bounds the event hop curve (the parity
contract of ``tests/test_gonative.py``), the refusals are the
reference's words, and a build without a compiler raises, where the
reference falls back to its Python engine.
"""

import dataclasses

import numpy as np
import pytest

from gossip_tpu import config as JC
from gossip_tpu.backend import run_gonative as jrun_gonative
from gossip_tpu.runtime import gonative as JGN
from gossip_tpu.runtime import native_sim as JNS
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import backend as TB
from gossip_tpu_torch import native
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.config import (FaultConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)
from gossip_tpu_torch.runtime import gonative as GN
from gossip_tpu_torch.runtime import native_sim as NS
from gossip_tpu_torch.runtime.simulator import simulate_curve
from gossip_tpu_torch.topology import generators as G


@pytest.fixture(autouse=True)
def _build_dir(tmp_path_factory, monkeypatch):
    """The port's event core is built into a directory of this session
    (each xdist worker its own), as ``--compile-cache DIR`` would."""
    d = tmp_path_factory.getbasetemp() / "native_build"
    monkeypatch.setitem(_kernels._STORE, "dir", None)
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", str(d))


GRAPHS = {
    "ring_k2": (lambda: G.ring(256, 2, "cpu"), lambda: JG.ring(256, 2)),
    "ring_k16": (lambda: G.ring(512, 16, "cpu"), lambda: JG.ring(512, 16)),
    "grid32": (lambda: G.grid2d(32, 32, "cpu"), lambda: JG.grid2d(32, 32)),
    "er500": (lambda: G.erdos_renyi(500, 0.02, seed=4, device="cpu"),
              lambda: JG.erdos_renyi(500, 0.02, seed=4)),
}


def _graph(name):
    port, ref = GRAPHS[name]
    table = GN.topology_from_table(port())
    assert table == JGN.topology_from_table(ref())
    return table


def _partition_graph(_name=None):
    return {0: [1], 1: [0, 2, 3], 2: [1], 3: [1]}


def _scenario(name):
    """``(topology dict, driver, net, horizon, messages)``."""
    if name.startswith("partition"):
        faithful = name.endswith("faithful")

        def drive(sim):
            sim.partition(1, 2, 0.0, 5.0)
            sim.broadcast(0, 1)
        return (_partition_graph(), drive, faithful, 60.0, [1])

    def drive(sim):
        sim.broadcast(0, 42)
        sim.broadcast(3, 7, t=0.003)
    return _graph(name), drive, True, 120.0, [42, 7]


SCENARIOS = [*GRAPHS, "partition_faithful", "partition_fixed"]


def _run(cls, net_cls, topo, drive, faithful, horizon):
    sim = cls(topo, net=net_cls(faithful_ctx_bug=faithful), horizon=horizon)
    drive(sim)
    sim.run()
    return sim


def _observed(sim, messages, n):
    """Everything a run exposes, as plain values."""
    return {"deliveries": sorted(sim.deliveries),
            "hop_depths": [sim.hop_depths(m) for m in messages],
            "msgs_sent": sim.msgs_sent, "now": sim.now,
            "reads": [sim.read(i) for i in range(n)]}


@pytest.mark.parametrize("name", SCENARIOS)
def test_event_sim_equals_the_references(name):
    """The Python engine, the port's C++ core and the reference's C++
    core against the reference's Python engine, every observable equal."""
    topo, drive, faithful, horizon, msgs = _scenario(name)
    n = len(topo)
    want = _observed(_run(JGN.GoNativeSim, JGN.NetConfig, topo, drive,
                          faithful, horizon), msgs, n)
    for cls, net_cls in ((GN.GoNativeSim, GN.NetConfig),
                         (NS.NativeGoSim, GN.NetConfig),
                         (JNS.NativeGoSim, JGN.NetConfig)):
        got = _observed(_run(cls, net_cls, topo, drive, faithful, horizon),
                        msgs, n)
        assert got == want, cls


def _bfs_coverage(topo, origin, rounds):
    """BFS ball sizes from the raw adjacency (numpy)."""
    nbrs, deg = topo.nbrs.numpy(), topo.deg.numpy()
    dist = np.full(topo.n, -1)
    dist[origin] = 0
    frontier, d = [origin], 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in nbrs[u, :deg[u]]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return np.array([(0 <= dist) & (dist <= h)
                     for h in range(rounds + 1)]).mean(axis=1)


@pytest.mark.parametrize("topo_fn,rounds", [
    (lambda: G.ring(1024, 4, "cpu"), 300),
    (lambda: G.grid2d(32, 32, "cpu"), 70),
    (lambda: G.erdos_renyi(1024, 0.008, seed=1, device="cpu"), 40),
], ids=["ring1024", "grid32x32", "er1024"])
def test_flood_round_is_the_bfs_ball_and_bounds_the_event_sim(topo_fn,
                                                              rounds):
    """The parity clock: the port's flood coverage after round t is the
    BFS ball of radius t, the event core's hop curve stays under it, and
    both reach the same set of nodes."""
    topo = topo_fn()
    res = simulate_curve(ProtocolConfig(mode="flood"), topo,
                         RunConfig(max_rounds=rounds, target_coverage=1.0,
                                   engine="xla"), device="cpu")
    kernel_cov = np.asarray(res.coverage)
    np.testing.assert_allclose(kernel_cov, _bfs_coverage(topo, 0, rounds)[1:],
                               atol=1e-6)
    sim = NS.make_event_sim(GN.topology_from_table(topo))
    sim.broadcast(origin=0, message=42)
    sim.run()
    hop_cov = np.array(sim.coverage_by_hop(42, rounds))
    assert (hop_cov[1:] <= kernel_cov + 1e-9).all()
    kernel_set = set(np.nonzero(res.state.seen[:, 0].numpy())[0].tolist())
    assert kernel_set == {i for i in range(topo.n) if 42 in sim.nodes[i].seen}
    assert len(kernel_set) >= 0.99 * topo.n


def test_exact_hop_parity_on_a_race_free_graph():
    topo = G.ring(256, 2, "cpu")
    res = simulate_curve(ProtocolConfig(mode="flood"), topo,
                         RunConfig(max_rounds=130, target_coverage=1.0,
                                   engine="xla"), device="cpu")
    sim = NS.make_event_sim(GN.topology_from_table(topo))
    sim.broadcast(origin=0, message=1)
    sim.run()
    assert sim.coverage_by_hop(1, 130)[1:] == \
        pytest.approx(np.asarray(res.coverage).tolist(), abs=1e-7)


RUNS = {
    "grid1024_curve": (dict(mode="flood"),
                       dict(family="grid", n=1024), dict(), True),
    "er2000_native": (dict(mode="flood"),
                      dict(family="erdos_renyi", n=2000, p=0.004, seed=2),
                      dict(engine="native"), False),
    "ring_3rumors": (dict(mode="flood", rumors=3),
                     dict(family="ring", n=600, k=4), dict(origin=5), True),
}


def _report(rep):
    out = rep.to_dict()
    out.pop("wall_s")
    return out


@pytest.mark.parametrize("name", RUNS)
def test_run_gonative_equals_the_references(name):
    proto, tc, run, curve = RUNS[name]
    got = TB.dispatch("go-native", ProtocolConfig(**proto),
                      TopologyConfig(**tc), RunConfig(**{"engine": "auto",
                                                         **run}),
                      want_curve=curve)
    want = jrun_gonative(JC.ProtocolConfig(**proto), JC.TopologyConfig(**tc),
                         JC.RunConfig(**run), want_curve=curve)
    assert _report(got) == _report(want)
    assert got.meta["engine"] == "NativeGoSim"


REFUSALS = [
    (dict(mode="flood"), dict(n=64), dict(engine="xla"), None),
    (dict(mode="flood"), dict(n=64), dict(engine="fused"), None),
    (dict(mode="flood"), dict(family="ring", n=20_001), dict(), None),
    (dict(mode="flood"), dict(family="ring", n=1_000_001),
     dict(engine="native"), None),
    (dict(mode="flood"), dict(n=2049), dict(), None),
    (dict(mode="pull"), dict(n=64), dict(), None),
    (dict(mode="flood"), dict(n=64), dict(), dict(drop_prob=0.1)),
]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("proto,tc,run,fault", REFUSALS,
                         ids=["xla", "fused", "cap", "native_cap",
                              "complete", "pull", "fault"])
def test_refusals_are_the_references_words(proto, tc, run, fault):
    def port(fn):
        return _error(lambda: fn(
            ProtocolConfig(**proto), TopologyConfig(**tc),
            RunConfig(**{"engine": "auto", **run}),
            None if fault is None else FaultConfig(**fault)))

    def ref(fn):
        return _error(lambda: fn(
            JC.ProtocolConfig(**proto), JC.TopologyConfig(**tc),
            JC.RunConfig(**run),
            None if fault is None else JC.FaultConfig(**fault)))
    from gossip_tpu.backend import run_simulation as jrun
    assert port(TB.run_gonative) == ref(jrun_gonative)
    assert port(lambda *a: TB.dispatch("go-native", *a)) == \
        ref(lambda p, t, r, f: jrun("go-native", p, t, r, f))


def test_native_engine_on_jax_tpu_is_the_references_refusal():
    from gossip_tpu.backend import run_simulation as jrun
    want = _error(lambda: jrun("jax-tpu", JC.ProtocolConfig(mode="pull"),
                               JC.TopologyConfig(n=64),
                               JC.RunConfig(engine="native")))
    assert _error(lambda: TB.run_simulation(
        ProtocolConfig(mode="pull"), TopologyConfig(n=64),
        RunConfig(engine="native"), device="cpu")) == want


def test_build_without_a_compiler_raises(tmp_path, monkeypatch):
    """No g++ on PATH: the event core, the router and the go-native run
    raise a ValueError naming the missing compiler; nothing returns the
    Python engine."""
    from gossip_tpu_torch.runtime import native_router
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", str(tmp_path / "empty"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    for fn in (native.load_eventsim, native_router.build_router,
               lambda: NS.make_event_sim({0: [1], 1: [0]}),
               lambda: TB.run_gonative(ProtocolConfig(mode="flood"),
                                       TopologyConfig(family="ring", n=64),
                                       RunConfig(engine="auto"))):
        with pytest.raises(ValueError, match="g\\+\\+"):
            fn()
    assert not list((tmp_path / "empty").glob("*eventsim*"))
    # the Python engine only when asked for
    assert isinstance(NS.make_event_sim({0: [1], 1: [0]},
                                        prefer_native=False), GN.GoNativeSim)


def test_builds_go_to_the_port_build_dir_only(tmp_path, monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", str(tmp_path))
    so = native.build_native(native.EVENTSIM_SRC, native.output_path(
        native.EVENTSIM_SRC, "libeventsim", ".so"))
    assert so.parent == tmp_path and so.exists()
    assert dataclasses.is_dataclass(GN.NetConfig())
    assert not list(native.EVENTSIM_SRC.parent.glob("*.so"))
