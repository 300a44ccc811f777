"""The config sweep (``gossip_tpu_torch.parallel.sweep.config_sweep_curves``
and its partitioned, sharded and pod-mesh drivers) and the ``grid``
command against the JAX package's ``parallel/sweep.py`` on the CPU and
against the port's solo runs.

The multi-rank port calls (the config axis at K = 2 and 4, the pod sweep
on 2 x 1, 1 x 2 and 2 x 2 hybrid meshes) run in the spawns of
``tests/test_torch_sweep.py`` (:func:`port_mesh_calls`), once a session.
This module's top level imports torch, numpy and the port only (the
spawned ranks import it); the JAX package comes in through the ``ref``
fixture.

Inputs come from numpy seeds; tolerance 0 everywhere (curves, msgs,
rounds to the target, draws).
"""

import json
import types

import numpy as np
import pytest
import torch

from gossip_tpu_torch import cli as TCLI
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.sampling import (sample_peers_complete,
                                           sample_peers_table)
from gossip_tpu_torch.parallel import multislice as MSL
from gossip_tpu_torch.parallel import sweep as SWP
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
ROUNDS = 10
N = 128 * 10 - 37


def _grid(modes=("push", "pull", "pushpull", "antientropy"),
          fanouts=(1, 2), drops=(0.0, 0.1), topos=(0,), rumors=(0,),
          seeds=(0,)):
    return [dict(mode=m, fanout=f, drop_prob=d,
                 period=2 if m == "antientropy" else 1, seed=s, topo_idx=t,
                 rumors=r)
            for t in topos for m in modes for f in fanouts for d in drops
            for r in rumors for s in seeds]


def _topos(kind, gen, **device):
    """The topology argument of a case: one graph or a list."""
    er = lambda n, s: gen.erdos_renyi(n, 0.03, seed=s, **device)  # noqa
    return {
        "complete": lambda: gen.complete(N),
        "er": lambda: er(N, 1),
        "families": lambda: [gen.ring(N, 4, **device), er(N, 2),
                             gen.watts_strogatz(N, 4, 0.2, seed=3,
                                                **device)],
        "ns-explicit": lambda: [gen.ring(600, 4, **device), er(N, 2)],
        "ns-complete": lambda: [gen.complete(600), gen.complete(N)],
    }[kind]()


# (name, topologies, points, fault, batch rumors): the config batches
CASES = [
    ("grid-complete", "complete", _grid(), None, 1),
    ("grid-er-death", "er", _grid(modes=("push", "pull", "pushpull")),
     dict(node_death_rate=0.1, seed=4), 1),
    ("families", "families", _grid(drops=(0.0,), topos=(0, 1, 2)), None, 1),
    ("ns-explicit", "ns-explicit",
     _grid(modes=("push", "pull"), drops=(0.0,), topos=(0, 1)), None, 1),
    ("ns-complete", "ns-complete",
     _grid(modes=("pushpull", "antientropy"), drops=(0.0,), topos=(0, 1)),
     None, 1),
    ("rumors", "complete",
     _grid(modes=("push", "pull"), drops=(0.0, 0.1), rumors=(1, 3)), None,
     1),
    ("compose", "ns-explicit",
     _grid(modes=("pushpull", "antientropy"), fanouts=(1, 3), drops=(0.05,),
           topos=(0, 1), rumors=(1, 2), seeds=(0, 7)), None, 2),
]
CASE_IDS = [c[0] for c in CASES]
# (case, point index) of every point held to its solo run
SOLO = [(name, i) for name, _, pts, _, _ in CASES for i in range(len(pts))
        if i % 3 == 0 or i == len(pts) - 1]


def _fault(spec, cfg):
    return None if spec is None else cfg.FaultConfig(**spec)


def _case(name):
    return next(c for c in CASES if c[0] == name)


_PORT = {}


def _port(name, group=None):
    """The port's batch of a case (on one device: once a worker)."""
    if group is None and name in _PORT:
        return _PORT[name]
    _, topos, pts, fault, rumors = _case(name)
    res = SWP.config_sweep_curves(
        [SWP.SweepPoint(**p) for p in pts], _topos(topos, G, device=CPU),
        TC.RunConfig(max_rounds=ROUNDS), _fault(fault, TC), rumors=rumors,
        group=group, device=None if group is not None else CPU)
    if group is None:
        _PORT[name] = res
    return res


# -- the spawned ranks (tests/test_torch_sweep.py's spawn) --------------------

POD_N = 128 * 4 - 37
POD_POINTS = _grid(drops=(0.0,))


def port_mesh_calls(k: int, group) -> dict:
    """This file's multi-rank calls on one rank of a K-rank spawn: the
    config axis over the K ranks, and the pod sweep on the hybrid meshes
    K allows (2 x 1 and 1 x 2 at K = 2, 2 x 2 at K = 4)."""
    out = {}
    for name in ("grid-complete", "families"):
        res = _port(name, group=group)
        out[f"cfg-{name}"] = (res.curves, res.msgs)
    shapes = [(2, 1), (1, 2)] if k == 2 else [(2, 2)]
    for s, nd in shapes:
        mesh = MSL.make_hybrid_mesh(s, nd, device="cpu")
        for topo in ("complete", "er"):
            t = (G.complete(POD_N) if topo == "complete"
                 else G.erdos_renyi(POD_N, 0.03, seed=1, device=CPU))
            res = SWP.config_sweep_curves_2d(
                [SWP.SweepPoint(**p) for p in POD_POINTS], t,
                TC.RunConfig(max_rounds=ROUNDS), mesh)
            out[f"pod-{s}x{nd}-{topo}"] = (res.curves, res.msgs)
    return out


@pytest.fixture(scope="module")
def ref():
    import jax
    from gossip_tpu import config as JC
    from gossip_tpu.parallel import sweep as JS
    from gossip_tpu.topology import generators as JG
    return types.SimpleNamespace(jax=jax, C=JC, S=JS, G=JG)


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


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    """The spawns of ``tests/test_torch_sweep.py``."""
    import test_torch_sweep as TSW
    return TSW.session_runs(tmp_path_factory)


_REF = {}


def _reference(ref, name):
    if name not in _REF:
        _, topos, pts, fault, rumors = _case(name)
        _REF[name] = ref.S.config_sweep_curves(
            [ref.S.SweepPoint(**p) for p in pts], _topos(topos, ref.G),
            ref.C.RunConfig(max_rounds=ROUNDS), _fault(fault, ref.C),
            rumors=rumors)
    return _REF[name]


# -- the batches ------------------------------------------------------------

@pytest.mark.parametrize("name", CASE_IDS)
def test_config_sweep_equals_reference(ref, name):
    """Every point's curve, msgs and rounds to the target equal the
    reference's batch (the mode x fanout x drop grid; the topology, n
    and rumor axes, and their composition)."""
    got, want = _port(name), _reference(ref, name)
    np.testing.assert_array_equal(got.curves, want.curves)
    np.testing.assert_array_equal(got.msgs, want.msgs)
    np.testing.assert_array_equal(got.rounds_to_target,
                                  want.rounds_to_target)
    assert got.summaries() == want.summaries()


@pytest.mark.parametrize("name,i", SOLO, ids=[f"{n}-{i}" for n, i in SOLO])
def test_config_sweep_points_are_solo_runs(name, i):
    """A point is its solo ``simulate_curve`` at its own mode, fanout
    (the first columns of the batch's k_max-wide draw), drop, period,
    seed, graph and rumor count."""
    _, topos, pts, fault, rumors = _case(name)
    got = _port(name)
    p = pts[i]
    topo = _topos(topos, G, device=CPU)
    topo = topo[p["topo_idx"]] if isinstance(topo, list) else topo
    spec = dict(fault or {}, drop_prob=p["drop_prob"])
    one = TS.simulate_curve(
        TC.ProtocolConfig(mode=p["mode"], fanout=p["fanout"],
                          period=p["period"], rumors=p["rumors"] or rumors),
        topo, TC.RunConfig(seed=p["seed"], max_rounds=ROUNDS),
        TC.FaultConfig(**spec) if any(spec.values()) else None, CPU)
    np.testing.assert_array_equal(got.curves[i], one.coverage)
    np.testing.assert_array_equal(got.msgs[i], one.msgs)
    assert got.rounds_to_target[i] == one.rounds_to_target


@pytest.mark.parametrize("name", ["grid-complete", "rumors", "compose"])
def test_partitioned_equals_single_batch(name):
    """One batch a mode bucket gives the single batch's trajectories,
    in the caller's order."""
    _, topos, pts, fault, rumors = _case(name)
    got = SWP.config_sweep_curves_partitioned(
        [SWP.SweepPoint(**p) for p in pts], _topos(topos, G, device=CPU),
        TC.RunConfig(max_rounds=ROUNDS), _fault(fault, TC), rumors=rumors,
        device=CPU)
    one = _port(name)
    np.testing.assert_array_equal(got.curves, one.curves)
    np.testing.assert_array_equal(got.msgs, one.msgs)


def test_elision_changes_nothing():
    """Building both halves for a pure batch gives the same
    trajectories (the halves draw under their own tags)."""
    pts = [SWP.SweepPoint(mode="push", fanout=f) for f in (1, 2)]
    run = TC.RunConfig(max_rounds=ROUNDS)
    a = SWP.config_sweep_curves(pts, G.complete(N), run, device=CPU)
    b = SWP.config_sweep_curves(pts, G.complete(N), run, device=CPU,
                                _force_both=True)
    np.testing.assert_array_equal(a.curves, b.curves)
    np.testing.assert_array_equal(a.msgs, b.msgs)


@pytest.mark.parametrize("name", ["grid-er-death", "compose"])
def test_chunked_batch_equals_one_batch(monkeypatch, name):
    """A batch past the memory budget runs in chunks of points, one
    after another: the same trajectories."""
    one = _port(name)
    monkeypatch.setattr(SWP, "BATCH_BYTES", 1)
    _, topos, pts, fault, rumors = _case(name)
    got = SWP.config_sweep_curves(
        [SWP.SweepPoint(**p) for p in pts], _topos(topos, G, device=CPU),
        TC.RunConfig(max_rounds=ROUNDS), _fault(fault, TC), rumors=rumors,
        device=CPU)
    assert got.meta["batch_chunks"] == len(pts) > one.meta["batch_chunks"]
    np.testing.assert_array_equal(got.curves, one.curves)
    np.testing.assert_array_equal(got.msgs, one.msgs)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["grid-complete", "families"])
def test_config_axis_mesh(port_runs, k, name):
    """The config axis over K ranks: every rank holds the whole batch,
    the single-device one."""
    one = _port(name)
    for curves, msgs in port_runs[k][f"cfg-{name}"]:
        np.testing.assert_array_equal(curves, one.curves)
        np.testing.assert_array_equal(msgs, one.msgs)


_POD_REF = {}


@pytest.mark.parametrize("shape,k", [("2x1", 2), ("1x2", 2), ("2x2", 4)])
@pytest.mark.parametrize("topo", ["complete", "er"])
def test_pod_sweep(ref, port_runs, shape, k, topo):
    """The pod sweep on a hybrid mesh equals the reference's
    ``config_sweep_curves_2d`` on its 2 x 2 mesh, bitwise; its msgs and
    rounds equal the port's 1-D batch, and its curves the 1-D batch's
    counts divided (the pod sweep's quotient where the 1-D batch
    multiplies by ``float32(1 / n)``)."""
    from gossip_tpu.parallel.multislice import make_hybrid_mesh
    pts = [SWP.SweepPoint(**p) for p in POD_POINTS]
    if topo not in _POD_REF:
        jt = (ref.G.complete(POD_N) if topo == "complete"
              else ref.G.erdos_renyi(POD_N, 0.03, seed=1))
        _POD_REF[topo] = ref.S.config_sweep_curves_2d(
            [ref.S.SweepPoint(**p) for p in POD_POINTS], jt,
            ref.C.RunConfig(max_rounds=ROUNDS),
            make_hybrid_mesh(2, 2, axis_names=("sweep", "nodes")))
    want = _POD_REF[topo]
    t = (G.complete(POD_N) if topo == "complete"
         else G.erdos_renyi(POD_N, 0.03, seed=1, device=CPU))
    one = SWP.config_sweep_curves(pts, t, TC.RunConfig(max_rounds=ROUNDS),
                                  device=CPU)
    counts = np.rint(one.curves.astype(np.float64) * POD_N)
    for curves, msgs in port_runs[k][f"pod-{shape}-{topo}"]:
        np.testing.assert_array_equal(curves, want.curves)
        np.testing.assert_array_equal(msgs, want.msgs)
        np.testing.assert_array_equal(msgs, one.msgs)
        np.testing.assert_array_equal(
            curves, counts.astype(np.float32) / np.float32(POD_N))


# -- the draw -----------------------------------------------------------------

@pytest.mark.parametrize("graph", ["complete", "explicit", "bound"])
def test_k_max_draw_prefix(graph):
    """A point of fanout f drawing k_max = 3 columns gets its solo
    f-wide draw in the first f (the threefry counter is per element);
    a per-point tensor bound draws as the static n does."""
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2**31, size=3).tolist()
    keys = torch.stack([threefry.key(s, CPU) for s in seeds])[:, None]
    ids = torch.arange(N, dtype=torch.int64)
    if graph == "explicit":
        t = G.erdos_renyi(N, 0.03, seed=2, device=CPU)

        def draw(k):
            return sample_peers_table(keys, ids, t.nbrs, t.deg, k, N)
    elif graph == "bound":
        bound = torch.full((3, 1, 1), N, dtype=torch.int64)

        def draw(k):
            return sample_peers_complete(keys, ids, bound, k, True)
    else:
        def draw(k):
            return sample_peers_complete(keys, ids, N, k, True)
    wide = draw(3)
    assert torch.equal(wide[..., :1], draw(1))
    assert torch.equal(wide, sample_peers_complete(keys, ids, N, 3, True)) \
        or graph == "explicit"
    for s, seed in enumerate(seeds):          # a point is its solo draw
        solo = (sample_peers_table(threefry.key(seed, CPU), ids, t.nbrs,
                                   t.deg, 1, N) if graph == "explicit"
                else sample_peers_complete(threefry.key(seed, CPU), ids, N,
                                           1, True))
        assert torch.equal(wide[s, :, :1], solo)


def test_stacked_table_draw_is_the_solo_table_draw():
    """The stacked families' draw, read through each point's family,
    equals the solo table draw on that family."""
    topos = _topos("families", G, device=CPU)
    nbrs, deg = SWP._stack_topologies(topos, CPU)
    keys = torch.stack([threefry.key(s, CPU) for s in (1, 2, 3)])[:, None]
    tidx = torch.tensor([2, 0, 1])
    ids = torch.arange(N, dtype=torch.int64)
    got = SWP._stack_peers(keys, ids, nbrs, deg[tidx], tidx, 2, N)
    for s in range(3):
        t = topos[int(tidx[s])]
        want = sample_peers_table(keys[s:s + 1], ids, t.nbrs, t.deg, 2, N)
        assert torch.equal(got[s:s + 1], want)


# -- validation ---------------------------------------------------------

@pytest.mark.parametrize("kw,phrase", [
    (dict(mode="flood"), "config sweep supports"),
    (dict(fanout=0), "fanout must be >= 1"),
    (dict(period=0), "period must be >= 1"),
    (dict(mode="push", period=2), "period > 1 is the anti-entropy cadence"),
    (dict(topo_idx=-1), "topo_idx must be >= 0"),
    (dict(rumors=-1), "rumors must be >= 0"),
], ids=["mode", "fanout", "period", "cadence", "topo_idx", "rumors"])
def test_sweep_point_validation(ref, kw, phrase):
    """``SweepPoint`` refuses what the reference's refuses, in its
    words."""
    with pytest.raises(ValueError) as e:
        SWP.SweepPoint(**kw)
    with pytest.raises(ValueError) as je:
        ref.S.SweepPoint(**kw)
    assert phrase in str(e.value) and str(e.value) == str(je.value)


def _batch_refusal(ref, case):
    """(port call, reference call) of a batch the reference refuses."""
    run, jrun = TC.RunConfig(max_rounds=2), ref.C.RunConfig(max_rounds=2)
    pts = [dict(mode="pull")]
    topo, jtopo = G.complete(N), ref.G.complete(N)
    fault = jfault = None
    k_max = None
    if case == "mixed-kinds":
        topo = [G.complete(N), G.ring(N, 4, device=CPU)]
        jtopo = [ref.G.complete(N), ref.G.ring(N, 4)]
    elif case == "topo-idx":
        pts = [dict(mode="pull", topo_idx=2)]
    elif case == "churn":
        fault = TC.FaultConfig(churn=TC.ChurnConfig(events=((3, 1, 4),)))
        jfault = ref.C.FaultConfig(churn=ref.C.ChurnConfig(
            events=((3, 1, 4),)))
    elif case == "fault-drop":
        fault, jfault = (TC.FaultConfig(drop_prob=0.1),
                         ref.C.FaultConfig(drop_prob=0.1))
    elif case == "ragged-fault":
        topo = [G.ring(600, 4, device=CPU), G.ring(N, 4, device=CPU)]
        jtopo = [ref.G.ring(600, 4), ref.G.ring(N, 4)]
        fault = TC.FaultConfig(node_death_rate=0.1)
        jfault = ref.C.FaultConfig(node_death_rate=0.1)
    elif case == "k-max":
        pts, k_max = [dict(mode="pull", fanout=3)], 2
    elif case == "empty":
        pts = []
    points = [SWP.SweepPoint(**p) for p in pts]
    jpoints = [ref.S.SweepPoint(**p) for p in pts]
    return (lambda: SWP.config_sweep_curves(points, topo, run, fault,
                                            k_max, device=CPU),
            lambda: ref.S.config_sweep_curves(jpoints, jtopo, jrun, jfault,
                                              k_max))


@pytest.mark.parametrize("case", ["mixed-kinds", "topo-idx", "churn",
                                  "fault-drop", "ragged-fault", "k-max",
                                  "empty"])
def test_config_sweep_refusals(ref, case):
    """Every batch the reference refuses is refused, in its words: a
    mixed implicit/explicit topology batch never falls back to solo runs,
    and a fault program is refused (its ``test_nemesis.py``)."""
    port, jax_call = _batch_refusal(ref, case)
    with pytest.raises(ValueError) as e:
        port()
    with pytest.raises(ValueError) as je:
        jax_call()
    assert str(e.value) == str(je.value)


def test_stack_refuses_an_implicit_entry(ref):
    with pytest.raises(ValueError) as e:
        SWP._stack_topologies([G.ring(N, 4, device=CPU), G.complete(N)],
                              CPU)
    with pytest.raises(ValueError) as je:
        ref.S._stack_topologies([ref.G.ring(N, 4), ref.G.complete(N)])
    assert str(e.value) == str(je.value)


def test_stacked_tables_equal_reference(ref):
    """The family stack: sentinel columns and phantom rows as the
    reference pads them."""
    got = SWP._stack_topologies(_topos("ns-explicit", G, device=CPU), CPU)
    want = ref.S._stack_topologies(_topos("ns-explicit", ref.G))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["rumors", "ns"])
def test_pod_sweep_refusals(ref, case):
    """The pod sweep carries one rumor axis and one n, in the
    reference's words."""
    mesh = MSL.HybridMesh((0, 0), types.SimpleNamespace(size=1),
                          types.SimpleNamespace(size=1))
    if case == "rumors":
        pts = [SWP.SweepPoint(rumors=1), SWP.SweepPoint(rumors=2)]
        topo = G.complete(N)
        phrase = "the 2-D pod sweep carries ONE rumor axis"
    else:
        pts = [SWP.SweepPoint(topo_idx=1)]
        topo = [G.ring(600, 4, device=CPU), G.ring(N, 4, device=CPU)]
        phrase = "the 2-D pod sweep shards ONE node dimension"
    with pytest.raises(ValueError, match=phrase):
        SWP.config_sweep_curves_2d(pts, topo, TC.RunConfig(max_rounds=2),
                                   mesh)


# -- the command line --------------------------------------------------------

GRID_LINES = [
    ["grid", "--n", "1000", "--max-rounds", "24", "--drops", "0", "0.1",
     "--curve"],
    ["grid", "--modes", "pull", "antientropy", "--families", "ring",
     "erdos_renyi", "--n", "800", "--max-rounds", "16", "--periods", "1",
     "3"],
    ["grid", "--modes", "push", "--ns", "600", "1000", "--rumors", "1", "2",
     "--max-rounds", "16"],
]


@pytest.mark.parametrize("argv", GRID_LINES, ids=["drops", "families",
                                                  "ns-rumors"])
def test_grid_command_equals_reference(ref, capsys, argv):
    """``grid``: one line a point, every key and value the reference
    command's."""
    from gossip_tpu import cli as JCLI
    assert JCLI.main(argv) == 0
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert TCLI.main([*argv, "--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert got == want


def test_grid_rumors_must_be_positive(capsys):
    assert TCLI.main(["grid", "--rumors", "0", "--device", "cpu"]) == 2
    assert "--rumors values must be >= 1" in capsys.readouterr().err
