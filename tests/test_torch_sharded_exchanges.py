"""The port's sparse and halo exchanges (``parallel/sharded_sparse.py``,
``parallel/halo.py``) against the JAX package's on its K-device CPU mesh,
against its single-device twins, and against the port's own
single-device rounds.

The port runs K in {2, 4} ranks under gloo, spawned.  Every port call of
this file that needs a mesh runs once a test session, in one spawn for
each K (:func:`port_runs`; under xdist the first worker to need it
computes it and the others read it), and each test compares its share.
The spawned ranks import this module for :func:`_port_worker`, so its top
level imports torch, numpy and the port only; the JAX package comes in
through the ``ref`` fixture, with its executable store off.

The reference's own cases are mirrored: ``tests/test_sharded_sparse.py``
(the complete-graph exchange with k 1 and 2, 40 rumors, deaths with
drops, anti-entropy with period 2; ER, Watts-Strogatz and power-law
tables, pull and anti-entropy, drops; deterministic overflow at a small
``cap``; the rejections; dead nodes dark), ``tests/test_halo.py`` (its
eight cases, the wraparound, the constraint errors, ``band_of``) and
the churn surfaces ``sparse_mesh``, ``sparse_reference`` and
``halo_sharded`` (``tests/_churn_surfaces.py``: a program whose events
recover).

Tolerances: bitwise for the whole padded state, the rounds, the
coverage, the curves, ``msgs``, ``lost`` and ``overflow``.  Every sum
here stays below 2^24, where the float32 rule of
``gossip_tpu_torch.ops.common`` makes them exact.
"""

import functools
import json
import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import cli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import si as TSI
from gossip_tpu_torch.models.state import init_state, state_to_numpy
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import halo as HL
from gossip_tpu_torch.parallel import sharded as SH
from gossip_tpu_torch.parallel import sharded_sparse as SS
from gossip_tpu_torch.topology import generators as G

KS = (2, 4)
CPU = torch.device("cpu")
STEPS = 6
SEED = 11


def _heal(cut):
    """The churn surfaces' program: a crash that recovers, a permanent
    crash, a cut window and a drop ramp, over static deaths and drops."""
    return dict(node_death_rate=0.1, drop_prob=0.05, seed=1, churn=dict(
        events=((3, 2, 5), (7, 1, -1)), partitions=((2, 6, cut),),
        ramp=(1, 4, 0.0, 0.3)))


# the complete-graph exchange's step cases (tests/test_sharded_sparse.py
# at n = 256, period 2; the churn surface sparse_mesh at n = 64)
SPARSE = [
    ("pull-k1", dict(mode="pull", fanout=1, rumors=1, period=2), 256, None),
    ("pull-k2-r40", dict(mode="pull", fanout=2, rumors=40, period=2), 256,
     None),
    ("pull-death-drop", dict(mode="pull", fanout=1, rumors=1, period=2), 256,
     dict(node_death_rate=0.1, drop_prob=0.2, seed=3)),
    ("ae-p2", dict(mode="antientropy", fanout=1, rumors=5, period=2), 256,
     None),
    ("ae-heal", dict(mode="antientropy", fanout=2, rumors=3, period=2), 64,
     _heal(32)),
]

# the explicit-table exchange's step cases: (name, proto, topology,
# fault, cap)
TOPO = [
    ("er-pull", dict(mode="pull", fanout=1, rumors=1),
     ("erdos_renyi", 256, 0.05, 7), None, None),
    ("er-pull-k2-r40", dict(mode="pull", fanout=2, rumors=40),
     ("erdos_renyi", 256, 0.05, 7), None, None),
    ("ws-pull-death-drop", dict(mode="pull", fanout=1, rumors=5),
     ("watts_strogatz", 256, 6, 0.1, 7),
     dict(node_death_rate=0.1, drop_prob=0.2, seed=3), None),
    ("pl-pull", dict(mode="pull", fanout=1, rumors=1),
     ("power_law", 256, 3, 7), None, None),
    ("er-ae", dict(mode="antientropy", fanout=1, rumors=5, period=2),
     ("erdos_renyi", 256, 0.05, 7), None, None),
    ("ws-ae-drop", dict(mode="antientropy", fanout=2, rumors=3, period=2),
     ("watts_strogatz", 256, 6, 0.1, 7), dict(drop_prob=0.15, seed=5),
     None),
    # far below the balanced load: overflow drops, deterministic
    ("er-overflow", dict(mode="pull", fanout=2, rumors=1),
     ("erdos_renyi", 256, 0.08, 2), None, 2),
]

# tests/test_halo.py's eight cases (10 rounds, seed 7), and the churn
# surface halo_sharded
HALO = [
    ("flood-ring", dict(mode="flood"), ("ring", 128, 4), None),
    ("flood-grid", dict(mode="flood"), ("grid2d", 8, 16), None),
    ("flood-drop-death", dict(mode="flood"), ("ring", 128, 6),
     dict(node_death_rate=0.1, drop_prob=0.2, seed=3)),
    ("pull-ws-lattice", dict(mode="pull", fanout=2, rumors=3),
     ("watts_strogatz", 128, 6, 0.0, 1), None),
    ("pull-drop", dict(mode="pull", fanout=1), ("ring", 128, 4),
     dict(drop_prob=0.3, seed=5)),
    ("push-ring", dict(mode="push", fanout=2), ("ring", 128, 6), None),
    ("push-drop-death", dict(mode="push", fanout=1), ("grid2d", 8, 16),
     dict(node_death_rate=0.1, drop_prob=0.2, seed=4)),
    ("pushpull-ws", dict(mode="pushpull", fanout=1, rumors=2),
     ("watts_strogatz", 128, 6, 0.0, 2), None),
    ("pushpull-heal", dict(mode="pushpull", fanout=2, rumors=2),
     ("ring", 64, 4), _heal(32)),
    ("flood-heal", dict(mode="flood", rumors=2), ("ring", 64, 4),
     _heal(32)),
]
HALO_ROUNDS = 10

# the loops: (name, driver, proto, topology, fault, run)
DRIVERS = [
    ("until-sparse-r40", "sparse", dict(mode="pull", rumors=40),
     ("complete", 256), None, dict(seed=2, max_rounds=60)),
    ("until-sparse-heal", "sparse", dict(mode="pull", fanout=2),
     ("complete", 246), _heal(123), dict(seed=3, max_rounds=40)),
    ("curve-sparse-ae-heal", "sparse-curve",
     dict(mode="antientropy", fanout=2, rumors=3, period=2),
     ("complete", 256), _heal(128), dict(seed=3, max_rounds=12)),
    ("until-topo-ws-ae", "topo", dict(mode="antientropy", period=2),
     ("watts_strogatz", 250, 6, 0.1, 7), None, dict(seed=2, max_rounds=60)),
    ("curve-topo-er-death", "topo-curve", dict(mode="pull", rumors=3),
     ("erdos_renyi", 256, 0.05, 7), dict(node_death_rate=0.1, seed=2),
     dict(seed=1, max_rounds=12)),
    ("until-halo-ring", "halo", dict(mode="pushpull", fanout=2),
     ("ring", 128, 6), None, dict(seed=2, max_rounds=60)),
    ("curve-halo-flood-heal", "halo-curve", dict(mode="flood"),
     ("ring", 128, 4), _heal(64), dict(seed=3, max_rounds=12)),
]
DRIVER_IDS = [d[0] for d in DRIVERS]

# the stop test's boundaries: (driver, fault kind) at K = 2, n = 1000
BOUNDARY_N = 1000
BOUNDARY_KINDS = [("sparse", f) for f in ("none", "death", "prog",
                                          "prog-death")] + \
    [("topo", f) for f in ("none", "death")] + \
    [("halo", f) for f in ("none", "death", "prog", "prog-death")]


def _topo(spec, gen, **device):
    """The topology of ``spec`` from the generators ``gen`` (the port's
    take ``device=``)."""
    kind, n, *rest = spec
    return {"complete": lambda: gen.complete(n),
            "ring": lambda: gen.ring(n, *rest, **device),
            "grid2d": lambda: gen.grid2d(n, rest[0], **device),
            "erdos_renyi": lambda: gen.erdos_renyi(n, rest[0], seed=rest[1],
                                                   **device),
            "watts_strogatz": lambda: gen.watts_strogatz(
                n, rest[0], rest[1], seed=rest[2], **device),
            "power_law": lambda: gen.power_law(n, rest[0], seed=rest[1],
                                               **device)}[kind]()


def _fault(spec, cfg):
    if spec is None:
        return None
    spec = dict(spec)
    churn = spec.pop("churn", None)
    if churn is not None:
        spec["churn"] = cfg.ChurnConfig(**churn)
    return cfg.FaultConfig(**spec)


def _boundary_fault(kind):
    program = dict(events=((3, 1, 4), (7, 2, -1)))
    return {"none": None, "death": dict(node_death_rate=0.1, seed=1),
            "prog": dict(seed=1, churn=program),
            "prog-death": dict(node_death_rate=0.1, seed=1,
                               churn=program)}[kind]


def _boundary_setup(driver, kind):
    proto = dict(mode="pushpull" if driver == "halo" else "pull")
    topo = (("ring", BOUNDARY_N, 6) if driver == "halo"
            else ("complete", BOUNDARY_N) if driver == "sparse"
            else ("erdos_renyi", BOUNDARY_N, 0.01, 2))
    return proto, topo, _boundary_fault(kind)


@functools.lru_cache(maxsize=None)
def _boundary_runs():
    """For each driver and kind of alive set, a seed and a target on an
    ulp boundary of the stop test at K = 2: the first round whose count
    c of the alive count A has ``float32(c) * float32(1/A) !=
    float32(c) / float32(A)``, the target the larger, so the compiled
    product and quotient stop on different rounds.  Found on the port's
    single-device twins (the sparse trajectories at p = 2) and rounds
    (the halo's), which the mesh runs equal."""
    out = []
    for driver, kind in BOUNDARY_KINDS:
        proto, spec, fspec = _boundary_setup(driver, kind)
        fault = _fault(fspec, TC)
        tp = TC.ProtocolConfig(**proto)
        alive = SH.metric_alive_pad(fault, BOUNDARY_N, BOUNDARY_N, 0, CPU)
        total = int(alive.sum())
        topo = _topo(spec, G, device=CPU)
        found = None
        for seed in range(5, 40):
            run = TC.RunConfig(seed=seed)
            if driver == "halo":
                step = TSI.make_si_round(tp, topo, fault, 0, CPU)
                state = init_state(run, tp, BOUNDARY_N, CPU)
            elif driver == "sparse":
                step = SS.sparse_pull_round_reference(tp, BOUNDARY_N, 2,
                                                      fault, device=CPU)
                state = SS.init_sparse_state(run, tp, BOUNDARY_N, p=2,
                                             device=CPU)
            else:
                twin = SS.sparse_topo_pull_round_reference(tp, topo, 2,
                                                           fault, device=CPU)
                ovf = torch.zeros(())

                def step(s, twin=twin):
                    return twin(s, ovf)[0]
                state = SS.init_sparse_state(run, tp, BOUNDARY_N, p=2,
                                             device=CPU)
            for r in range(1, 40):
                state = step(state)
                if type(state) is tuple:
                    state = state[0]
                seen = (state.seen if state.seen.dtype == torch.bool
                        else state.seen & 1 != 0)
                c = int((seen[:, 0] & alive).sum())
                prod = np.float32(c) * (np.float32(1) / np.float32(total))
                quot = np.float32(c) / np.float32(total)
                if prod != quot:
                    found = (seed, r, float(max(prod, quot)),
                             bool(prod > quot))
                    break
            if found:
                break
        assert found, (driver, kind)
        out.append((driver, kind) + found)
    return out


def _steps(step, state, rounds, extra=None):
    """Each round's ``(seen, msgs, lost or overflow)`` of a step, as
    numpy values."""
    out = []
    for _ in range(rounds):
        if extra is None:
            res = step(state)
            state, aux = res if type(res) is tuple else (res, 0.0)
        else:
            state, extra = step(state, extra)
            aux = extra
        seen, _, _, msgs = state_to_numpy(state)
        out.append((seen, float(msgs), float(aux)))
    return out


def _port_worker(calls, group):
    """One rank's share of every port call (runs in the spawned ranks)."""
    out = {}
    for name, kind, proto, topo, fault, run, extra in calls:
        proto = TC.ProtocolConfig(**proto)
        fault = _fault(fault, TC)
        run = TC.RunConfig(**run)
        t = _topo(topo, G, device=group.device)
        if kind == "sparse-steps":
            step = SS.make_sparse_pull_round(proto, t.n, group, fault,
                                             run.origin)
            state = SS.init_sparse_state(run, proto, t.n, group)
            out[name] = _steps(step, state, run.max_rounds)
        elif kind == "topo-steps":
            step = SS.make_sparse_topo_pull_round(proto, t, group, fault,
                                                  run.origin, cap=extra)
            state = SS.init_sparse_state(run, proto, t.n, group)
            out[name] = _steps(step, state, run.max_rounds,
                               torch.zeros((), device=group.device))
        elif kind == "halo-steps":
            step = HL.make_halo_round(proto, t, group, fault, run.origin)
            state = SH.init_sharded_state(run, proto, t, group)
            out[name] = _steps(step, state, run.max_rounds)
        elif kind == "sparse":
            out[name] = SS.simulate_until_sparse(proto, t.n, run, group,
                                                 fault)
        elif kind == "sparse-curve":
            out[name] = SS.simulate_curve_sparse(proto, t.n, run, group,
                                                 fault)
        elif kind == "topo":
            out[name] = SS.simulate_until_topo_sparse(proto, t, run, group,
                                                      fault)
        elif kind == "topo-curve":
            out[name] = SS.simulate_curve_topo_sparse(proto, t, run, group,
                                                      fault)
        elif kind == "halo":
            out[name] = HL.simulate_until_halo(proto, t, run, group, fault)
        else:                                   # "halo-curve"
            out[name] = HL.simulate_curve_halo(proto, t, run, group, fault)
    return out


def _calls(k):
    calls = [(name, "sparse-steps", proto, ("complete", n), fault,
              dict(seed=SEED, max_rounds=STEPS), None)
             for name, proto, n, fault in SPARSE]
    calls += [(name, "topo-steps", proto, topo, fault,
               dict(seed=SEED if cap is None else 4,
                    max_rounds=STEPS if cap is None else 5), cap)
              for name, proto, topo, fault, cap in TOPO]
    calls += [(name, "halo-steps", proto, topo, fault,
               dict(seed=7, max_rounds=HALO_ROUNDS), None)
              for name, proto, topo, fault in HALO]
    calls += [("wraparound", "halo-steps", dict(mode="flood"), ("ring", 64, 2),
               None, dict(seed=0, max_rounds=3), None),
              ("dark-sparse", "sparse-steps", dict(mode="pull"),
               ("complete", 256), dict(node_death_rate=0.3, seed=9),
               dict(seed=2, max_rounds=16), None),
              ("dark-topo", "topo-steps", dict(mode="pull"),
               ("erdos_renyi", 256, 0.08, 5),
               dict(node_death_rate=0.3, seed=9),
               dict(seed=2, max_rounds=16), None)]
    calls += [(name, kind, proto, topo, fault, run, None)
              for name, kind, proto, topo, fault, run in DRIVERS]
    if k == 4:
        calls += [("surface-sparse", "sparse-steps",
                   dict(mode="antientropy", fanout=2, rumors=3, period=2),
                   ("complete", 64), _heal(32), dict(seed=0, max_rounds=4),
                   None),
                  ("surface-halo", "halo-curve",
                   dict(mode="pushpull", fanout=2, rumors=2), ("ring", 64, 4),
                   _heal(32), dict(seed=0, max_rounds=10), None)]
    if k == 2:
        for driver, kind, seed, _, target, _ in _boundary_runs():
            proto, topo, fault = _boundary_setup(driver, kind)
            calls.append((f"boundary-{driver}-{kind}", driver, proto, topo,
                          fault, dict(seed=seed, max_rounds=40,
                                      target_coverage=target), None))
    return calls


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    """``{K: {name: per-rank results}}`` for every call of this file,
    one spawn for each K, once a session (shared through a file by the
    xdist workers of one run)."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_exchanges_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _port_worker, k, _calls(k),
                                     device="cpu") for k in KS}
            runs = {k: {name: [r[name] for r in f.result()]
                        for name in f.result()[0]}
                    for k, f in spawns.items()}
        path.write_bytes(pickle.dumps(runs))
    return runs


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules, imported here and not at module level
    (the spawned ranks import this module)."""
    import jax
    from gossip_tpu import config as JC
    from gossip_tpu.models import si as JSI
    from gossip_tpu.models import state as JST
    from gossip_tpu.parallel import halo as JH
    from gossip_tpu.parallel import sharded as JSH
    from gossip_tpu.parallel import sharded_sparse as JS
    from gossip_tpu.topology import generators as JG
    return types.SimpleNamespace(jax=jax, C=JC, SI=JSI, ST=JST, H=JH,
                                 SH=JSH, S=JS, G=JG)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _jsteps(ref, step, state, rounds, extra=None):
    """:func:`_steps` of a reference step under ``jax.jit``."""
    step = ref.jax.jit(step)
    out = []
    for _ in range(rounds):
        if extra is None:
            res = step(state)
            state, aux = res if type(res) is tuple else (res, 0.0)
        else:
            state, extra = step(state, extra)
            aux = extra
        out.append((np.asarray(state.seen), float(state.msgs), float(aux)))
    return out


def _gathered(per_rank):
    """Each round's padded global state, msgs and aux from every rank's
    :func:`_steps` (the ranks agree on msgs and aux)."""
    rounds = []
    for r in range(len(per_rank[0])):
        parts = [rank[r] for rank in per_rank]
        assert len({(p[1], p[2]) for p in parts}) == 1
        rounds.append((np.concatenate([p[0] for p in parts]),
                       parts[0][1], parts[0][2]))
    return rounds


def _assert_rounds_equal(got, want):
    assert len(got) == len(want)
    for r, ((gs, gm, ga), (ws, wm, wa)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gs, ws, err_msg=f"round {r + 1}")
        assert (gm, ga) == (wm, wa), f"round {r + 1}"


def _sparse_ref(ref, proto, n, fault, k, mesh):
    jp, jf = ref.C.ProtocolConfig(**proto), _fault(fault, ref.C)
    run = ref.C.RunConfig(seed=SEED)
    if mesh:
        m = ref.SH.make_mesh(k)
        return _jsteps(ref, ref.S.make_sparse_pull_round(jp, n, m, jf, 0),
                       ref.S.init_sparse_state(run, jp, n, m), STEPS)
    return _jsteps(ref, ref.S.sparse_pull_round_reference(jp, n, k, jf, 0),
                   ref.S.init_sparse_state(run, jp, n, p=k), STEPS)


def _topo_ref(ref, proto, topo, fault, cap, k, mesh):
    jp, jf = ref.C.ProtocolConfig(**proto), _fault(fault, ref.C)
    jt = _topo(topo, ref.G)
    run = ref.C.RunConfig(seed=SEED if cap is None else 4)
    rounds = STEPS if cap is None else 5
    zero = ref.jax.numpy.float32(0.0)
    if mesh:
        m = ref.SH.make_mesh(k)
        step = ref.S.make_sparse_topo_pull_round(jp, jt, m, jf, 0, cap=cap)
        return _jsteps(ref, step, ref.S.init_sparse_state(run, jp, jt.n, m),
                       rounds, zero)
    step = ref.S.sparse_topo_pull_round_reference(jp, jt, k, jf, 0, cap=cap)
    return _jsteps(ref, step, ref.S.init_sparse_state(run, jp, jt.n, p=k),
                   rounds, zero)


# -- threefry's permutation, the twins in-process ---------------------------

@pytest.mark.parametrize("name,proto,n,fault", SPARSE,
                         ids=[c[0] for c in SPARSE])
@pytest.mark.parametrize("p", KS)
def test_sparse_twin_equals_reference_twin(ref, p, name, proto, n, fault):
    """The port's single-device twin of the complete-graph exchange
    equals the reference's (``sparse_pull_round_reference`` under
    ``jax.jit``) round by round: state, msgs and ``lost``."""
    tp = TC.ProtocolConfig(**proto)
    step = SS.sparse_pull_round_reference(tp, n, p, _fault(fault, TC),
                                          device=CPU)
    got = _steps(step, SS.init_sparse_state(TC.RunConfig(seed=SEED), tp, n,
                                            p=p, device=CPU), STEPS)
    _assert_rounds_equal(got, _sparse_ref(ref, proto, n, fault, p, False))


@pytest.mark.parametrize("name,proto,topo,fault,cap", TOPO,
                         ids=[c[0] for c in TOPO])
@pytest.mark.parametrize("p", KS)
def test_topo_twin_equals_reference_twin(ref, p, name, proto, topo, fault,
                                         cap):
    """The port's twin of the explicit-table exchange equals the
    reference's round by round: state, msgs and the overflow count."""
    tp = TC.ProtocolConfig(**proto)
    t = _topo(topo, G, device=CPU)
    step = SS.sparse_topo_pull_round_reference(tp, t, p, _fault(fault, TC),
                                               cap=cap, device=CPU)
    run = TC.RunConfig(seed=SEED if cap is None else 4)
    got = _steps(step, SS.init_sparse_state(run, tp, t.n, p=p, device=CPU),
                 STEPS if cap is None else 5, torch.zeros(()))
    _assert_rounds_equal(got, _topo_ref(ref, proto, topo, fault, cap, p,
                                        False))


@pytest.mark.parametrize("p", [1, 2, 4, 8, 2000])
def test_round_draws_equal_reference(ref, p):
    """The round's rank permutation and group offset equal the
    reference's ``_round_draws`` over several round keys."""
    from gossip_tpu_torch.ops import threefry
    jax = ref.jax
    for r in range(6):
        jkey = jax.random.fold_in(jax.random.key(3), r)
        pi, o = ref.S._round_draws(jkey, p)
        tpi, to = SS._round_draws(threefry.fold_in(threefry.key(3), r), p)
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(pi))
        assert int(to) == int(o)


def test_auto_topo_cap_equals_reference(ref):
    """The table-derived bucket capacity on ER, WS and power-law tables at
    K = 2, 4 and 8, and the band of the reference's test tables."""
    for spec in (("erdos_renyi", 1000, 0.01, 2),
                 ("watts_strogatz", 1000, 6, 0.1, 7),
                 ("power_law", 1000, 3, 7)):
        t, jt = _topo(spec, G, device=CPU), _topo(spec, ref.G)
        for p in (2, 4, 8):
            for k in (1, 2):
                assert SS.resolve_topo_cap(t, p, k) == \
                    ref.S.resolve_topo_cap(jt, p, k)
    assert SS.sparse_meta(1000, 2, 2, 2, True) == \
        tuple(ref.S.sparse_meta(1000, 2, 2, 2, True))


def test_band_of():
    assert HL.band_of(G.ring(64, 4, device=CPU)) == 2
    assert HL.band_of(G.ring(64, 6, device=CPU)) == 3
    assert HL.band_of(G.grid2d(8, 8, device=CPU)) == 8
    assert HL.band_of(G.watts_strogatz(64, 4, beta=0.0, seed=0,
                                       device=CPU)) == 2
    with pytest.raises(ValueError, match="undefined"):
        HL.band_of(G.complete(16))


# -- the mesh runs against the reference ------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,n,fault", SPARSE,
                         ids=[c[0] for c in SPARSE])
def test_sparse_mesh_equals_reference(port_runs, ref, k, name, proto, n,
                                      fault):
    """Six rounds of the complete-graph exchange on K gloo ranks: each
    round's padded state, msgs and ``lost`` equal the reference's mesh
    round on ``make_mesh(K)`` and the port's single-device twin at p = K,
    which equals the reference's twin
    (:func:`test_sparse_twin_equals_reference_twin`)."""
    got = _gathered(port_runs[k][name])
    _assert_rounds_equal(got, _sparse_ref(ref, proto, n, fault, k, True))
    tp = TC.ProtocolConfig(**proto)
    twin = SS.sparse_pull_round_reference(tp, n, k, _fault(fault, TC),
                                          device=CPU)
    _assert_rounds_equal(got, _steps(twin, SS.init_sparse_state(
        TC.RunConfig(seed=SEED), tp, n, p=k, device=CPU), STEPS))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,topo,fault,cap", TOPO,
                         ids=[c[0] for c in TOPO])
def test_topo_mesh_equals_reference(port_runs, ref, k, name, proto, topo,
                                    fault, cap):
    """The explicit-table exchange on K gloo ranks: each round's state,
    msgs and overflow count equal the reference's mesh round and the
    port's twin (equal to the reference's), the capacity drops and the
    anti-entropy reverse merge included; at ``cap = 2`` requests
    overflow."""
    got = _gathered(port_runs[k][name])
    _assert_rounds_equal(got, _topo_ref(ref, proto, topo, fault, cap, k,
                                        True))
    tp = TC.ProtocolConfig(**proto)
    t = _topo(topo, G, device=CPU)
    twin = SS.sparse_topo_pull_round_reference(tp, t, k, _fault(fault, TC),
                                               cap=cap, device=CPU)
    run = TC.RunConfig(seed=SEED if cap is None else 4)
    _assert_rounds_equal(got, _steps(
        twin, SS.init_sparse_state(run, tp, t.n, p=k, device=CPU),
        STEPS if cap is None else 5, torch.zeros(())))
    if cap is not None:
        assert got[-1][2] > 0
        assert got[-1][1] < 2.0 * 2 * topo[1] * 5


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,topo,fault", HALO,
                         ids=[c[0] for c in HALO])
def test_halo_equals_reference_and_single_device(port_runs, ref, k, name,
                                                 proto, topo, fault):
    """Ten halo rounds on K gloo ranks: each round's state, msgs and
    ``lost`` equal the reference's ``make_halo_round`` on ``make_mesh(K)``
    and the port's single-device round (the halo trajectory is the
    single-device one)."""
    got = _gathered(port_runs[k][name])
    jp, jf = ref.C.ProtocolConfig(**proto), _fault(fault, ref.C)
    jt = _topo(topo, ref.G)
    run = ref.C.RunConfig(seed=7)
    m = ref.SH.make_mesh(k)
    _assert_rounds_equal(got, _jsteps(
        ref, ref.H.make_halo_round(jp, jt, m, jf, 0),
        ref.SH.init_sharded_state(run, jp, jt, m), HALO_ROUNDS))
    tp = TC.ProtocolConfig(**proto)
    t = _topo(topo, G, device=CPU)
    one = _steps(TSI.make_si_round(tp, t, _fault(fault, TC), 0, CPU),
                 init_state(TC.RunConfig(seed=7), tp, t.n, CPU), HALO_ROUNDS)
    _assert_rounds_equal(got, one)


@pytest.mark.parametrize("k", KS)
def test_halo_wraparound(port_runs, k):
    """A rumor at node 0 crosses the 0 / n seam through the rank ring in
    both directions: after 3 flood rounds on ring(64, 2) exactly the
    nodes within 3 of node 0 hold it."""
    seen = _gathered(port_runs[k]["wraparound"])[-1][0][:, 0]
    expect = np.zeros(64, bool)
    expect[[d % 64 for d in range(-3, 4)]] = True
    np.testing.assert_array_equal(seen, expect)


@pytest.mark.parametrize("k", KS)
def test_dead_nodes_stay_dark(port_runs, ref, k):
    """Dead nodes never receive, on the complete graph and on a table;
    most of the alive ones do within 16 rounds; the final states equal
    the reference's mesh runs."""
    from gossip_tpu_torch.models.state import alive_mask
    fault = dict(node_death_rate=0.3, seed=9)
    alive = alive_mask(_fault(fault, TC), 256, 0, CPU).numpy()
    jp, jf = ref.C.ProtocolConfig(mode="pull"), _fault(fault, ref.C)
    run, m = ref.C.RunConfig(seed=2), ref.SH.make_mesh(k)
    zero = ref.jax.numpy.float32(0.0)
    jt = _topo(("erdos_renyi", 256, 0.08, 5), ref.G)
    want = {"dark-sparse": _jsteps(
        ref, ref.S.make_sparse_pull_round(jp, 256, m, jf, 0),
        ref.S.init_sparse_state(run, jp, 256, m), 16),
        "dark-topo": _jsteps(
        ref, ref.S.make_sparse_topo_pull_round(jp, jt, m, jf, 0),
        ref.S.init_sparse_state(run, jp, 256, m), 16, zero)}
    for name, share in (("dark-sparse", 0.9), ("dark-topo", 0.8)):
        got = _gathered(port_runs[k][name])
        _assert_rounds_equal(got, want[name])
        seen = got[-1][0][:256, 0] != 0
        assert not seen[~alive].any(), name
        assert seen[alive].mean() > share, name


@pytest.mark.parametrize("k", KS)
def test_padding_rows_stay_dark(port_runs, k):
    """Padding rows never receive: the step cases' and the sparse loops'
    rows past n are empty on every rank (246 and 250 nodes pad at
    K = 4)."""
    for name, proto, n, _ in SPARSE:
        for seen, _, _ in _gathered(port_runs[k][name]):
            assert seen.shape[0] % k == 0
            assert not seen[n:].any(), name
    for name, kind, _, topo, _, _ in DRIVERS:
        if not kind.startswith("halo"):
            col = 2 if kind.endswith("curve") else 3
            seen = _final_seen([r[col] for r in port_runs[k][name]])
            assert seen.shape[0] == -(-topo[1] // k) * k
            assert not seen[topo[1]:].any(), name


# -- the loops ----------------------------------------------------------------

def _ref_driver(ref, k, kind, proto, topo, fault, run):
    jp, jf = ref.C.ProtocolConfig(**proto), _fault(fault, ref.C)
    jr, jt = ref.C.RunConfig(**run), _topo(topo, ref.G)
    m = ref.SH.make_mesh(k)
    return {"sparse": lambda: ref.S.simulate_until_sparse(jp, jt.n, jr, m,
                                                          jf),
            "sparse-curve": lambda: ref.S.simulate_curve_sparse(
                jp, jt.n, jr, m, jf),
            "topo": lambda: ref.S.simulate_until_topo_sparse(jp, jt, jr, m,
                                                             jf),
            "topo-curve": lambda: ref.S.simulate_curve_topo_sparse(
                jp, jt, jr, m, jf),
            "halo": lambda: ref.H.simulate_until_halo(jp, jt, jr, m, jf),
            "halo-curve": lambda: ref.H.simulate_curve_halo(jp, jt, jr, m,
                                                            jf)}[kind]()


def _final_seen(states):
    return SH.state_from_ranks(states)[0]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,kind,proto,topo,fault,run", DRIVERS,
                         ids=DRIVER_IDS)
def test_drivers_equal_reference(port_runs, ref, k, name, kind, proto,
                                 topo, fault, run):
    """The until and curve loops of both exchanges, with and without a
    program: rounds, coverage, msgs (or the curves), the overflow (count
    or series), the traffic meta or band, and the whole padded final
    state equal the reference's loops on ``make_mesh(K)``."""
    got = port_runs[k][name]
    want = _ref_driver(ref, k, kind, proto, topo, fault, run)
    if kind.endswith("curve"):
        np.testing.assert_array_equal(got[0][0], want[0])
        np.testing.assert_array_equal(got[0][1], want[1])
        final, jfinal = [r[2] for r in got], want[2]
        tail, jtail = got[0][3:], want[3:]
    else:
        assert got[0][:3] == tuple(want[:3])
        final, jfinal = [r[3] for r in got], want[3]
        tail, jtail = got[0][4:], want[4:]
    np.testing.assert_array_equal(_final_seen(final), np.asarray(jfinal.seen))
    if kind.startswith("halo"):
        assert tail == tuple(jtail)                # the band
    else:
        assert tuple(tail[0]) == tuple(jtail[0])   # SparseMeta
        if kind.startswith("topo"):
            np.testing.assert_array_equal(np.asarray(tail[1]),
                                          np.asarray(jtail[1]))


@pytest.mark.parametrize("driver,kind", BOUNDARY_KINDS,
                         ids=[f"{d}-{f}" for d, f in BOUNDARY_KINDS])
def test_stop_test_is_the_compiled_condition(port_runs, ref, driver, kind):
    """At a target on an ulp boundary of the stop test, the sparse, the
    explicit-table and the halo loops stop on the reference's round at
    K = 2: its compiled loops multiply by the reciprocal of the alive
    count where no node can die and no program runs, and divide
    otherwise (``sharded_folded``, as its dense loops); the sparse
    reports carry the quotient, the halo's the mean's product where
    there is no alive set."""
    _, _, seed, stop, target, prod_larger = next(
        c for c in _boundary_runs() if c[:2] == (driver, kind))
    proto, topo, fault = _boundary_setup(driver, kind)
    run = dict(seed=seed, max_rounds=40, target_coverage=target)
    got = port_runs[2][f"boundary-{driver}-{kind}"][0]
    want = _ref_driver(ref, 2, driver, proto, topo, fault, run)
    assert got[:3] == tuple(want[:3])
    # the larger of the two values stops the loop on the boundary round,
    # the smaller one a round later
    folded = SH.sharded_folded(_fault(fault, TC))
    assert folded == (kind == "none")
    assert (got[0] == stop) == (folded == prod_larger)


# -- the churn surfaces -------------------------------------------------------

def test_churn_surfaces_equal_reference(port_runs):
    """The churn surfaces ``sparse_mesh`` / ``sparse_reference`` (anti-
    entropy, fanout 2, period 2, n = 64, four rounds under a program with
    a recovering event) and ``halo_sharded`` (push-pull on ring(64, 4),
    ten rounds) at K = 4, as ``tests/_churn_surfaces.py`` runs them: the
    digests of the port's arrays equal those of the reference's."""
    import _churn_surfaces as CS
    fault = CS._churn_fault()
    got = _gathered(port_runs[4]["surface-sparse"])
    digest = CS._digest(got[-1][0], np.asarray([g[2] for g in got],
                                               np.float32),
                        np.float32(got[-1][1]))
    assert digest == CS._sparse_mesh(fault) == CS._sparse_reference(fault)
    res = port_runs[4]["surface-halo"]
    assert CS._digest(res[0][0], res[0][1], _final_seen([r[2] for r in res]),
                      np.int32(res[0][3])) == CS._halo_sharded(fault)


# -- the command line and run_simulation --------------------------------------

_CLI = {
    "sparse": ["--mode", "pull", "--n", "1000", "--rumors", "40",
               "--exchange", "sparse", "--seed", "3", "--drop", "0.05"],
    "sparse-topo": ["--mode", "antientropy", "--period", "2", "--n", "1000",
                    "--family", "watts_strogatz", "--k", "6", "--p", "0.1",
                    "--exchange", "sparse"],
    "sparse-heal": ["--mode", "pull", "--n", "1000", "--exchange", "sparse",
                    "--churn-event", "1:1:4", "--churn-event", "2:2",
                    "--partition", "0:6:500", "--drop-ramp", "0:4:0:0.1",
                    "--curve", "--max-rounds", "20"],
    "halo": ["--mode", "pushpull", "--family", "ring", "--k", "6", "--n",
             "1000", "--exchange", "halo", "--max-rounds", "40"],
}


@pytest.mark.parametrize("case", sorted(_CLI))
def test_cli_exchanges_match_reference(capsys, case):
    """``run --devices 2 --exchange sparse|halo --device cpu`` exits 0 and
    prints the reference command's JSON on its 2-device mesh, field by
    field (the port's ``backend`` and wall aside), and of ``meta`` every
    key but the reference's compile timings: the exchange, its bytes a
    round or band, the bucket cap and overflow on a table."""
    from gossip_tpu import cli as jcli
    args = ["run", *_CLI[case], "--devices", "2"]
    capsys.readouterr()
    assert jcli.main(args + ["--no-compile-cache"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    skip = {"backend", "wall_s", "compile_cache", "meta"}
    assert {k: got[k] for k in want if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    timing = {"compile_s", "steady_wall_s", "driver_overhead_s",
              "topo_build_s"}
    assert {k: got["meta"][k] for k in want["meta"] if k not in timing} == \
        {k: v for k, v in want["meta"].items() if k not in timing}
    assert got["meta"]["process_group"] == "gloo"
    names = set(got["meta"]["collective_ms"])
    assert names >= ({"ppermute"} if case == "halo" else {"all_to_all"})
    assert "all_gather" in names                 # the float32 combine
    assert "reduce_scatter" not in names


@pytest.mark.parametrize("proto,tc,fault,match", [
    (dict(mode="push"), dict(n=256), None, "pull/anti-entropy path"),
    (dict(mode="pull"), dict(n=24), None, "balanced stratification"),
    (dict(mode="flood"), dict(family="ring", n=256, k=4), None,
     "pull and anti-entropy"),
    (dict(mode="pull"), dict(family="ring", n=256, k=4),
     dict(churn=dict(events=((1, 1, 4),))), "does not run churn"),
])
def test_sparse_refusals_use_reference_words(ref, proto, tc, fault, match):
    """What the sparse exchange cannot run is refused before any rank
    starts, in the words the reference's run raises (its message
    matches too), never run on the dense exchange."""
    from gossip_tpu_torch.backend import run_simulation
    mesh = TC.MeshConfig(n_devices=4, exchange="sparse")
    with pytest.raises(ValueError, match=match) as got:
        run_simulation(TC.ProtocolConfig(**proto), TC.TopologyConfig(**tc),
                       TC.RunConfig(engine="auto"), _fault(fault, TC),
                       device="cpu", mesh_cfg=mesh)
    from gossip_tpu.backend import run_simulation as jrun
    with pytest.raises(ValueError) as want:
        jrun("jax-tpu", ref.C.ProtocolConfig(**proto),
             ref.C.TopologyConfig(**tc), ref.C.RunConfig(engine="auto"),
             _fault(fault, ref.C), ref.C.MeshConfig(n_devices=4,
                                                    exchange="sparse"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("proto,topo,match", [
    (dict(mode="flood"), ("complete", 64), "needs an explicit"),
    (dict(mode="antientropy"), ("ring", 64, 2), "flood/pull"),
    (dict(mode="flood"), ("ring", 100, 2), "mesh size"),
    (dict(mode="flood"), ("erdos_renyi", 128, 0.1, 1), "band"),
])
def test_halo_constraint_errors(ref, proto, topo, match):
    """The halo's constraints, on a rank of an 8-rank mesh that no
    collective is asked of, in the reference's words."""
    group = GR.Group(0, 8, CPU, "gloo")
    with pytest.raises(ValueError, match=match) as got:
        HL.make_halo_round(TC.ProtocolConfig(**proto),
                           _topo(topo, G, device=CPU), group)
    with pytest.raises(ValueError) as want:
        ref.H.make_halo_round(ref.C.ProtocolConfig(**proto),
                              _topo(topo, ref.G), ref.SH.make_mesh(8))
    assert str(got.value) == str(want.value)


def test_sparse_round_rejections(ref):
    """``tests/test_sharded_sparse.py``'s rejections on an 8-rank group:
    push, unbalanced slots, and on a table push, flood and the implicit
    graph, in the reference's words."""
    group = GR.Group(0, 8, CPU, "gloo")
    mesh = ref.SH.make_mesh(8)
    table = ("erdos_renyi", 256, 0.05, 0)
    cases = [(SS.make_sparse_pull_round, ref.S.make_sparse_pull_round,
              dict(mode="push"), 256),
             (SS.make_sparse_pull_round, ref.S.make_sparse_pull_round,
              dict(mode="pull"), 32)]
    cases += [(SS.make_sparse_topo_pull_round,
               ref.S.make_sparse_topo_pull_round, dict(mode=m), table)
              for m in ("push", "flood")]
    cases.append((SS.make_sparse_topo_pull_round,
                  ref.S.make_sparse_topo_pull_round, dict(mode="pull"),
                  ("complete", 256)))
    for port_fn, ref_fn, proto, arg in cases:
        targ = arg if isinstance(arg, int) else _topo(arg, G, device=CPU)
        jarg = arg if isinstance(arg, int) else _topo(arg, ref.G)
        with pytest.raises(ValueError) as got:
            port_fn(TC.ProtocolConfig(**proto), targ, group)
        with pytest.raises(ValueError) as want:
            ref_fn(ref.C.ProtocolConfig(**proto), jarg, mesh)
        assert str(got.value) == str(want.value)
