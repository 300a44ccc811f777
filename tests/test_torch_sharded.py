"""The port's node-sharded SI drivers (``gossip_tpu_torch.parallel``)
against the JAX package's sharded drivers on its K-device CPU mesh, and
against the port's own single-device runs.

The port runs K in {2, 4} ranks under gloo, spawned.  Every port call of
this file runs once a test session, in one spawn for each K
(:func:`port_runs`; under xdist the first worker to need it computes it
and the others read it), and each test compares its share of it.  The
spawned ranks import this module for :func:`_port_worker`, so its top
level imports torch, numpy and the port only; the JAX package comes in
through the ``ref`` fixture, with its executable store off.

Tolerances: bitwise for ``seen`` and the packed words (padding rows
included), rounds, coverage, the curves, ``msgs`` and ``lost``.  Every
sum here stays below 2^24, where the float32 rule of
``gossip_tpu_torch.ops.common`` makes them exact.
"""

import functools
import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import si_packed as P
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import sharded as SH
from gossip_tpu_torch.parallel import sharded_packed as SP
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

KS = (2, 4)
CPU = torch.device("cpu")

# tests/test_sharding.py's eight cases, at node counts no K divides
CASES = [
    ("push-complete", dict(mode="push", fanout=2, rumors=3),
     ("complete", 97), None),
    ("pull-complete", dict(mode="pull", fanout=1, rumors=2),
     ("complete", 65), None),
    ("pushpull-er", dict(mode="pushpull", fanout=2),
     ("erdos_renyi", 121, 0.08, 3), None),
    ("flood-ring", dict(mode="flood"), ("ring", 97, 4), None),
    ("antientropy-ws", dict(mode="antientropy", fanout=1, period=2),
     ("watts_strogatz", 97, 4, 0.2, 1), None),
    ("push-drop-death", dict(mode="pushpull", fanout=2),
     ("erdos_renyi", 97, 0.1, 5),
     dict(node_death_rate=0.1, drop_prob=0.2, seed=7)),
    ("flood-drop", dict(mode="flood"), ("ring", 97, 4),
     dict(drop_prob=0.3, seed=2)),
    ("antientropy-fault", dict(mode="antientropy", fanout=1, period=2),
     ("watts_strogatz", 97, 4, 0.2, 1),
     dict(node_death_rate=0.15, drop_prob=0.1, seed=4)),
]
CASE_IDS = [c[0] for c in CASES]
ROUNDS, SEED = 6, 11


def _heal(n):
    """A churn_heal-style program: a crash that recovers, a permanent
    crash, a cut window and a drop ramp."""
    return dict(drop_prob=0.02, seed=3, churn=dict(
        events=((1, 1, 4), (2, 2, -1)), partitions=((0, 6, n // 2),),
        ramp=(0, 4, 0.0, 0.1)))


# (name, driver, proto, topology, fault, run): the drivers' cases
DRIVERS = [
    ("until-pull-40", "until", dict(mode="pull", rumors=40),
     ("complete", 201), None, dict(seed=2, max_rounds=60)),
    ("until-ae-40", "until", dict(mode="antientropy", rumors=40, period=2),
     ("complete", 201), None, dict(seed=2, max_rounds=60)),
    ("packed-pull-40", "packed", dict(mode="pull", rumors=40),
     ("complete", 201), None, dict(seed=2, max_rounds=60)),
    ("packed-ae-40", "packed", dict(mode="antientropy", rumors=40,
                                    period=2),
     ("complete", 201), None, dict(seed=2, max_rounds=60)),
    ("packed-pull-death", "packed", dict(mode="pull", rumors=3),
     ("erdos_renyi", 203, 0.05, 1),
     dict(node_death_rate=0.1, drop_prob=0.1, seed=5),
     dict(seed=4, max_rounds=60)),
    ("curve-pushpull", "curve", dict(mode="pushpull", fanout=2, rumors=2),
     ("complete", 301), None, dict(seed=1, max_rounds=12)),
    ("heal-until-pull", "until", dict(mode="pull"), ("complete", 203),
     _heal(203), dict(seed=3, max_rounds=40)),
    ("heal-packed-pull", "packed", dict(mode="pull", rumors=2),
     ("complete", 203), _heal(203), dict(seed=3, max_rounds=40)),
    ("heal-packed-ae", "packed", dict(mode="antientropy", period=2),
     ("complete", 203), _heal(203), dict(seed=3, max_rounds=40)),
    ("heal-curve-push", "curve", dict(mode="push", fanout=2),
     ("complete", 203), _heal(203), dict(seed=3, max_rounds=16)),
    ("heal-curve-flood", "curve", dict(mode="flood"), ("ring", 203, 4),
     _heal(203), dict(seed=3, max_rounds=12)),
]
DRIVER_IDS = [d[0] for d in DRIVERS]

# (name, proto, topology, fault): per-round lost under the program
LOST = [
    ("lost-pushpull", dict(mode="pushpull", fanout=2), ("complete", 203)),
    ("lost-flood", dict(mode="flood"), ("ring", 203, 4)),
    ("lost-packed-ae", dict(mode="antientropy", period=2),
     ("complete", 203)),
]
LOST_ROUNDS = 8


def _topo(spec, gen, **device):
    """The topology of ``spec`` from the generators ``gen`` (the port's
    take ``device=``)."""
    kind, n, *rest = spec
    return {"complete": lambda: gen.complete(n),
            "ring": lambda: gen.ring(n, *rest, **device),
            "erdos_renyi": lambda: gen.erdos_renyi(n, rest[0], seed=rest[1],
                                                   **device),
            "watts_strogatz": lambda: gen.watts_strogatz(
                n, rest[0], rest[1], seed=rest[2], **device)}[kind]()


def _fault(spec, cfg):
    if spec is None:
        return None
    spec = dict(spec)
    churn = spec.pop("churn", None)
    if churn is not None:
        spec["churn"] = cfg.ChurnConfig(**churn)
    return cfg.FaultConfig(**spec)


@functools.lru_cache(maxsize=None)
def _boundary_runs():
    """Targets on an ulp boundary of the stop test: for each kind of
    alive set, the first round whose count c of the alive count A has
    ``float32(c) * float32(1/A) != float32(c) / float32(A)``, with the
    target the larger, so the compiled product and quotient stop on
    different rounds.  Found on the port's single-device rounds (the
    sharded trajectory is the same)."""
    n = 1001
    out = []
    for death in (False, True):
        for churn in (False, True):
            spec = {}
            if death:
                spec["node_death_rate"] = 0.1
            if churn:
                spec["churn"] = dict(events=((3, 1, 4), (7, 2, -1)))
            spec = dict(spec, seed=1) if spec else None
            fault = _fault(spec, TC)
            proto = TC.ProtocolConfig(mode="pull")
            res = TS.simulate_curve(proto, G.complete(n),
                                    TC.RunConfig(seed=5, max_rounds=30),
                                    fault, CPU)
            alive = NE.metric_alive(fault, n, 0, CPU)
            total = n if alive is None else int(alive.sum())
            # the curve's coverage times the total is the count, exactly
            counts = [int(round(float(c) * total)) for c in res.coverage]
            for c in counts:
                prod = np.float32(c) * (np.float32(1) / np.float32(total))
                quot = np.float32(c) / np.float32(total)
                if prod != quot:
                    out.append((f"boundary-death{int(death)}-churn"
                                f"{int(churn)}", spec,
                                float(max(prod, quot))))
                    break
    return out


def _port_worker(calls, group):
    """One rank's share of every port call (runs in the spawned ranks)."""
    out = {}
    for name, kind, proto, topo, fault, run in calls:
        proto = TC.ProtocolConfig(**proto)
        topo = _topo(topo, G, device=group.device)
        fault = _fault(fault, TC)
        run = TC.RunConfig(**run)
        if kind == "curve":
            covs, msgs, final = SH.simulate_curve_sharded(proto, topo, run,
                                                          group, fault)
            out[name] = (covs, msgs, final)
        elif kind == "until":
            out[name] = SH.simulate_until_sharded(proto, topo, run, group,
                                                  fault)
        elif kind == "packed":
            out[name] = SP.simulate_until_packed_sharded(proto, topo, run,
                                                         group, fault)
        else:                           # "lost": the step's per-round lost
            factory = (SP.make_sharded_packed_round
                       if proto.mode == TC.ANTI_ENTROPY
                       else SH.make_sharded_si_round)
            init = (SP.init_sharded_packed_state
                    if proto.mode == TC.ANTI_ENTROPY
                    else SH.init_sharded_state)
            step = factory(proto, topo, group, fault, run.origin)
            state, lost = init(run, proto, topo, group), []
            for _ in range(run.max_rounds):
                state, lo = step(state)
                lost.append(float(lo))
            out[name] = (state, lost)
    return out


def _calls():
    calls = [(name, "curve", proto, topo, fault,
              dict(seed=SEED, max_rounds=ROUNDS))
             for name, proto, topo, fault in CASES]
    calls += [(name, kind, proto, topo, fault, run)
              for name, kind, proto, topo, fault, run in DRIVERS]
    calls += [(name, "lost", proto, topo, _heal(topo[1]),
               dict(seed=3, max_rounds=LOST_ROUNDS))
              for name, proto, topo in LOST]
    for name, spec, target in _boundary_runs():
        run = dict(seed=5, max_rounds=30, target_coverage=target)
        calls.append((name + "-until", "until", dict(mode="pull"),
                      ("complete", 1001), spec, run))
        calls.append((name + "-packed", "packed", dict(mode="pull"),
                      ("complete", 1001), spec, run))
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
    path = root / f"torch_sharded_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        calls = _calls()
        # the two meshes' spawns side by side: the ranks' imports are
        # most of a spawn's wall
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _port_worker, k, calls,
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
    from gossip_tpu.parallel import sharded as JSH
    from gossip_tpu.parallel import sharded_packed as JSP
    from gossip_tpu.topology import generators as JG
    return types.SimpleNamespace(jax=jax, C=JC, SH=JSH, SP=JSP, G=JG)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _gathered(states):
    """The padded global ``seen`` of every rank's final state."""
    return SH.state_from_ranks(states)[0]


def _jargs(ref, proto, topo, fault, run):
    return (ref.C.ProtocolConfig(**proto), _topo(topo, ref.G),
            ref.C.RunConfig(**run), _fault(fault, ref.C))


def _tstate_seen(state):
    return state.seen.numpy()


# -- the eight round cases ------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,topo,fault", CASES, ids=CASE_IDS)
def test_rounds_equal_reference(port_runs, ref, k, name, proto, topo,
                                fault):
    """Six rounds at seed 11: the whole padded ``seen``, the coverage and
    ``msgs`` after each round equal the reference's sharded scan on
    ``make_mesh(K)``, and the single-device port's run."""
    covs, msgs, _ = port_runs[k][name][0]
    final = [r[2] for r in port_runs[k][name]]
    run = dict(seed=SEED, max_rounds=ROUNDS)
    jp, jt, jr, jf = _jargs(ref, proto, topo, fault, run)
    jcovs, jmsgs, jfinal = ref.SH.simulate_curve_sharded(
        jp, jt, jr, ref.SH.make_mesh(k), jf)
    np.testing.assert_array_equal(_gathered(final), np.asarray(jfinal.seen))
    np.testing.assert_array_equal(covs, jcovs)
    np.testing.assert_array_equal(msgs, jmsgs)
    assert SH.state_from_ranks(final)[3] == np.float32(jfinal.msgs)
    one = TS.simulate_curve(TC.ProtocolConfig(**proto),
                            _topo(topo, G, device=CPU), TC.RunConfig(**run),
                            _fault(fault, TC), CPU)
    n = one.state.seen.shape[0]
    np.testing.assert_array_equal(_gathered(final)[:n],
                                  one.state.seen.numpy())
    np.testing.assert_array_equal(msgs, one.msgs)


@pytest.mark.parametrize("k", KS)
def test_padding_rows_stay_dark(port_runs, k):
    """Padding rows never receive: every case's rows past n are empty on
    every rank, bool and packed."""
    for name, _, topo, _ in CASES:
        seen = _gathered([r[2] for r in port_runs[k][name]])
        assert seen.shape[0] % k == 0
        assert not seen[topo[1]:].any(), name
    for name, kind, _, topo, _, _ in DRIVERS:
        if kind != "curve":
            words = _gathered([r[3] for r in port_runs[k][name]])
            assert not words[topo[1]:].any(), name


# -- the drivers ----------------------------------------------------------

def _ref_driver(ref, k, kind, proto, topo, fault, run):
    jp, jt, jr, jf = _jargs(ref, proto, topo, fault, run)
    mesh = ref.SH.make_mesh(k)
    if kind == "curve":
        return ref.SH.simulate_curve_sharded(jp, jt, jr, mesh, jf)
    if kind == "until":
        return ref.SH.simulate_until_sharded(jp, jt, jr, mesh, jf)
    return ref.SP.simulate_until_packed_sharded(jp, jt, jr, mesh, jf)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,kind,proto,topo,fault,run", DRIVERS,
                         ids=DRIVER_IDS)
def test_drivers_equal_reference(port_runs, ref, k, name, kind, proto,
                                 topo, fault, run):
    """The until drivers (dense and packed) and the dense curve, with
    and without a churn_heal-style program: rounds, coverage, msgs (or
    the curves) and the whole final state equal the reference's."""
    got = port_runs[k][name]
    want = _ref_driver(ref, k, kind, proto, topo, fault, run)
    if kind == "curve":
        np.testing.assert_array_equal(got[0][0], want[0])
        np.testing.assert_array_equal(got[0][1], want[1])
        final, jfinal = [r[2] for r in got], want[2]
    else:
        assert got[0][:3] == tuple(want[:3])
        final, jfinal = [r[3] for r in got], want[3]
    np.testing.assert_array_equal(_gathered(final), np.asarray(jfinal.seen))


@pytest.mark.parametrize("k", KS)
def test_drivers_equal_single_device(port_runs, k):
    """The packed drivers end where the port's single-device packed loop
    ends: the same rounds, msgs and state; the coverage too, which both
    report as the eager quotient under deaths or a program."""
    for name, kind, proto, topo, fault, run in DRIVERS:
        if kind != "packed":
            continue
        got = port_runs[k][name]
        tf = _fault(fault, TC)
        one = P.simulate_until_packed(TC.ProtocolConfig(**proto),
                                      _topo(topo, G, device=CPU),
                                      TC.RunConfig(**run), tf, CPU)
        assert (got[0][0], got[0][2]) == (one[0], one[2]), name
        if tf is not None:
            assert got[0][1] == one[1], name
        words = _gathered([r[3] for r in got])
        np.testing.assert_array_equal(words[:topo[1]],
                                      one[3].seen.numpy().view(np.uint32))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,topo", LOST, ids=[c[0] for c in LOST])
def test_lost_equals_reference(port_runs, ref, k, name, proto, topo):
    """Under the program each round's ``lost`` (the ranks' float32
    partials combined in rank order) and the final state equal the
    reference's sharded step under ``jax.jit``."""
    state, lost = port_runs[k][name][0]
    jax = ref.jax
    fault = _heal(topo[1])
    run = dict(seed=3, max_rounds=LOST_ROUNDS)
    jp, jt, jr, jf = _jargs(ref, proto, topo, fault, run)
    mesh = ref.SH.make_mesh(k)
    if proto["mode"] == "antientropy":
        step = ref.SP.make_sharded_packed_round(jp, jt, mesh, jf)
        st = ref.SP.init_sharded_packed_state(jr, jp, jt, mesh)
    else:
        step = ref.SH.make_sharded_si_round(jp, jt, mesh, jf)
        st = ref.SH.init_sharded_state(jr, jp, jt, mesh)
    step = jax.jit(step)
    want = []
    for _ in range(LOST_ROUNDS):
        st, lo = step(st)
        want.append(float(lo))
    assert lost == want
    assert sum(want) > 0
    np.testing.assert_array_equal(
        _gathered([r[0] for r in port_runs[k][name]]), np.asarray(st.seen))


@pytest.mark.parametrize("k", KS)
def test_stop_test_is_the_compiled_condition(port_runs, ref, k):
    """At targets on an ulp boundary of the stop test, both drivers stop
    on the reference's rounds: its compiled loops multiply by the
    reciprocal of the node count when no node can die and no program
    runs, and divide otherwise (``sharded_folded``); the reports carry
    the quotient."""
    names = [n for n in port_runs[k] if n.startswith("boundary")]
    assert len(names) == 8
    for name in names:
        base, kind = name.rsplit("-", 1)
        spec, target = next((s, t) for b, s, t in _boundary_runs()
                            if b == base)
        run = dict(seed=5, max_rounds=30, target_coverage=target)
        want = _ref_driver(ref, k, kind, dict(mode="pull"),
                           ("complete", 1001), spec, run)
        assert port_runs[k][name][0][:3] == tuple(want[:3]), name
    assert SH.sharded_folded(None)
    assert SH.sharded_folded(TC.FaultConfig(drop_prob=0.5))
    assert not SH.sharded_folded(TC.FaultConfig(node_death_rate=0.1))
    assert not SH.sharded_folded(_fault(_heal(64), TC))


def _split(result):
    """(the values of one rank's result, its final state)."""
    state = next(v for v in result if hasattr(v, "seen"))
    return [v for v in result if v is not state], state


def test_mesh_size_invariance(port_runs):
    """K = 2 and K = 4 give the same rounds, coverage, msgs, curves,
    lost and (unpadded) final states: every draw is keyed by global node
    id."""
    a, b = port_runs[2], port_runs[4]
    assert a.keys() == b.keys()
    sizes = {c[0]: c[3][1] for c in _calls()}
    for name in a:
        (va, _), (vb, _) = _split(a[name][0]), _split(b[name][0])
        for u, v in zip(va, vb):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                          err_msg=name)
        n = sizes[name]
        sa = _gathered([_split(r)[1] for r in a[name]])
        sb = _gathered([_split(r)[1] for r in b[name]])
        np.testing.assert_array_equal(sa[:n], sb[:n], err_msg=name)


def test_state_carriers_round_trip():
    """The reference's padded state (bool and packed words) goes to the
    ranks' tensors and back unchanged."""
    rng = np.random.default_rng(0)
    seen = rng.random((12, 3)) < 0.5
    words = rng.integers(0, 2**32, (12, 2), dtype=np.uint64).astype(
        np.uint32)
    key = np.array([7, 0xFFFFFFF0], np.uint32)
    for arr in (seen, words):
        states = [SH.state_to_rank(arr, 5, key, 123.0, r, 4, CPU)
                  for r in range(4)]
        assert [s.seen.shape[0] for s in states] == [3] * 4
        back = SH.state_from_ranks(states)
        np.testing.assert_array_equal(back[0], arr)
        assert back[0].dtype == arr.dtype
        assert int(back[1]) == 5 and back[3] == np.float32(123.0)
        np.testing.assert_array_equal(back[2], key)
