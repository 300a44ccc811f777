"""The port's round metrics (``gossip_tpu_torch.ops.round_metrics`` and
the drivers' recorders) against the JAX package's ``round_metrics``
events.

Every recorder of the port runs once a session in one spawn of K = 2
gloo ranks (:func:`port_runs`; under xdist the first worker to need it
computes it and the others read it): rank 0 writes a ledger a call, rank
1 holds a peer ledger, and each test compares the port's one
``round_metrics`` event with the reference driver's on its 2-device CPU
mesh (the ``ref`` fixture, its executable store off), as JSON, less the
``ts``/``run``/``fn`` fields: the drivers' names differ.  The fused
planes, whose reference loops cannot run on the CPU with the port's
bits, are held to the reference's ``_plane_recorder`` evaluated under
``jax.jit`` round by round on the port's own planes.

Tolerances: exact JSON equality.  ``newly`` is the port's exact count
difference, the reference's a float32 one; every mass here stays below
2^24, where the two agree (past it the port's is the exact one:
:func:`test_payload_mass_past_2_24_is_exact`).
"""

import functools
import os
import pickle
import types

import numpy as np
import pytest
import torch

from gossip_tpu_torch import config as TC
from gossip_tpu_torch.ops import round_metrics as RM
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.topology import generators as G
from gossip_tpu_torch.utils import telemetry as PT

K = 2
CPU = torch.device("cpu")


def _heal(n):
    return dict(drop_prob=0.02, seed=3, churn=dict(
        events=((1, 1, 4), (2, 2, -1)), partitions=((0, 6, n // 2),),
        ramp=(0, 4, 0.0, 0.1)))


# the reference's conv-metrics tests' program (tests/test_crdt.py _CFAULT)
CFAULT = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (7, 1, -1)), partitions=((0, 6, 16),),
    ramp=(1, 4, 0.0, 0.3)))
SMALL = dict(churn=dict(events=((3, 2, 5),), partitions=((0, 6, 32),),
                        ramp=(1, 4, 0.0, 0.3)))
BYZ = dict(byz=((3, 2, "inflate", 5), (11, 0, "corrupt", 1024)))
TXN_BYZ = dict(byz=((11, 0, "corrupt", 1048576),))
LOG = dict(keys=2, sends=((0, 0, 0, 9), (1, 0, 1, 4)),
           commits=((2, 0, 3, 1),))
SWIM = dict(mode="swim", fanout=2, swim_subjects=4, swim_proxies=2,
            swim_suspect_rounds=4)

# (name, driver, proto, topology (family, n, ...), fault, run, extra)
CASES = [
    ("dense-until-pushpull", "dense-until",
     dict(mode="pushpull", fanout=2, rumors=2), ("complete", 301), None,
     dict(seed=1, max_rounds=30), {}),
    ("dense-curve-heal-push", "dense-curve", dict(mode="push", fanout=2),
     ("complete", 203), _heal(203), dict(seed=3, max_rounds=12), {}),
    ("dense-curve-flood", "dense-curve", dict(mode="flood"), ("ring", 97, 4),
     None, dict(seed=2, max_rounds=8), {}),
    ("packed-pull-40", "packed", dict(mode="pull", rumors=40),
     ("complete", 201), None, dict(seed=2, max_rounds=60), {}),
    ("packed-heal-ae", "packed", dict(mode="antientropy", period=2),
     ("complete", 203), _heal(203), dict(seed=3, max_rounds=40), {}),
    ("sparse-until-heal", "sparse-until", dict(mode="pull", rumors=40),
     ("complete", 1000), _heal(1000), dict(seed=3, max_rounds=30), {}),
    ("sparse-curve-ae", "sparse-curve",
     dict(mode="antientropy", rumors=3, period=2), ("complete", 1000), None,
     dict(seed=3, max_rounds=12), {}),
    ("topo-sparse-until", "topo-sparse-until", dict(mode="pull", rumors=2),
     ("watts_strogatz", 400, 6, 0.1, 1), None,
     dict(seed=1, max_rounds=60), {}),
    ("topo-sparse-curve", "topo-sparse-curve",
     dict(mode="antientropy", period=2), ("watts_strogatz", 400, 6, 0.1, 1),
     None, dict(seed=1, max_rounds=10), {}),
    ("rumor-until-feedback", "rumor-until",
     dict(mode="rumor", fanout=1, rumors=3, rumor_k=2), ("complete", 1000),
     None, dict(seed=3, max_rounds=40), {}),
    ("rumor-curve-blind-heal", "rumor-curve",
     dict(mode="rumor", fanout=1, rumors=3, rumor_k=2,
          rumor_variant="blind"), ("complete", 1000), _heal(1000),
     dict(seed=3, max_rounds=20), {}),
    ("crdt-until-gcounter", "crdt-until", dict(mode="pull", fanout=2),
     ("complete", 64), SMALL, dict(seed=5, max_rounds=30,
                                   target_coverage=1.0),
     dict(cfg=dict(kind="gcounter"))),
    ("crdt-curve-orset", "crdt-curve", dict(mode="pull", fanout=2),
     ("complete", 64), None, dict(seed=5, max_rounds=20,
                                  target_coverage=1.0),
     dict(cfg=dict(kind="orset", elements=40, set_removes=((5, 3),)))),
    ("crdt-curve-byz-defended", "crdt-curve", dict(mode="pull", fanout=3),
     ("complete", 16), BYZ, dict(seed=5, max_rounds=20,
                                 target_coverage=1.0),
     dict(cfg=dict(kind="gcounter"), defend=True)),
    ("crdt-until-byz-undefended", "crdt-until", dict(mode="pull", fanout=3),
     ("complete", 16), BYZ, dict(seed=5, max_rounds=20,
                                 target_coverage=1.0),
     dict(cfg=dict(kind="gcounter"), defend=False)),
    ("log-curve-churn", "log-curve", dict(mode="pull", fanout=2),
     ("complete", 64), SMALL, dict(seed=5, max_rounds=16,
                                   target_coverage=1.0), dict(cfg=LOG)),
    ("log-until", "log-until", dict(mode="pull", fanout=2),
     ("complete", 64), None, dict(seed=5, max_rounds=30,
                                  target_coverage=1.0), dict(cfg=LOG)),
    ("txn-until-churn", "txn-until", dict(mode="pull", fanout=2),
     ("complete", 64), SMALL, dict(seed=5, max_rounds=30,
                                   target_coverage=1.0),
     dict(cfg=dict(keys=4))),
    ("txn-curve-byz-defended", "txn-curve", dict(mode="pull", fanout=3),
     ("complete", 16), TXN_BYZ, dict(seed=5, max_rounds=20,
                                     target_coverage=1.0),
     dict(cfg=dict(keys=6), defend=True)),
    ("txn-until-byz-undefended", "txn-until", dict(mode="pull", fanout=3),
     ("complete", 16), TXN_BYZ, dict(seed=5, max_rounds=20,
                                     target_coverage=1.0),
     dict(cfg=dict(keys=6), defend=False)),
    ("swim-curve", "swim-curve", SWIM, ("complete", 500), None,
     dict(seed=2, max_rounds=16), dict(dead=(3,))),
    ("swim-until", "swim-until", SWIM, ("complete", 500), None,
     dict(seed=2, max_rounds=40), dict(dead=(3,))),
]
CASE_IDS = [c[0] for c in CASES]

# the reference's conv-metrics tests (test_value_conv_round_metrics_*,
# test_log_conv_*, test_txn_conv_*): n = 32, 12 rounds, pull fanout 2
CONV = [("crdt", dict(kind="gcounter")), ("log", dict(keys=4, capacity=8)),
        ("txn", dict(keys=8, txns=16))]

# the fused planes: (name, driver, n, rumors, run)
PLANES = [("planes-until", "until", 3035, 96,
           dict(seed=3, max_rounds=40, target_coverage=0.99)),
          ("planes-curve", "curve", 2000, 40, dict(seed=1, max_rounds=12))]


def _topo(spec, gen, **device):
    kind, n, *rest = spec
    return {"complete": lambda: gen.complete(n),
            "ring": lambda: gen.ring(n, *rest, **device),
            "watts_strogatz": lambda: gen.watts_strogatz(
                n, rest[0], rest[1], seed=rest[2], **device)}[kind]()


def _fault(spec, C):
    if spec is None:
        return None
    spec = dict(spec)
    if "churn" in spec:
        spec["churn"] = C.ChurnConfig(**spec["churn"])
    if "byz" in spec:
        spec["byz"] = C.ByzConfig(liars=spec["byz"])
    spec.setdefault("seed", 1)
    return C.FaultConfig(**spec)


def _payload_cfg(kind, C, cfg):
    return {"crdt": C.CrdtConfig, "log": C.LogConfig,
            "txn": C.TxnConfig}[kind](**cfg)


def _drive(pkg, C, mods, case, where):
    """One case's driver call through package ``pkg`` (``where``: the
    reference's mesh or the port's group)."""
    _, driver, proto, topo, fault, run, extra = case
    proto = C.ProtocolConfig(**proto)
    run = C.RunConfig(**run)
    fault = _fault(fault, C)
    dev = {} if pkg == "ref" else dict(device="cpu")
    tp = _topo(topo, mods.G, **dev)
    family, _, kind = driver.rpartition("-")
    family = family or kind
    if family == "dense":
        return getattr(mods.SH, f"simulate_{kind}_sharded")(
            proto, tp, run, where, fault)
    if family == "packed":
        return mods.SP.simulate_until_packed_sharded(proto, tp, run, where,
                                                     fault)
    if family == "sparse":
        return getattr(mods.SS, f"simulate_{kind}_sparse")(
            proto, tp.n, run, where, fault)
    if family == "topo-sparse":
        return getattr(mods.SS, f"simulate_{kind}_topo_sparse")(
            proto, tp, run, where, fault)
    if family == "rumor":
        return getattr(mods.SR, f"simulate_{kind}_rumor_sharded")(
            proto, tp, run, where, fault)
    if family == "swim":
        kw = dict(mesh=where) if pkg == "ref" else dict(group=where)
        if kind == "curve":
            return mods.SIM.simulate_swim_curve(
                proto, tp.n, run.max_rounds, dead_nodes=extra["dead"],
                seed=run.seed, **kw)
        return mods.SIM.simulate_swim_until(
            proto, tp.n, run.max_rounds, 0.99, dead_nodes=extra["dead"],
            seed=run.seed, **kw)
    mod = {"crdt": mods.SCR, "log": mods.SLG, "txn": mods.SRG}[family]
    kw = {"defend": extra["defend"]} if "defend" in extra else {}
    return getattr(mod, f"simulate_{kind}_{family}_sharded")(
        _payload_cfg(family, C, extra["cfg"]), proto, tp, run, where, fault,
        **kw)


def _port_mods():
    from gossip_tpu_torch.parallel import (sharded, sharded_crdt,
                                           sharded_log, sharded_packed,
                                           sharded_register, sharded_rumor,
                                           sharded_sparse)
    from gossip_tpu_torch.runtime import simulator
    return types.SimpleNamespace(
        G=G, SH=sharded, SP=sharded_packed, SS=sharded_sparse,
        SR=sharded_rumor, SCR=sharded_crdt, SLG=sharded_log,
        SRG=sharded_register, SIM=simulator)


def _events(path):
    return [e for e in PT.load_ledger(path, strict=True)
            if e["ev"] == "round_metrics"]


def _ledgered(group, path, fn):
    """``fn()`` under rank 0's ledger at ``path`` (a peer ledger on the
    other ranks); returns rank 0's round_metrics events."""
    led = PT.Ledger(path) if group.rank == 0 else PT.PeerLedger()
    prev = PT.activate(led)
    try:
        out = fn()
    finally:
        PT.activate(prev)
        led.close()
    return out, (_events(path) if group.rank == 0 else None)


def _final_rows(out):
    """The final state's rows (``seen``, ``wire`` or ``val``) of a driver
    result, to hold the trajectory with and without metrics."""
    for x in out if isinstance(out, tuple) else (out,):
        for field in ("seen", "wire", "val"):
            if hasattr(x, field):
                return getattr(x, field).clone()
    raise AssertionError("no state in the result")


def _port_worker(cases, conv, planes, root, group):
    """Every call of this file on one rank: the driver under the ledger
    and, for the trajectory check, without it."""
    torch.set_num_threads(1)
    mods = _port_mods()
    out = {}
    for case in cases:
        name = case[0]
        res, ev = _ledgered(group, f"{root}/{name}.jsonl",
                            lambda: _drive("port", TC, mods, case, group))
        bare = _drive("port", TC, mods, case, group)
        out[name] = dict(events=ev, same=bool(torch.equal(
            _final_rows(res), _final_rows(bare))))
    for kind, cfg in conv:
        case = (f"conv-{kind}", f"{kind}-curve", dict(mode="pull", fanout=2),
                ("complete", 32), CFAULT,
                dict(seed=0, max_rounds=12, target_coverage=1.0),
                dict(cfg=cfg))
        res, ev = _ledgered(group, f"{root}/conv-{kind}.jsonl",
                            lambda: _drive("port", TC, mods, case, group))
        bare = _drive("port", TC, mods, case, group)
        out[case[0]] = dict(events=ev, conv=list(res[0]),
                            same=bool(torch.equal(res[2].val, bare[2].val))
                            and list(res[0]) == list(bare[0]))
    from gossip_tpu_torch.parallel import sharded_fused as SF
    for name, driver, n, rumors, run in planes:
        run = TC.RunConfig(**run)
        fn = getattr(SF, f"simulate_{driver}_sharded_fused")
        res, ev = _ledgered(group, f"{root}/{name}.jsonl",
                            lambda: fn(n, rumors, run, group))
        bare = fn(n, rumors, run, group)
        out[name] = dict(events=ev, same=bool(torch.equal(res[-1],
                                                          bare[-1])),
                         rounds=res[0] if driver == "until" else None)
    return out


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    """``{name: rank 0's result}`` of every port call of this file, one
    spawn of K ranks a session (shared through a file by the xdist
    workers of one run), with every rank's trajectory check."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_round_metrics_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        led_dir = root / f"torch_round_metrics_{uid or 'solo'}"
        led_dir.mkdir(exist_ok=True)
        ranks = GR.launch(_port_worker, K, CASES, CONV, PLANES, str(led_dir),
                          device="cpu")
        runs = ranks[0]
        for name in runs:
            runs[name]["same"] = all(r[name]["same"] for r in ranks)
        path.write_bytes(pickle.dumps(runs))
    return runs


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and ledger (imported here: the spawned
    ranks import this module)."""
    import jax
    from gossip_tpu import config as JC
    from gossip_tpu.ops import round_metrics as JRM
    from gossip_tpu.parallel import (sharded, sharded_crdt, sharded_fused,
                                     sharded_log, sharded_packed,
                                     sharded_register, sharded_rumor,
                                     sharded_sparse)
    from gossip_tpu.runtime import simulator
    from gossip_tpu.topology import generators as JG
    from gossip_tpu.utils import telemetry as JT
    return types.SimpleNamespace(
        jax=jax, C=JC, RM=JRM, T=JT, SF=sharded_fused, mods=types.
        SimpleNamespace(G=JG, SH=sharded, SP=sharded_packed,
                        SS=sharded_sparse, SR=sharded_rumor,
                        SCR=sharded_crdt, SLG=sharded_log,
                        SRG=sharded_register, SIM=simulator))


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _ref_events(ref, tmp_path, fn):
    path = str(tmp_path / "ref.jsonl")
    led = ref.T.Ledger(path)
    prev = ref.T.activate(led)
    try:
        out = fn()
    finally:
        ref.T.activate(prev)
        led.close()
    return out, [e for e in ref.T.load_ledger(path, strict=True)
                 if e["ev"] == "round_metrics"]


def _strip(e):
    return {k: v for k, v in e.items() if k not in ("ts", "run", "fn")}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_recorder_equals_reference(port_runs, ref, tmp_path, case):
    """Each recorder's event at K = 2 equals the reference driver's on
    its 2-device mesh, one event a driver call, and the trajectory is
    bitwise the one without metrics."""
    from gossip_tpu.parallel.sharded import make_mesh
    got = port_runs[case[0]]
    _, want = _ref_events(ref, tmp_path, lambda: _drive(
        "ref", ref.C, ref.mods, case, make_mesh(K)))
    assert len(got["events"]) == len(want) == 1
    assert _strip(got["events"][0]) == _strip(want[0])
    assert got["same"]


@pytest.mark.parametrize("kind,cfg", CONV, ids=[c[0] for c in CONV])
def test_conv_round_metrics_emitted_and_bitwise_free(port_runs, kind, cfg):
    """The counterparts of the reference's ``test_value_conv_round_
    metrics_*``, ``test_log_conv_round_metrics_*`` and
    ``test_txn_conv_round_metrics_*``: the sharded payload drivers flush
    one stack with their convergence column and the nemesis columns,
    and recording moves no bit of the trajectory."""
    got = port_runs[f"conv-{kind}"]
    key = {"crdt": "value_conv"}.get(kind, f"{kind}_conv")
    (e,) = got["events"]
    assert got["same"]
    assert e["driver"] == f"simulate_curve_{kind}_sharded"
    assert len(e[key]) == e["rounds"] == 12
    assert e["totals"][f"{key}_final"] == pytest.approx(got["conv"][-1],
                                                        abs=1e-4)
    assert e["totals"]["dropped"] > 0
    assert any(p > 0 for p in e["cut_pairs"])


def _plane_replay(ref, n, rumors, seed, rounds, label):
    """The reference's ``_plane_recorder`` under ``jax.jit``, round by
    round on the port's planes (the loops' own round on one rank, all
    planes), into a reference stack."""
    import jax.numpy as jnp
    from gossip_tpu_torch.parallel import sharded_fused as SF
    mesh = ref.SF.make_plane_mesh(K)
    rec = ref.jax.jit(ref.SF._plane_recorder(n, 1, mesh))
    # every rank's start planes in rank order: the mesh's W, padding too
    planes = torch.cat([SF.init_plane_state(n, rumors, types.SimpleNamespace(
        rank=r, size=K, device=CPU)) for r in range(K)])

    def u32(p):
        return jnp.asarray(p.numpy().view(np.uint32))

    m = ref.RM.init(rounds, K, label)
    cnt = ref.RM.count_planes(u32(planes))
    for r in range(rounds):
        planes = SF._planes_round(planes, seed, r, n, 1, None,
                                  dict(drop_threshold=0, alive_lanes=None))

        m, cnt = rec(m, cnt, u32(planes))
    return m


@pytest.mark.parametrize("name,driver,n,rumors,run", PLANES,
                         ids=[p[0] for p in PLANES])
def test_plane_recorder_equals_reference(port_runs, ref, tmp_path, name,
                                         driver, n, rumors, run):
    """The planes' event at K = 2 equals the reference's recorder on the
    same planes, each rank's front column its planes' least coverage;
    the planes are bitwise the ones without metrics."""
    got = port_runs[name]
    rounds = got["rounds"] if driver == "until" else run["max_rounds"]
    m = _plane_replay(ref, n, rumors, run["seed"], rounds,
                      f"simulate_{driver}_sharded_fused")
    path = str(tmp_path / "ref.jsonl")
    with ref.T.Ledger(path) as led:
        ref.RM.emit(m, led)
    (want,) = [e for e in ref.T.load_ledger(path) if
               e["ev"] == "round_metrics"]
    (e,) = got["events"]
    assert _strip(e) == _strip(want)
    assert e["rounds"] == rounds and e["shards"] == K
    assert got["same"]


def test_until_drivers_truncate_to_rounds_run(port_runs):
    """A loop that stops early reports its rounds, not ``max_rounds``."""
    for name in ("dense-until-pushpull", "packed-pull-40", "log-until",
                 "planes-until"):
        (e,) = port_runs[name]["events"]
        case = dict((c[0], c) for c in CASES).get(name)
        cap = (case[5]["max_rounds"] if case else
               PLANES[0][4]["max_rounds"])
        assert 0 < e["rounds"] < cap
        assert len(e["newly"]) == len(e["front"]) == e["rounds"]


# -- the module's pieces ---------------------------------------------------

def test_record_and_cursor_clamp():
    m = RM.init(3, 2, "t")
    for i in range(5):
        RM.record(m, newly=torch.tensor(i + 1), msgs=float(i),
                  bytes=4.0, offered=10.0,
                  front=torch.tensor([0.5, 0.25]))
    assert m.cursor == 5
    # the cursor clamps to the last row, as the reference's
    assert m.ints[RM._IROW["newly"]].tolist() == [1, 2, 5]
    assert m.front[2].tolist() == [0.5, 0.25]


def test_record_rounds_equals_a_record_a_round():
    """A block of rounds filled after the loop is the stack that one
    :func:`record` a round builds."""
    newly = torch.tensor([3, 0, 7], dtype=torch.int64)
    front = torch.tensor([[0.5, 0.25], [0.5, 0.5], [1.0, 0.75]])
    one, block = RM.init(4, 2, "t"), RM.init(4, 2, "t")
    for i in range(3):
        RM.record(one, newly=newly[i], msgs=8.0, bytes=4.0, offered=10.0,
                  front=front[i])
    RM.record_rounds(block, 3, newly=newly, front=front, msgs=8.0,
                     bytes=4.0, offered=10.0)
    assert block.cursor == one.cursor == 3
    for f in ("ints", "f32", "front"):
        assert torch.equal(getattr(block, f), getattr(one, f))


def test_init_validates():
    with pytest.raises(ValueError, match="max_rounds"):
        RM.init(0, 1, "t")
    with pytest.raises(ValueError, match="n_shards"):
        RM.init(4, 0, "t")


def test_counter_helpers_match_numpy(ref):
    rng = np.random.default_rng(0)
    seen = rng.random((64, 3)) < 0.3
    alive = rng.random(64) < 0.8
    words = rng.integers(0, 2 ** 32, size=(64, 2), dtype=np.uint32)
    planes = rng.integers(0, 2 ** 32, size=(4, 8, 128), dtype=np.uint32)
    t = torch.from_numpy
    assert int(RM.count_bool(t(seen), t(alive))) == int(
        (seen & alive[:, None]).sum())
    pc = np.unpackbits(words.view(np.uint8), axis=1).reshape(64, -1)
    assert int(RM.count_packed(t(words.view(np.int32)), t(alive))) == int(
        pc[alive].sum())
    assert int(RM.count_planes(t(planes.view(np.int32)))) == int(
        np.unpackbits(planes.view(np.uint8)).sum())
    jnp = ref.jax.numpy
    for got, want in (
            (RM.front_bool(t(seen), t(alive), 4),
             ref.jax.jit(ref.RM.front_bool, static_argnums=2)(
                 jnp.asarray(seen), jnp.asarray(alive), 4)),
            (RM.front_packed(t(words.view(np.int32)), t(alive), 2),
             ref.jax.jit(ref.RM.front_packed, static_argnums=2)(
                 jnp.asarray(words), jnp.asarray(alive), 2)),
            (RM.front_planes(t(planes.view(np.int32)), 1000, 2),
             ref.jax.jit(ref.RM.front_planes, static_argnums=(1, 2))(
                 jnp.asarray(planes), 1000, 2))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_gate_on_exchange_rounds_matches_the_predicate():
    assert [RM.gate_on_exchange_rounds(7.0, 3, r) for r in range(6)] == \
        [7.0, 0.0, 0.0, 7.0, 0.0, 0.0]
    assert [RM.gate_on_exchange_rounds(7.0, 1, r) for r in range(3)] == \
        [7.0] * 3
    assert RM.gate_on_exchange_rounds(9.0, 2, 1, off=4.0) == 4.0


def test_payload_factor_covers_every_si_mode(ref):
    for mode in TC.SI_MODES + (TC.RUMOR,):
        assert RM.payload_factor(mode) == ref.RM.payload_factor(mode)
    with pytest.raises(KeyError):
        RM.payload_factor(TC.SWIM)


def test_wanted_requires_env_and_active_ledger(tmp_path, monkeypatch):
    monkeypatch.delenv(RM.ENV_VAR, raising=False)
    prev = PT.activate(PT.NullLedger())
    try:
        assert not RM.wanted()
        led = PT.Ledger(str(tmp_path / "w.jsonl"))
        PT.activate(led)
        assert RM.wanted()
        for off in ("0", "", "off"):
            monkeypatch.setenv(RM.ENV_VAR, off)
            assert not RM.wanted()
        monkeypatch.setenv(RM.ENV_VAR, "1")
        PT.activate(PT.PeerLedger())
        assert RM.wanted()          # a peer rank builds the stack too
        led.close()
    finally:
        PT.activate(prev)


def test_no_ledger_allocates_no_buffers(monkeypatch):
    """Without a ledger the drivers build no stack (the chokepoint finds
    none and writes nothing)."""
    from gossip_tpu_torch.parallel import sharded as SH
    made = []
    monkeypatch.setattr(RM, "init", lambda *a, **k: made.append(a))
    prev = PT.activate(PT.NullLedger())
    try:
        with GR.local("cpu") as g:
            SH.simulate_until_sharded(
                TC.ProtocolConfig(mode="pull"), G.complete(64),
                TC.RunConfig(max_rounds=20), g)
    finally:
        PT.activate(prev)
    assert made == []


@functools.lru_cache(maxsize=None)
def _mass_rows():
    # 300 nodes holding counter shards of 2^17: the mass passes 2^24
    rng = np.random.default_rng(1)
    return rng.integers(1 << 16, 1 << 17, size=(300, 8), dtype=np.int32)


def test_payload_mass_past_2_24_is_exact(ref):
    """Past 2^24 the port's payload mass is the exact integer sum (its
    float32 rounding correctly rounded once), where the reference's
    float32 sum depends on its order: the two agree within the float32
    rounding of the sum (ROADMAP queue 3 item 3's rule)."""
    from gossip_tpu_torch.ops import crdt as CR
    from gossip_tpu_torch.ops import registers as RG
    rows = _mass_rows()
    alive = np.ones(300, bool)
    exact = int(rows.astype(np.int64).sum())
    assert exact > 1 << 24
    cfg = TC.CrdtConfig(kind="gcounter")
    got = CR.payload_count(cfg, torch.from_numpy(rows),
                           torch.from_numpy(alive))
    assert int(got) == exact
    from gossip_tpu.ops import crdt as JCR
    jnp = ref.jax.numpy
    want = float(JCR.payload_count(ref.C.CrdtConfig(kind="gcounter"),
                                   jnp.asarray(rows), jnp.asarray(alive)))
    assert abs(want - exact) <= np.spacing(np.float32(exact)) * 8
    # the registers' timestamp mass: the columns past the keys
    tcfg = TC.TxnConfig(keys=4)
    got = RG.payload_count(tcfg, torch.from_numpy(rows),
                           torch.from_numpy(alive))
    assert int(got) == int(rows[:, 4:].astype(np.int64).sum())


def test_payload_conv_readouts_equal_the_references(ref):
    """The payloads' in-loop fractions (``value_conv_frac`` and the two
    ``byz_conv_frac``) against the reference's under ``jax.jit``: a
    quotient of the converged count by the alive total."""
    from gossip_tpu.ops import crdt as JCR
    from gossip_tpu.ops import registers as JRG
    from gossip_tpu_torch.ops import crdt as CR
    from gossip_tpu_torch.ops import registers as RG
    jnp = ref.jax.numpy
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3, size=(70, 8), dtype=np.int32)
    truth = np.ones(8, np.int32)
    rows[:23] = truth
    alive = rng.random(70) < 0.9
    comp = rng.random(8) < 0.5
    t = torch.from_numpy
    want = ref.jax.jit(JCR.value_conv_frac)(jnp.asarray(rows),
                                           jnp.asarray(truth),
                                           jnp.asarray(alive))
    assert float(CR.value_conv_frac(t(rows), t(truth), t(alive))) == float(
        want)
    ccfg, jccfg = TC.CrdtConfig(kind="gcounter"), ref.C.CrdtConfig(
        kind="gcounter")
    want = ref.jax.jit(lambda r, a: JCR.byz_conv_frac(
        jccfg, r, jnp.asarray(truth), a, jnp.asarray(comp)))(
        jnp.asarray(rows), jnp.asarray(alive))
    assert float(CR.byz_conv_frac(ccfg, t(rows), t(truth), t(alive),
                                  t(comp))) == float(want)
    tcfg, jtcfg = TC.TxnConfig(keys=4), ref.C.TxnConfig(keys=4)
    km = comp[:4]
    want = ref.jax.jit(lambda r, a: JRG.byz_conv_frac(
        jtcfg, r, jnp.asarray(truth), a, jnp.asarray(km)))(
        jnp.asarray(rows), jnp.asarray(alive))
    assert float(RG.byz_conv_frac(tcfg, t(rows), t(truth), t(alive),
                                  t(km))) == float(want)
