"""The port's node-sharded SWIM, rumor-mongering and payload drivers
(``gossip_tpu_torch.parallel.sharded_swim``, ``sharded_rumor``,
``sharded_crdt``, ``sharded_log``, ``sharded_register``) against the JAX
package's sharded drivers on its K-device CPU mesh, and against the
port's own single-device runs.

The port runs K in {2, 4} ranks under gloo, spawned.  Every port call of
this file runs once a test session, in one spawn for each K
(:func:`port_runs`; under xdist the first worker to need it computes it
and the others read it), and each test compares its share of it.  The
spawned ranks import this module for :func:`_port_worker`, so its top
level imports torch, numpy and the port only; the JAX package comes in
through the ``ref`` fixture, with its executable store off.

The cases mirror the reference's own sharded tests: SWIM on the complete
graph and a neighbour table, the three dissemination lowerings, the
packed rng, the rotating window and a churn program with a drop ramp
(tests/test_swim.py); rumor mongering feedback and blind, its loops and
the churn surfaces' program (tests/test_rumor.py,
tests/_churn_surfaces.py); the CRDT counters and sets under the full
fault program and the liar programs defended and not, with the salted
programs held by their trajectories (tests/test_crdt.py,
tests/test_byzantine.py); the logs and the registers (tests/test_logs.py,
tests/test_txn.py).  Node counts are ones K does not divide, so the
padding rows are exercised.

Tolerances: bitwise for the whole padded state (SWIM ``wire`` and
``timer``; rumor ``seen``, ``hot`` and ``cnt``; the payloads' ``val``),
rounds, curves, convergence, truth, ``msgs`` and ``lost``.  Every sum
here stays below 2^24, where float32 sums are exact whatever their
order, so the single-device runs' ``msgs`` are the sharded ones too.
"""

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
from gossip_tpu_torch.models import crdt as TMC
from gossip_tpu_torch.models import log as TML
from gossip_tpu_torch.models import register as TMR
from gossip_tpu_torch.models import rumor as TRU
from gossip_tpu_torch.models import swim as TSW
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.parallel import sharded_crdt as SC
from gossip_tpu_torch.parallel import sharded_log as SL
from gossip_tpu_torch.parallel import sharded_register as SRG
from gossip_tpu_torch.parallel import sharded_rumor as SRU
from gossip_tpu_torch.parallel import sharded_swim as SSW
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

KS = (2, 4)
CPU = torch.device("cpu")

# -- the cases ----------------------------------------------------------

_SWIM = dict(mode="swim", fanout=2, swim_proxies=2, swim_suspect_rounds=4,
             swim_subjects=4)
_DROP = dict(drop_prob=0.15, seed=8)
# tests/test_swim.py's parity shape, at 97 nodes
SWIM_STEPS = [
    ("swim-complete", _SWIM, None, (0, 2), 4, _DROP, None),
    ("swim-er", _SWIM, ("erdos_renyi", 0.1, 6), (0, 2), 4, _DROP, None),
    ("swim-scatter", dict(_SWIM, swim_diss="scatter"), None, (0, 2), 4,
     _DROP, None),
    ("swim-pack8", dict(_SWIM, swim_diss="pack"), None, (0, 2), 4, _DROP,
     12),
    ("swim-pack16", dict(_SWIM, swim_diss="pack"), None, (0, 2), 4, _DROP,
     200),
    ("swim-packed-complete", dict(_SWIM, swim_rng="packed"), None, (0, 2),
     4, _DROP, None),
    ("swim-packed-er", dict(_SWIM, swim_rng="packed"),
     ("erdos_renyi", 0.1, 6), (0, 2), 4, _DROP, None),
    # the rotating window, its epoch cut to 5 so 12 rounds cross two
    # boundaries
    ("swim-rotate", dict(_SWIM, swim_subjects=8, swim_rotate=True,
                         swim_epoch_rounds=5), None, (57,), 0, None, None),
]
SWIM_N, SWIM_ROUNDS, SWIM_SEED = 97, 12, 9
# the detection loops under a churn program with a ramp (SWIM refuses
# partitions), and the default scenario to the target
_SWIM_CHURN = dict(drop_prob=0.1, seed=2, churn=dict(
    events=((1, 2, -1), (3, 1, 6)), ramp=(0, 4, 0.0, 0.05)))
SWIM_LOOPS = [
    ("swim-churn-curve", "curve", dict(_SWIM, swim_subjects=8), (), 0,
     _SWIM_CHURN),
    ("swim-until", "until", dict(_SWIM, swim_subjects=8), (1,), 2, None),
]

_RUMOR = dict(mode="rumor", fanout=2, rumor_k=2, rumors=3)
_CHURN_SURFACE = dict(node_death_rate=0.1, drop_prob=0.05, seed=1,
                      churn=dict(events=((3, 2, 5), (7, 1, -1)),
                                 partitions=((2, 6, 32),),
                                 ramp=(1, 4, 0.0, 0.3)))
# (name, driver, proto, topology, fault, run): tests/test_rumor.py's
# parity cases and tests/_churn_surfaces.py's rumor program
RUMOR = [
    ("rumor-feedback", "step", dict(_RUMOR, rumor_variant="feedback"),
     ("complete", 101), None, dict(seed=11, max_rounds=10)),
    ("rumor-blind", "step", dict(_RUMOR, rumor_variant="blind"),
     ("complete", 101), None, dict(seed=11, max_rounds=10)),
    ("rumor-until", "until", dict(mode="rumor", fanout=2, rumor_k=2),
     ("complete", 127), None, dict(seed=4, max_rounds=12)),
    ("rumor-curve-er", "curve", dict(mode="rumor", fanout=1, rumor_k=2,
                                     rumors=2),
     ("erdos_renyi", 121, 0.05, 5), None, dict(seed=7, max_rounds=12)),
    ("rumor-churn-curve", "curve", dict(mode="rumor", fanout=2, rumor_k=2,
                                        rumors=2),
     ("complete", 65), _CHURN_SURFACE, dict(seed=0, max_rounds=10)),
    ("rumor-churn-step", "step", dict(_RUMOR, rumor_variant="blind"),
     ("complete", 65), _CHURN_SURFACE, dict(seed=0, max_rounds=10)),
]

# the payloads' full mixed fault program (crash/recover, permanent
# crash, open partition window, drop ramp), at 33 nodes
_CFAULT = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (7, 1, -1)), partitions=((0, 6, 16),),
    ramp=(1, 4, 0.0, 0.3)))
_LIARS = ((3, 2, "inflate", 5), (11, 0, "corrupt", 1 << 20))
_BFAULT = dict(churn=dict(events=((4, 6, 12),)),
               byz=dict(liars=_LIARS, quorum=2))
_SALTS = [
    dict(liars=((5, 2, "equivocate", 9), (11, 1, "replay", 0),
                (13, 0, "inflate", 3)), quorum=3),
    dict(liars=((7, 0, "corrupt", 1 << 18),), quorum=1),
    dict(liars=((1, 3, "replay", 2), (30, 0, "equivocate", 4)), quorum=2),
]
_REG_LIARS = ((3, 2, "inflate", 200000000), (7, 1, "equivocate", 0),
              (9, 0, "replay", 0))
_PULL2, _PULL3 = dict(mode="pull", fanout=2), dict(mode="pull", fanout=3)
_R12 = dict(seed=0, max_rounds=12, target_coverage=1.0)
_R12B = dict(seed=7, max_rounds=12, target_coverage=1.0)
# (name, payload, driver, payload config, proto, n, fault, run, defend)
PAYLOADS = [
    ("crdt-gcounter", "crdt", "curve", dict(kind="gcounter"), _PULL2, 33,
     _CFAULT, _R12, False),
    ("crdt-pncounter", "crdt", "curve", dict(kind="pncounter"), _PULL2, 33,
     _CFAULT, _R12, False),
    ("crdt-orset", "crdt", "curve", dict(kind="orset", elements=48,
                                         set_removes=((5, 3), (11, 8))),
     _PULL2, 33, _CFAULT, _R12, False),
    ("crdt-gset-until", "crdt", "until", dict(kind="gset", elements=40),
     _PULL2, 33, _CFAULT, dict(seed=0, max_rounds=12), False),
    ("crdt-until", "crdt", "until", dict(kind="gcounter"), _PULL2, 33,
     _CFAULT, dict(seed=0, max_rounds=12), False),
    ("byz-gcounter-defended", "crdt", "curve", dict(kind="gcounter"),
     _PULL3, 17, _BFAULT, _R12B, True),
    ("byz-gcounter-undefended", "crdt", "curve", dict(kind="gcounter"),
     _PULL3, 17, _BFAULT, _R12B, False),
    ("byz-orset-defended", "crdt", "curve",
     dict(kind="orset", elements=40, set_removes=((5, 3),)), _PULL3, 17,
     _BFAULT, _R12B, True),
    ("byz-orset-undefended", "crdt", "curve",
     dict(kind="orset", elements=40, set_removes=((5, 3),)), _PULL3, 17,
     _BFAULT, _R12B, False),
    *[(f"byz-salted-{i}", "crdt", "curve", dict(kind="gcounter"), _PULL3,
       33, dict(drop_prob=0.05, seed=2, churn=dict(events=((3, 2, 5),)),
                byz=salt), dict(seed=0, max_rounds=8), True)
      for i, salt in enumerate(_SALTS)],
    # a liar that goes down and comes back (node 3) and one that goes
    # down for good (node 11): a down liar serves nothing
    ("byz-churned-liars-gcounter", "crdt", "curve", dict(kind="gcounter"),
     _PULL3, 17, dict(churn=dict(events=((3, 3, 6), (11, 5, -1))),
                      byz=dict(liars=_LIARS)), _R12B, False),
    ("byz-churned-liars-orset", "crdt", "curve",
     dict(kind="orset", elements=40), _PULL3, 17,
     dict(drop_prob=0.1, seed=4, churn=dict(events=((3, 3, 6),
                                                    (11, 5, -1))),
          byz=dict(liars=_LIARS)), _R12B, True),
    ("log-curve", "log", "curve", dict(keys=4, capacity=8), _PULL2, 33,
     _CFAULT, _R12, False),
    ("log-until", "log", "until", dict(keys=4, capacity=8), _PULL2, 33,
     _CFAULT, dict(seed=0, max_rounds=12), False),
    ("txn-curve", "txn", "curve", dict(keys=8, txns=16, zipf_alpha=1.2,
                                       hot_key=0.3), _PULL2, 33, _CFAULT,
     _R12, False),
    ("txn-until", "txn", "until", dict(keys=8, txns=16), _PULL2, 33,
     _CFAULT, dict(seed=0, max_rounds=12), False),
    ("txn-byz-defended", "txn", "curve", dict(keys=6), _PULL3, 17,
     dict(churn=dict(events=((4, 6, 12),)), byz=dict(liars=_REG_LIARS)),
     _R12B, True),
    ("txn-byz-undefended", "txn", "curve", dict(keys=6), _PULL3, 17,
     dict(churn=dict(events=((4, 6, 12),)), byz=dict(liars=_REG_LIARS)),
     _R12B, False),
    ("txn-byz-churned-liars", "txn", "curve", dict(keys=6), _PULL3, 17,
     dict(churn=dict(events=((3, 3, 6), (9, 5, -1))),
          byz=dict(liars=_REG_LIARS)), _R12B, True),
]
PAYLOAD_IDS = [p[0] for p in PAYLOADS]


def _topo(spec, gen, n=None, **device):
    """The topology of ``spec`` from the generators ``gen`` (the port's
    take ``device=``): ``None`` is the complete graph on ``n``."""
    if spec is None:
        return None
    if spec[0] == "erdos_renyi" and len(spec) == 3:
        return gen.erdos_renyi(n, spec[1], seed=spec[2], **device)
    kind, n, *rest = spec
    if kind == "complete":
        return gen.complete(n)
    return gen.erdos_renyi(n, rest[0], seed=rest[1], **device)


def _fault(spec, cfg):
    if spec is None:
        return None
    spec = dict(spec)
    churn = spec.pop("churn", None)
    byz = spec.pop("byz", None)
    if churn is not None:
        spec["churn"] = cfg.ChurnConfig(**churn)
    if byz is not None:
        spec["byz"] = cfg.ByzConfig(**byz)
    return cfg.FaultConfig(**spec)


def _payload_cfg(payload, spec, cfg):
    return {"crdt": cfg.CrdtConfig, "log": cfg.LogConfig,
            "txn": cfg.TxnConfig}[payload](**spec)


def _run_steps(step, state, rounds):
    """``rounds`` steps; the per-round ``lost`` under a program."""
    lost = []
    for _ in range(rounds):
        state = step(state)
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            state, lo = state
            lost.append(float(lo))
    return state, lost


# -- the port's calls, in the spawned ranks ----------------------------

_SHARDED_LOOPS = {
    ("crdt", "curve"): SC.simulate_curve_crdt_sharded,
    ("crdt", "until"): SC.simulate_until_crdt_sharded,
    ("log", "curve"): SL.simulate_curve_log_sharded,
    ("log", "until"): SL.simulate_until_log_sharded,
    ("txn", "curve"): SRG.simulate_curve_txn_sharded,
    ("txn", "until"): SRG.simulate_until_txn_sharded,
}


def _port_worker(group):
    """One rank's share of every port call (runs in the spawned ranks)."""
    out, dev = {}, group.device
    for name, proto, topo, dead, fail, fault, max_r in SWIM_STEPS:
        proto = TC.ProtocolConfig(**proto)
        step = SSW.make_sharded_swim_round(
            proto, SWIM_N, group, dead, fail, _fault(fault, TC),
            _topo(topo, G, SWIM_N, device=dev), max_rounds=max_r)
        out[name] = _run_steps(step, SSW.init_sharded_swim_state(
            SWIM_N, proto, group, SWIM_SEED), SWIM_ROUNDS)[0]
    for name, kind, proto, dead, fail, fault in SWIM_LOOPS:
        proto, fault = TC.ProtocolConfig(**proto), _fault(fault, TC)
        if kind == "curve":
            out[name] = TS.simulate_swim_curve(
                proto, SWIM_N, SWIM_ROUNDS, dead, fail, fault,
                seed=SWIM_SEED, group=group)
        else:
            out[name] = TS.simulate_swim_until(
                proto, SWIM_N, 40, 0.99, dead, fail, fault, seed=SWIM_SEED,
                group=group)
    for name, kind, proto, topo, fault, run in RUMOR:
        proto, fault = TC.ProtocolConfig(**proto), _fault(fault, TC)
        topo, run = _topo(topo, G, device=dev), TC.RunConfig(**run)
        if kind == "step":
            step = SRU.make_sharded_rumor_round(proto, topo, group, fault,
                                                run.origin)
            out[name] = _run_steps(step, SRU.init_sharded_rumor_state(
                run, proto, topo, group), run.max_rounds)
        elif kind == "curve":
            out[name] = SRU.simulate_curve_rumor_sharded(proto, topo, run,
                                                         group, fault)
        else:
            out[name] = SRU.simulate_until_rumor_sharded(proto, topo, run,
                                                         group, fault)
    for name, payload, kind, cfg, proto, n, fault, run, defend in PAYLOADS:
        kw = {} if payload == "log" else {"defend": defend}
        out[name] = _SHARDED_LOOPS[payload, kind](
            _payload_cfg(payload, cfg, TC), TC.ProtocolConfig(**proto),
            G.complete(n), TC.RunConfig(**run), group, _fault(fault, TC),
            **kw)
    return out


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory):
    """``{K: {name: per-rank results}}`` for every call of this file,
    one spawn for each K, once a session (shared through a file by the
    xdist workers of one run)."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_sharded_models_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _port_worker, k,
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
    from gossip_tpu.parallel import sharded_crdt as JSC
    from gossip_tpu.parallel import sharded_log as JSL
    from gossip_tpu.parallel import sharded_register as JSRG
    from gossip_tpu.parallel import sharded_rumor as JSRU
    from gossip_tpu.parallel import sharded_swim as JSSW
    from gossip_tpu.runtime import simulator as JS
    from gossip_tpu.topology import generators as JG
    return types.SimpleNamespace(
        jax=jax, C=JC, mesh=JSH.make_mesh, SSW=JSSW, SRU=JSRU, S=JS, G=JG,
        loops={("crdt", "curve"): JSC.simulate_curve_crdt_sharded,
               ("crdt", "until"): JSC.simulate_until_crdt_sharded,
               ("log", "curve"): JSL.simulate_curve_log_sharded,
               ("log", "until"): JSL.simulate_until_log_sharded,
               ("txn", "curve"): JSRG.simulate_curve_txn_sharded,
               ("txn", "until"): JSRG.simulate_until_txn_sharded})


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    # the reference's AOT store cannot run sharded executables here
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _cat(states, field):
    """The padded global ``field`` of every rank's state, as the
    reference's bits (uint32 views of the port's int32 words)."""
    return torch.cat([getattr(s, field) for s in states]).numpy()


def _same(port, ref_arr):
    ref_arr = np.asarray(ref_arr)
    if ref_arr.dtype == np.uint32:
        ref_arr = ref_arr.view(np.int32)
    np.testing.assert_array_equal(port, ref_arr)


# -- SWIM ----------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,proto,topo,dead,fail,fault,max_r",
                         SWIM_STEPS, ids=[c[0] for c in SWIM_STEPS])
def test_swim_rounds_equal_reference(port_runs, ref, k, name, proto, topo,
                                     dead, fail, fault, max_r):
    """Twelve sharded SWIM rounds: the whole padded ``wire`` and
    ``timer`` and ``msgs`` equal the reference's sharded round on
    ``make_mesh(K)``, and the port's single-device round on the real
    rows."""
    states = port_runs[k][name]
    jproto = ref.C.ProtocolConfig(**proto)
    jstep = ref.SSW.make_sharded_swim_round(
        jproto, SWIM_N, ref.mesh(k), dead, fail, _fault(fault, ref.C),
        _topo(topo, ref.G, SWIM_N), max_rounds=max_r)
    jst = ref.SSW.init_sharded_swim_state(SWIM_N, jproto, ref.mesh(k),
                                          seed=SWIM_SEED)
    jstep = ref.jax.jit(jstep)
    for _ in range(SWIM_ROUNDS):
        jst = jstep(jst)
    wire, timer = _cat(states, "wire"), _cat(states, "timer")
    _same(wire, jst.wire)
    _same(timer, jst.timer)
    assert float(states[0].msgs) == float(jst.msgs)
    tproto = TC.ProtocolConfig(**proto)
    single, _ = _run_steps(TSW.make_swim_round(
        tproto, SWIM_N, dead, fail, _fault(fault, TC),
        _topo(topo, G, SWIM_N, device=CPU), max_rounds=max_r, device=CPU),
        TSW.init_swim_state(SWIM_N, tproto.swim_subjects, SWIM_SEED, CPU),
        SWIM_ROUNDS)
    np.testing.assert_array_equal(wire[:SWIM_N], single.wire.numpy())
    np.testing.assert_array_equal(timer[:SWIM_N], single.timer.numpy())
    assert float(single.msgs) == float(states[0].msgs)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,kind,proto,dead,fail,fault", SWIM_LOOPS,
                         ids=[c[0] for c in SWIM_LOOPS])
def test_swim_loops_equal_reference(port_runs, ref, k, name, kind, proto,
                                    dead, fail, fault):
    """The detection loops with a ``group``: the churn program's curve
    and the loop to the target equal the reference's loops with
    ``mesh=make_mesh(K)`` (detection from the ranks' summed counts), and
    the port's single-device loops."""
    got = port_runs[k][name]
    jp, jf = ref.C.ProtocolConfig(**proto), _fault(fault, ref.C)
    tp, tf = TC.ProtocolConfig(**proto), _fault(fault, TC)
    if kind == "curve":
        jfr, jfin = ref.S.simulate_swim_curve(jp, SWIM_N, SWIM_ROUNDS, dead,
                                              fail, jf, seed=SWIM_SEED,
                                              mesh=ref.mesh(k))
        sfr, sfin = TS.simulate_swim_curve(tp, SWIM_N, SWIM_ROUNDS, dead,
                                           fail, tf, seed=SWIM_SEED,
                                           device=CPU)
        np.testing.assert_array_equal(got[0][0], np.asarray(jfr))
        np.testing.assert_array_equal(got[0][0], sfr)
        finals = [g[1] for g in got]
    else:
        jr, jdet, jpeak, jfin = ref.S.simulate_swim_until(
            jp, SWIM_N, 40, 0.99, dead, fail, jf, seed=SWIM_SEED,
            mesh=ref.mesh(k))
        sr, sdet, speak, sfin = TS.simulate_swim_until(
            tp, SWIM_N, 40, 0.99, dead, fail, tf, seed=SWIM_SEED,
            device=CPU)
        assert got[0][:3] == (jr, jdet, jpeak) == (sr, sdet, speak)
        finals = [g[3] for g in got]
    _same(_cat(finals, "wire"), jfin.wire)
    _same(_cat(finals, "timer"), jfin.timer)
    np.testing.assert_array_equal(_cat(finals, "wire")[:SWIM_N],
                                  sfin.wire.numpy())
    assert float(finals[0].msgs) == float(jfin.msgs) == float(sfin.msgs)


# -- rumor mongering -----------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,kind,proto,topo,fault,run", RUMOR,
                         ids=[c[0] for c in RUMOR])
def test_rumor_equals_reference(port_runs, ref, k, name, kind, proto, topo,
                                fault, run):
    """The sharded rumor round and loops: the whole padded ``seen``,
    ``hot`` and ``cnt``, ``msgs``, ``lost``, the curves and the loop's
    (rounds, coverage, residue, msgs) equal the reference's sharded
    drivers on ``make_mesh(K)``, and the port's single-device ones."""
    got = port_runs[k][name]
    jp, jt = ref.C.ProtocolConfig(**proto), _topo(topo, ref.G)
    jr, jf = ref.C.RunConfig(**run), _fault(fault, ref.C)
    tp, tt = TC.ProtocolConfig(**proto), _topo(topo, G, device=CPU)
    tr, tf = TC.RunConfig(**run), _fault(fault, TC)
    mesh = ref.mesh(k)
    if kind == "step":
        jstep, tables = ref.SRU.make_sharded_rumor_round(
            jp, jt, mesh, jf, jr.origin, tabled=True)
        jstep = ref.jax.jit(jstep)
        jst = ref.SRU.init_sharded_rumor_state(jr, jp, jt, mesh)
        jlost = []
        for _ in range(jr.max_rounds):
            jst = jstep(jst, *tables)
            if jf is not None and jf.churn is not None:
                jst, lo = jst
                jlost.append(float(lo))
        finals = [g[0] for g in got]
        assert got[0][1] == jlost
        single, slost = _run_steps(
            TRU.make_rumor_round(tp, tt, tf, tr.origin, CPU),
            TRU.init_rumor_state(tr, tp, tt.n, CPU), tr.max_rounds)
        assert slost == jlost
    elif kind == "curve":
        jc = ref.SRU.simulate_curve_rumor_sharded(jp, jt, jr, mesh, jf)
        sc = TRU.simulate_curve_rumor(tp, tt, tr, tf, CPU)
        for a, b, c in zip(got[0][:3], jc[:3], sc[:3]):
            np.testing.assert_array_equal(a, np.asarray(b))
            # the single-device scan holds no padding rows: its alive
            # set is None without faults, so its quotient is a mean too
            np.testing.assert_array_equal(a, c)
        jst, single, finals = jc[3], sc[3], [g[3] for g in got]
    else:
        ju = ref.SRU.simulate_until_rumor_sharded(jp, jt, jr, mesh, jf)
        su = TRU.simulate_until_rumor(tp, tt, tr, tf, CPU)
        assert got[0][:4] == tuple(ju[:4]) == su[:4]
        jst, single, finals = ju[4], su[4], [g[4] for g in got]
    n = tt.n
    for field in ("seen", "hot", "cnt"):
        port = _cat(finals, field)
        _same(port, getattr(jst, field))
        np.testing.assert_array_equal(port[:n],
                                      getattr(single, field).numpy())
    assert float(finals[0].msgs) == float(jst.msgs) == float(single.msgs)


# -- the payloads --------------------------------------------------------

_SINGLE_LOOPS = {
    ("crdt", "curve"): TMC.simulate_curve_crdt,
    ("crdt", "until"): TMC.simulate_until_crdt,
    ("log", "curve"): TML.simulate_curve_log,
    ("log", "until"): TML.simulate_until_log,
    ("txn", "curve"): TMR.simulate_curve_txn,
    ("txn", "until"): TMR.simulate_until_txn,
}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize(
    "name,payload,kind,cfg,proto,n,fault,run,defend", PAYLOADS,
    ids=PAYLOAD_IDS)
def test_payloads_equal_reference(port_runs, ref, k, name, payload, kind,
                                  cfg, proto, n, fault, run, defend):
    """The sharded CRDT (the liar programs defended and not, the salted
    programs by their trajectories), log and register loops: the whole
    padded ``val``, the curve or the loop's rounds and convergence,
    ``msgs`` and the truth equal the reference's sharded drivers on
    ``make_mesh(K)``, and the port's single-device loops."""
    got = port_runs[k][name]
    kw = {} if payload == "log" else {"defend": defend}
    jres = ref.loops[payload, kind](
        _payload_cfg(payload, cfg, ref.C), ref.C.ProtocolConfig(**proto),
        ref.G.complete(n), ref.C.RunConfig(**run), ref.mesh(k),
        _fault(fault, ref.C), **kw)
    sres = _SINGLE_LOOPS[payload, kind](
        _payload_cfg(payload, cfg, TC), TC.ProtocolConfig(**proto),
        G.complete(n), TC.RunConfig(**run), _fault(fault, TC), device=CPU,
        **kw)
    i = 2 if kind == "curve" else 3           # the final state
    scalars = [j for j in range(len(jres)) if j != i]
    for j in scalars:
        a, b, c = got[0][j], jres[j], sres[j]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b))
            np.testing.assert_array_equal(a, c)
        else:
            assert a == b == c, (j, a, b, c)
    val = _cat([g[i] for g in got], "val")
    _same(val, jres[i].val)
    np.testing.assert_array_equal(val[:n], sres[i].val.numpy())
    assert float(got[0][i].msgs) == float(jres[i].msgs)
    assert got[0][i].round == int(jres[i].round) == sres[i].round


def test_padding_rows_stay_dark(port_runs):
    """No padding row of any sharded state holds anything: they never
    receive, inject or hold a hot pair (K = 4, where every node count
    here leaves padding)."""
    for name, payload, kind, cfg, proto, n, *_ in PAYLOADS:
        states = port_runs[4][name]
        val = _cat([s[2 if kind == "curve" else 3] for s in states], "val")
        assert val.shape[0] > n and not val[n:].any(), name
    for name, *_ in SWIM_STEPS:
        wire = _cat(port_runs[4][name], "wire")
        assert not wire[SWIM_N:].any(), name


# -- the payload commands -------------------------------------------------

_CLI = {
    "crdt": ["crdt", "--type", "orset", "--elements", "40", "--set-remove",
             "5:3", "--n", "65", "--fanout", "3", "--byz", "3:2:inflate:5",
             "--byz", "11:0:corrupt:1048576", "--defend", "--max-rounds",
             "12", "--churn-event", "4:6:12"],
    "log": ["log", "--n", "63", "--keys", "4", "--partition", "0:6:30",
            "--churn-event", "3:2:5", "--drop-ramp", "1:4:0.0:0.3",
            "--curve", "--max-rounds", "12"],
    "txn": ["txn", "--n", "63", "--keys", "8", "--partition", "0:6:30",
            "--churn-event", "3:2:5", "--max-rounds", "12"],
}


@pytest.mark.parametrize("cmd", sorted(_CLI))
def test_payload_commands_on_a_mesh_match_reference(capsys, cmd):
    """``crdt``, ``log`` and ``txn --devices 2 --device cpu`` exit 0 and
    print the reference command's JSON on its 2-device mesh, field by
    field (the port's ``backend`` and wall aside), ``engine`` the
    reference's ``<mode>-sharded``; the port's keys add the process
    group."""
    from gossip_tpu import cli as jcli
    args = _CLI[cmd] + ["--devices", "2"]
    capsys.readouterr()
    assert jcli.main(args + ["--no-compile-cache"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    skip = {"backend", "wall_s", "compile_cache"}
    assert {k: got[k] for k in want if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["engine"] == f"{cmd}-sharded" and got["devices"] == 2
    assert got["process_group"] == "gloo" and got["backend"] == "torch-cpu"


def test_run_payload_gathers_the_ranks_rows():
    """``cli.run_payload`` with ``--devices 2`` returns every rank's rows
    in rank order, padded, equal to the single-device final state."""
    args = _CLI["txn"] + ["--device", "cpu"]
    rep, res = cli.run_payload(args + ["--devices", "2"])
    rep1, res1 = cli.run_payload(args)
    assert rep["engine"] == "txn-sharded" and rep1["engine"] == "txn-xla"
    assert (rep["rounds"], rep["txn_conv"], rep["msgs"]) == \
        (rep1["rounds"], rep1["txn_conv"], rep1["msgs"])
    assert res[3].val.shape[0] == 64
    assert torch.equal(res[3].val[:63], res1[3].val)


@pytest.mark.parametrize("cmd", sorted(_CLI))
def test_payload_commands_count_every_ranks_launches(cmd):
    """``crdt``, ``log`` and ``txn --devices 2`` reports carry every
    rank's kernel launches (``rank_launches``, in rank order, one entry
    a kernel), as ``run --devices K`` does; the payload rounds launch no
    kernel of the port."""
    from gossip_tpu_torch.ops import _kernels
    rep, _ = cli.run_payload(_CLI[cmd] + ["--devices", "2", "--device",
                                          "cpu"])
    launches = rep["rank_launches"]
    assert len(launches) == 2
    for rank in launches:
        assert set(rank) == {k.name for k in _kernels.ROUND_KERNELS}
        assert sum(rank.values()) == 0
