"""The serving slice (``gossip_tpu_torch.parallel.sweep.request_sweep_curves``,
``gossip_tpu_torch.rpc.batcher``, ``gossip_tpu_torch.rpc.sidecar``, the
wire helpers of ``gossip_tpu_torch.backend``) against the JAX package's
serving layer, live on the CPU with its executable store off, and
against the port's own solo runs.

Tolerance 0 everywhere: curves, msgs, dropped counts, rounds to the
target, the final states' sha256 digests and the reply bytes (less the
declared fields of :data:`DECLARED`).  Every sum here stays below 2^24,
where the float32 rule of ``gossip_tpu_torch.ops.common`` makes them
exact.

One readout differs by design (ROADMAP queue 3): a churn request
without random deaths.  Its solo run multiplies its exact count by the
float32 reciprocal of its eventual alive count, and so does the port's
megabatch; the reference's megabatch divides.  For that lane the port's
curve is held to the reference's solo ``simulate_curve``, and the
reference's megabatch curve to the quotient of the port's counts.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from gossip_tpu_torch import backend as TB
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.parallel import sweep as SWP
from gossip_tpu_torch.rpc import batcher as B
from gossip_tpu_torch.rpc import sidecar as SC
from gossip_tpu_torch.runtime.simulator import simulate_curve
from gossip_tpu_torch.topology import generators as G
from gossip_tpu_torch.utils import telemetry

CPU = torch.device("cpu")
ROUNDS = 10

# Reply fields that differ from the reference's by declaration: the
# package that ran (``backend``), the walls, and the compile verdict.
DECLARED = ("backend", "wall_s", "meta.batch.run_ms", "meta.batch.cache",
            "batch.run_ms", "batch.cache")


def _heal(cut, death=0.0):
    """A churn_heal-style program (crash and recover, a permanent crash,
    a cut window, a drop ramp) at drop 0.02."""
    return dict(drop_prob=0.02, seed=3, node_death_rate=death, churn=dict(
        events=((1, 1, 4), (2, 2, -1)), partitions=((0, 6, cut),),
        ramp=(0, 4, 0.0, 0.1)))


# (proto, n, run, fault): the complete-graph mix, one 512 bucket
MIX = [
    (dict(mode="pushpull", fanout=2), 500, dict(seed=1), None),
    (dict(mode="pull", fanout=2, rumors=2), 300, dict(seed=2),
     dict(node_death_rate=0.1, drop_prob=0.02, seed=5)),
    (dict(mode="antientropy", fanout=2, period=2), 512,
     dict(seed=3, target_coverage=0.9), dict(drop_prob=0.05, seed=1)),
    (dict(mode="push", fanout=2, rumors=3), 400, dict(seed=4), None),
    (dict(mode="pushpull", fanout=2, rumors=2), 450, dict(seed=5),
     _heal(200)),
    (dict(mode="pull", fanout=2), 333, dict(seed=6, origin=7),
     _heal(100, death=0.05)),
]
FOLDED_CHURN = (4,)       # churn without random deaths (module doc)
# one explicit Erdos-Renyi table, fanout 1, every request n = 300
ER = dict(family="erdos_renyi", n=300, p=0.05, seed=2)
ER_MIX = [
    (dict(mode="pull", fanout=1), 300, dict(seed=1), None),
    (dict(mode="push", fanout=1, rumors=2), 300, dict(seed=2),
     dict(drop_prob=0.05)),
    (dict(mode="antientropy", fanout=1, period=2), 300, dict(seed=3),
     None),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the batches pass torch's parallel grain, and
    the xdist workers' pools would contend for the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _specs(pkg, mix):
    """The same specs in the port (``"t"``) or the JAX package
    (``"j"``)."""
    if pkg == "t":
        M, S = TC, SWP.RequestSpec
    else:
        from gossip_tpu import config as M
        from gossip_tpu.parallel.sweep import RequestSpec as S
    out = []
    for proto, n, run, fault in mix:
        f = None
        if fault is not None:
            ch = fault.get("churn")
            f = M.FaultConfig(**{**fault, "churn": None if ch is None
                                 else M.ChurnConfig(**ch)})
        runc = M.RunConfig(max_rounds=ROUNDS, **run)
        if pkg == "t":
            runc = dataclasses.replace(runc, engine="xla")
        out.append(S(M.ProtocolConfig(**proto), runc, f, n))
    return tuple(out)


@pytest.fixture(scope="module")
def batches():
    """Both packages' megabatches of :data:`MIX` and :data:`ER_MIX`, the
    reference's with its executable store off (this fixture is built
    before the function-scoped ``_no_store``)."""
    from gossip_tpu import config as JC
    from gossip_tpu.parallel import sweep as JS
    from gossip_tpu.topology import generators as JG
    er_t = G.build(TC.TopologyConfig(**ER), CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOSSIP_COMPILE_CACHE", "")
        return {
            "mix": (SWP.request_sweep_curves(_specs("t", MIX), device=CPU),
                    JS.request_sweep_curves(_specs("j", MIX)), None),
            "er": (SWP.request_sweep_curves(_specs("t", ER_MIX),
                                            topo=er_t, device=CPU),
                   JS.request_sweep_curves(_specs("j", ER_MIX),
                                           topo=JG.build(
                                               JC.TopologyConfig(**ER))),
                   er_t)}


LANES = [("mix", i) for i in range(len(MIX))] + \
    [("er", i) for i in range(len(ER_MIX))]


@pytest.mark.parametrize("which,i", LANES,
                         ids=[f"{w}{i}" for w, i in LANES])
def test_megabatch_lane_matches_reference(batches, which, i):
    port, ref, _ = batches[which]
    assert np.array_equal(port.msgs[i], ref.msgs[i])
    assert np.array_equal(port.dropped[i], ref.dropped[i])
    assert port.state_digests[i] == ref.state_digests[i]
    if which == "mix" and i in FOLDED_CHURN:
        from gossip_tpu.runtime.simulator import simulate_curve as jsolo
        from gossip_tpu.topology import generators as JG
        sp = _specs("j", MIX)[i]
        solo = jsolo(sp.proto, JG.complete(sp.n), sp.run, sp.fault)
        assert np.array_equal(port.curves[i], np.asarray(solo.coverage))
        total = np.float32(int(SWP.ensemble_readout(
            _specs("t", MIX)[i].fault, sp.n, sp.run.origin, CPU)[1]))
        assert np.array_equal(ref.curves[i],
                              port.counts[i].astype(np.float32) / total)
    else:
        assert np.array_equal(port.curves[i], ref.curves[i])
        assert port.rounds_to_target[i] == ref.rounds_to_target[i]


def test_folded_churn_lane_readouts_differ_on_its_counts(batches):
    """The declared readout difference shows on this input: on some
    round of the folded churn lane the reference's quotient and the solo
    run's product differ, so the lane test above pins the choice."""
    port, ref, _ = batches["mix"]
    for i in FOLDED_CHURN:
        sp = _specs("t", MIX)[i]
        assert SWP.ensemble_readout(sp.fault, sp.n, sp.run.origin,
                                    CPU)[2] is True
        assert not np.array_equal(port.curves[i], ref.curves[i])


@pytest.mark.parametrize("which,i", LANES,
                         ids=[f"{w}{i}" for w, i in LANES])
def test_megabatch_lane_matches_port_solo(batches, which, i):
    """Each lane is the port's own solo ``run_simulation(engine='xla',
    want_curve=True)``: curve, msgs, rounds, coverage and the final
    state's digest (``simulate_curve``, the run the report comes
    from)."""
    port, _, er_t = batches[which]
    sp = _specs("t", MIX if which == "mix" else ER_MIX)[i]
    tc = (TC.TopologyConfig(n=sp.n) if which == "mix"
          else TC.TopologyConfig(**ER))
    rep = TB.run_simulation(sp.proto, tc, sp.run, sp.fault, want_curve=True,
                            device=CPU)
    assert rep.curve == [float(c) for c in port.curves[i]]
    assert rep.msgs == float(port.msgs[i][-1])
    assert rep.rounds == int(port.rounds_to_target[i])
    assert rep.coverage == float(port.curves[i][-1])
    topo = G.complete(sp.n) if er_t is None else er_t
    solo = simulate_curve(sp.proto, topo, sp.run, sp.fault, CPU)
    assert SWP.state_digest(solo.state.seen, sp.n, sp.proto.rumors) \
        == port.state_digests[i]


@pytest.mark.parametrize("i,lanes", [(0, None), (1, 8), (3, None),
                                     (4, 2), (5, 16)])
def test_lane_independent_of_batch_mates_and_padding(batches, i, lanes):
    """Composition invariance: a lane alone (building only its own
    mode's halves, where the mixed batch builds all three), or padded
    with inert lanes, is the lane of the mixed batch."""
    port, _, _ = batches["mix"]
    alone = SWP.request_sweep_curves([_specs("t", MIX)[i]], n_pad=512,
                                     lanes=lanes, device=CPU)
    assert alone.meta["lanes"] == (1 if lanes is None else lanes)
    assert np.array_equal(alone.curves[0], port.curves[i])
    assert np.array_equal(alone.msgs[0], port.msgs[i])
    assert np.array_equal(alone.dropped[0], port.dropped[i])
    assert alone.state_digests[0] == port.state_digests[i]


def test_metrics_rows_split_the_batch(batches):
    port, _, _ = batches["mix"]
    rows = port.metrics_rows()
    assert [r["mode"] for r in rows] == [m[0]["mode"] for m in MIX]
    assert rows[4]["dropped_total"] > 0
    assert rows[0]["coverage"] == [float(c) for c in port.curves[0]]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_request_sweep_refusals_are_the_references_words():
    from gossip_tpu import config as JC
    from gossip_tpu.parallel import sweep as JS
    ts, js = _specs("t", MIX[:1]), _specs("j", MIX[:1])
    for mk in (
            lambda M, sp: [sp, dataclasses.replace(
                sp, proto=M.ProtocolConfig(mode="pull", fanout=3))],
            lambda M, sp: [sp, dataclasses.replace(
                sp, run=M.RunConfig(max_rounds=20))]):
        assert _error(lambda: SWP.request_sweep_curves(
            mk(TC, ts[0]), device=CPU)) == _error(
            lambda: JS.request_sweep_curves(mk(JC, js[0])))
    for proto, n in ((dict(mode="flood"), 64),
                     (dict(mode="pull", period=3), 64),
                     (dict(mode="pull", exclude_self=False), 64),
                     (dict(mode="pull"), 1)):
        assert _error(lambda: SWP.RequestSpec(
            TC.ProtocolConfig(**proto), TC.RunConfig(), None, n)) == \
            _error(lambda: JS.RequestSpec(JC.ProtocolConfig(**proto),
                                          JC.RunConfig(), None, n))
    assert "not ported yet" in _error(lambda: SWP.request_sweep_curves(
        ts, mesh=object(), device=CPU))


# -- the wire: request_to_args and the batch key -----------------------------

BASE = {"backend": "jax-tpu", "proto": {"mode": "pull", "fanout": 2},
        "topology": {"family": "complete", "n": 300},
        "run": {"max_rounds": 8}}

ARGS_ERRORS = [
    {"nope": 1}, {"proto": {"fanoot": 2}}, {"curve": 1},
    {"run": {"engine": "warp"}}, {"proto": {"mode": "zap"}},
    {"fault": {"drop_prob": 2.0}}, {"topology": {"family": "moebius"}},
    {"mesh": {"n_devices": 2, "exchange": "bus"}},
]


@pytest.mark.parametrize("req", ARGS_ERRORS, ids=lambda r: str(r)[:30])
def test_request_to_args_errors_word_for_word(req):
    from gossip_tpu.backend import request_to_args as jparse
    assert _error(lambda: TB.request_to_args(req)) == \
        _error(lambda: jparse(req))


def test_request_to_args_defaults_to_the_references_engine():
    args = TB.request_to_args({})
    assert args["run"].engine == "auto" and args["want_curve"] is False
    assert TB.request_to_args(
        {"run": {"engine": "xla"}})["run"].engine == "xla"


CLASSIFY = [
    ({}, None),
    ({"backend": "go-native"}, "backend"),
    ({"proto": {"mode": "rumor"}}, "mode"),
    ({"proto": {"mode": "flood"}}, "mode"),
    ({"run": {"engine": "fused"}}, "engine"),
    ({"mesh": {"n_devices": 2}}, "mesh"),
    ({"fault": {"dead_nodes": [1]}}, "swim"),
    ({"fault": {"churn": {"events": [[999, 1, 3]]}}}, "node ids"),
    ({"fault": {"churn": {"partitions": [[0, 2, 400]]}}}, "cut"),
    ({"log": {"keys": 2}}, "log"),
    ({"txn": {"keys": 2}}, "txn"),
    ({"proto": {"mode": "pull", "fanout": 2, "period": 2}}, "period"),
    ({"topology": {"family": "complete", "n": 1}}, "n >= 2"),
    ({"topology": {"family": "ring", "n": 64, "k": 2}}, None),
    ({"proto": {"mode": "pushpull", "fanout": 2, "rumors": 5}}, None),
]


@pytest.mark.parametrize("patch,why", CLASSIFY,
                         ids=[str(p)[:40] for p, _ in CLASSIFY])
def test_classify_run_word_for_word(patch, why):
    from gossip_tpu.backend import request_to_args as jparse
    from gossip_tpu.rpc.batcher import classify_run as jclassify
    req = {**BASE, **patch}
    try:
        targs = TB.request_to_args(dict(req))
    except ValueError as e:
        assert str(e) == _error(lambda: jparse(dict(req)))
        return
    key, spec, curve = B.classify_run(targs, CPU)
    jkey, jspec, jcurve = jclassify(jparse(dict(req)))
    if why is None:
        assert key is not None and jkey is not None
        assert key.describe() == jkey.describe()
        assert curve == jcurve
    else:
        assert key is None and jkey is None
        assert spec == jspec and why in spec


def test_batch_keys_group_as_the_reference_groups():
    k0 = B.classify_run(TB.request_to_args(dict(BASE)), CPU)[0]
    same = {**BASE, "proto": {"mode": "pushpull", "fanout": 2},
            "topology": {"family": "complete", "n": 500},
            "fault": {"drop_prob": 0.2}, "run": {"max_rounds": 8, "seed": 9}}
    assert B.classify_run(TB.request_to_args(same), CPU)[0] == k0
    for patch in ({"proto": {"mode": "pull", "fanout": 3}},
                  {"run": {"max_rounds": 16}},
                  {"topology": {"family": "complete", "n": 600}},
                  {"proto": {"mode": "pull", "fanout": 2, "rumors": 3}}):
        assert B.classify_run(TB.request_to_args({**BASE, **patch}),
                              CPU)[0] != k0


def test_auto_routes_solo_where_the_fused_kernel_would_run(monkeypatch):
    """On a card, ``auto`` on an eligible request is the fused kernel's
    run: it falls through with the reference's words.  On the CPU it
    batches."""
    req = {**BASE, "run": {"max_rounds": 8, "engine": "auto"}}
    assert B.classify_run(TB.request_to_args(req), CPU)[0] is not None
    assert TB.fused_auto_ok(TC.ProtocolConfig(mode="pull"),
                            TC.TopologyConfig(n=300), None, "cuda")
    assert not TB.fused_auto_ok(TC.ProtocolConfig(mode="push"),
                                TC.TopologyConfig(n=300), None, "cuda")
    monkeypatch.setattr(TB, "fused_auto_ok", lambda *a: True)
    key, reason, _ = B.classify_run(TB.request_to_args(req), CPU)
    assert key is None
    assert reason == "engine=auto routes to the fused engine"


def test_classify_ensemble_a_lane_a_seed():
    from gossip_tpu.backend import request_to_args as jparse
    from gossip_tpu.rpc.batcher import classify_ensemble as jens
    key, specs = B.classify_ensemble(TB.request_to_args(dict(BASE)), None,
                                     3, CPU)
    assert key == B.classify_run(TB.request_to_args(dict(BASE)), CPU)[0]
    assert [s.run.seed for s in specs] == [0, 1, 2]
    bad = {**BASE, "proto": {"mode": "rumor"}}
    assert B.classify_ensemble(TB.request_to_args(bad), None, 3, CPU) == \
        jens(jparse(bad), None, 3)
    assert B.classify_ensemble(TB.request_to_args(dict(BASE)), [], None,
                               CPU) == (None, "empty seed list")


DISPATCH_ERRORS = [
    dict(backend="go-native"),
    dict(backend="warp-drive"),
    dict(log={"keys": 2}, txn={"keys": 2}),
    dict(backend="go-native", txn={"keys": 2}),
    dict(backend="go-native", log={"keys": 2}),
    dict(txn={"keys": 2}, mesh={"n_devices": 2}),
]


@pytest.mark.parametrize("patch", DISPATCH_ERRORS,
                         ids=lambda p: str(p)[:40])
def test_dispatch_refusals(patch):
    """The reference's payload and backend words, go-native's among
    them (a pull request: the event core runs flood only)."""
    from gossip_tpu.backend import request_to_args as jparse
    from gossip_tpu.backend import run_simulation as jrun
    req = {**BASE, **patch}
    got = _error(lambda: TB.dispatch(**TB.request_to_args(req), device=CPU))
    assert got == _error(lambda: jrun(**jparse(req)))


SERVING_BAD = [dict(tick_ms=0), dict(max_batch=0), dict(max_queue=0),
               dict(devices=3), dict(num_processes=0),
               dict(process_id=2, num_processes=2, coordinator="h:1"),
               dict(num_processes=2)]
FLEET_BAD = [dict(replicas=0), dict(devices_per_replica=3),
             dict(probe_interval_ms=0), dict(probe_timeout_s=0),
             dict(down_after=0), dict(up_after=0), dict(max_inflight=0),
             dict(control_capacity=3)]


@pytest.mark.parametrize("cls,kw", [("ServingConfig", k) for k in SERVING_BAD]
                         + [("FleetConfig", k) for k in FLEET_BAD],
                         ids=lambda x: str(x)[:30])
def test_config_checks_word_for_word(cls, kw):
    from gossip_tpu import config as JC
    assert _error(lambda: getattr(TC, cls)(**kw)) == \
        _error(lambda: getattr(JC, cls)(**kw))


@pytest.mark.parametrize("cls,kw", [
    ("ServingConfig", dict(devices=2)),
    ("ServingConfig", dict(num_processes=2, coordinator="h:1")),
    ("FleetConfig", dict(devices_per_replica=4))])
def test_request_axis_mesh_refused(cls, kw):
    assert "not ported yet" in _error(lambda: getattr(TC, cls)(**kw))


# -- the handlers without a transport ----------------------------------------

def _req(mode="pull", n=300, seed=0, **kw):
    return dict(backend="jax-tpu", proto={"mode": mode, "fanout": 2},
                topology={"family": "complete", "n": n},
                run={"max_rounds": ROUNDS, "seed": seed, "engine": "xla"},
                curve=True, **kw)


def _local(handler, req, batcher=None, timeout=None):
    return json.loads(handler(json.dumps(req).encode(),
                              SC.LocalContext(timeout), batcher, CPU))


def test_handlers_run_without_a_transport():
    """``_run`` under a batching core, each request from its own thread,
    through :class:`LocalContext`: the replies coalesce and each is its
    solo run's."""
    b = B.Batcher(TC.ServingConfig(tick_ms=300, max_batch=16), CPU)
    reqs = [_req("pushpull", 500, 1), _req("push", 300, 2),
            _req("antientropy", 400, 3)]
    out = [None] * len(reqs)

    def go(i):
        out[i] = _local(SC._run, reqs[i], b)
    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        b.close()
    for req, rep in zip(reqs, out):
        assert rep["meta"]["batch"]["batched"] is True
        assert rep["meta"]["batch"]["size"] == 3
        assert rep["meta"]["batch"]["cache"] == "warm"
        solo = _local(SC._run, req)
        for k in ("curve", "msgs", "rounds", "coverage"):
            assert rep[k] == solo[k], k


def test_handler_refusals_carry_the_codes():
    """A malformed body, an oversized ensemble, a full queue and a
    closed batcher, each with the reference's code and a one-line
    message."""
    b = B.Batcher(TC.ServingConfig(tick_ms=10_000, max_batch=2,
                                   max_queue=2), CPU)
    body = json.dumps(_req()).encode()
    try:
        for bad in (b'{"nope', b'[1]',
                    json.dumps({"proto": {"fanoot": 1}}).encode()):
            with pytest.raises(SC.Aborted) as ei:
                SC._run(bad, SC.LocalContext(), b, CPU)
            assert ei.value.code is SC.StatusCode.INVALID_ARGUMENT
            assert "\n" not in ei.value.message
        with pytest.raises(SC.Aborted) as ei:
            SC._ensemble(json.dumps({**BASE, "ensemble": 3}).encode(),
                         SC.LocalContext(), b, CPU)
        assert ei.value.code is SC.StatusCode.INVALID_ARGUMENT
        assert "max_batch is 2" in ei.value.message
        args = TB.request_to_args(_req())
        queued = [b.submit_run(args, time.monotonic() - 0.01)[0]
                  for _ in range(2)]
        with pytest.raises(SC.Aborted) as ei:
            SC._run(body, SC.LocalContext(), b, CPU)
        assert ei.value.code is SC.StatusCode.RESOURCE_EXHAUSTED
    finally:
        b.close()
    for p in queued:
        with pytest.raises(B.Expired):
            p.wait()
    with pytest.raises(SC.Aborted) as ei:
        SC._run(body, SC.LocalContext(), b, CPU)
    assert ei.value.code is SC.StatusCode.UNAVAILABLE


def test_health_and_metrics_replies():
    methods, batcher, _ = SC.handlers(TC.ServingConfig(tick_ms=50), CPU)
    try:
        h = json.loads(methods["Health"](b"{}", SC.LocalContext()))
        assert h == {"ok": True, "backend": "cpu", "devices": 1,
                     "serving_devices": 1, "service": SC.SERVICE}
        methods["Run"](json.dumps(_req()).encode(), SC.LocalContext())
        m = json.loads(methods["Metrics"](b"{}", SC.LocalContext()))
        assert m["role"] == "replica" and m["window"]["n"] == 1
        assert m["compiles_total"] == _kernels.build_events()
        assert m["compiles_delta"] == m["compiles_total"]
        m = json.loads(methods["Metrics"](b"{}", SC.LocalContext()))
        assert m["compiles_delta"] == 0 and m["inflight"] == 0
    finally:
        batcher.close()


# -- over gRPC, against the reference's sidecar -------------------------------

def _strip(reply: dict) -> dict:
    out = json.loads(json.dumps(reply))
    for path in DECLARED:
        node, *rest = path.split(".")
        cur = out
        while rest and isinstance(cur.get(node), dict):
            cur, node, rest = cur[node], rest[0], rest[1:]
        if not rest:
            cur.pop(node, None)
    return out


def _fire(client, reqs, method="run"):
    out = [None] * len(reqs)

    def go(i):
        out[i] = getattr(client, method)(timeout=300, **reqs[i])
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _both_sidecars(reqs, method="run", tick_ms=600):
    """The same concurrent requests through a fresh port sidecar and a
    fresh reference sidecar: ``(port replies, reference replies)``."""
    pytest.importorskip("grpc")
    from gossip_tpu import config as JC
    from gossip_tpu.rpc import sidecar as JSC
    out = []
    for mod, cfg, kw in ((SC, TC.ServingConfig, {"device": CPU}),
                         (JSC, JC.ServingConfig, {})):
        server, port = mod.serve(port=0, max_workers=8, batching=cfg(
            tick_ms=tick_ms, max_batch=16), **kw)
        try:
            client = mod.SidecarClient(f"127.0.0.1:{port}")
            out.append(_fire(client, reqs, method))
            client.close()
        finally:
            server.gossip_batcher.close()
            server.stop(grace=None)
    return out


def test_sidecar_replies_are_the_references_bytes():
    """Concurrent Runs coalesce into one tick, and each reply's JSON is
    the reference sidecar's for the same request, less
    :data:`DECLARED`."""
    reqs = [_req("pushpull", 500, 1), _req("pull", 300, 2),
            _req("push", 400, 3),
            {**_req("antientropy", 512, 4),
             "proto": {"mode": "antientropy", "fanout": 2, "period": 2},
             "fault": {"drop_prob": 0.05, "seed": 1}}]
    port, ref = _both_sidecars(reqs)
    for p, r in zip(port, ref):
        assert p["meta"]["batch"]["size"] == len(reqs)
        assert p["backend"] == "torch-cpu"
        assert json.dumps(_strip(p), sort_keys=True) == \
            json.dumps(_strip(r), sort_keys=True)


def test_batched_ensemble_equals_solo_and_the_reference():
    req = dict(backend="jax-tpu", proto={"mode": "pull", "fanout": 2},
               topology={"family": "complete", "n": 300},
               run={"max_rounds": 8, "engine": "xla"}, ensemble=4)
    port, ref = _both_sidecars([req], "ensemble", tick_ms=50)
    assert port[0]["batch"]["batched"] is True
    assert port[0]["batch"]["size"] == 4
    assert _strip(port[0]) == _strip(ref[0])
    args = TB.request_to_args({k: v for k, v in req.items()
                               if k != "ensemble"})
    ens, _ = TB.run_ensemble(args["proto"], args["tc"], args["run"],
                             count=4, device=CPU)
    assert port[0]["ensemble"] == ens.summary()


def test_solo_fallthrough_is_labeled():
    pytest.importorskip("grpc")
    server, port = SC.serve(port=0, max_workers=4, batching=TC.ServingConfig(
        tick_ms=50), device=CPU)
    try:
        client = SC.SidecarClient(f"127.0.0.1:{port}")
        rep = client.run(timeout=120, backend="jax-tpu",
                         proto={"mode": "flood"},
                         topology={"family": "ring", "n": 32, "k": 2},
                         run={"max_rounds": 16, "engine": "xla"})
        assert rep["meta"]["batch"] == {"batched": False,
                                        "reason": "mode=flood"}
        client.close()
    finally:
        server.gossip_batcher.close()
        server.stop(grace=None)


def test_sidecar_error_hygiene_one_line_no_retry(tmp_path):
    grpc = pytest.importorskip("grpc")
    server, port = SC.serve(port=0, max_workers=2, device=CPU)
    led_path = str(tmp_path / "client.jsonl")
    try:
        client = SC.SidecarClient(f"127.0.0.1:{port}")
        led = telemetry.Ledger(led_path)
        prev = telemetry.activate(led)
        try:
            for payload in (b'{"nope', b'[1, 2]', b'"hi"',
                            json.dumps({"proto": {"fanoot": 2}}).encode(),
                            json.dumps({"proto": "x"}).encode(),
                            json.dumps({"backend": "go-native"}).encode()):
                t0 = time.monotonic()
                with pytest.raises(grpc.RpcError) as ei:
                    client._call_with_retry(client._run, payload, 30, "run")
                assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                if b"go-native" in payload:
                    # the reference's reason for the same request
                    from gossip_tpu.backend import request_to_args as jparse
                    from gossip_tpu.backend import run_simulation as jrun
                    assert ei.value.details() == _error(
                        lambda: jrun(**jparse(json.loads(payload))))
                assert "\n" not in ei.value.details()
                assert "Traceback" not in ei.value.details()
                assert time.monotonic() - t0 < 2.0
        finally:
            telemetry.activate(prev)
            led.close()
        events = telemetry.load_ledger(led_path)
        assert not [e for e in events if e.get("ev") == "rpc_retry"]
        client.close()
    finally:
        server.stop(grace=None)


def test_client_timeout_bounds_queue_wait(tmp_path):
    grpc = pytest.importorskip("grpc")
    led_path = str(tmp_path / "server.jsonl")
    led = telemetry.Ledger(led_path)
    prev = telemetry.activate(led)
    server, port = SC.serve(port=0, max_workers=4, batching=TC.ServingConfig(
        tick_ms=400), device=CPU)
    try:
        client = SC.SidecarClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as ei:
            client.run(timeout=0.08, **_req(n=8))
        assert ei.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            if any(e.get("ev") == "deadline_exceeded"
                   for e in telemetry.load_ledger(led_path)):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("the server never ledgered the expiry")
        client.close()
    finally:
        server.gossip_batcher.close()
        server.stop(grace=None)
        telemetry.activate(prev)
        led.close()


# -- the batcher's queue ------------------------------------------------------

def test_batcher_deadline_and_backpressure(tmp_path):
    args = TB.request_to_args({**BASE, "topology": {"n": 8}})
    led_path = str(tmp_path / "batcher.jsonl")
    led = telemetry.Ledger(led_path)
    prev = telemetry.activate(led)
    b = B.Batcher(TC.ServingConfig(tick_ms=40, max_batch=8, max_queue=2),
                  CPU)
    b2 = B.Batcher(TC.ServingConfig(tick_ms=10_000, max_batch=8,
                                    max_queue=2), CPU)
    try:
        pending, note = b.submit_run(args, time.monotonic() - 0.01)
        assert pending is not None and note is None
        with pytest.raises(B.Expired, match="deadline expired"):
            pending.wait()
        past = time.monotonic() - 0.01
        b2.submit_run(args, past)
        b2.submit_run(args, past)
        with pytest.raises(B.QueueFull, match="queue full"):
            b2.submit_run(args, None)
    finally:
        b.close()
        b2.close()
        telemetry.activate(prev)
        led.close()
    kinds = {e.get("ev") for e in telemetry.load_ledger(led_path)}
    assert {"deadline_exceeded", "backpressure"} <= kinds


def test_batcher_oversized_drain_and_failed_tick(monkeypatch):
    args = TB.request_to_args({**BASE, "topology": {"n": 8}})
    b = B.Batcher(TC.ServingConfig(tick_ms=10_000, max_batch=4), CPU)
    try:
        with pytest.raises(B.TooLarge, match="megabatch lanes"):
            b.submit_ensemble(args, None, 8, None)
        # the drain order: the stop flag first, then the flush
        b._stop.set()
        b._thread.join(timeout=10)
        b._stop.clear()
        pending, _ = b.submit_run(args, time.monotonic() - 0.01)
        b._stop.set()
        with pytest.raises(B.Closed, match="shut down"):
            b.submit_run(args, None)
        assert not pending.event.is_set()
    finally:
        b.close()
    with pytest.raises(B.Expired):
        pending.wait()
    assert b._queue == []
    b2 = B.Batcher(TC.ServingConfig(tick_ms=10_000, max_batch=2), CPU)
    try:
        monkeypatch.setattr(B.Batcher, "_run_group",
                            lambda self, *a, **k: (_ for _ in ()).throw(
                                RuntimeError("boom")))
        pendings = [b2.submit_run(args, None)[0] for _ in range(3)]
        b2._drain_once()
        for p in pendings:
            with pytest.raises(B.BatchError, match="collector tick"):
                p.wait()
        assert b2._queue == []
    finally:
        b2.close()


# -- concurrency ------------------------------------------------------------------

def test_concurrent_solo_runs_count_their_own_launches(monkeypatch):
    """Two threads run solo requests at once, each report's launches and
    wall its own call's.  The stand-in: the curve driver counts one
    ``fused_round`` launch a round (the plain versions launch nothing),
    and the two runs meet at a barrier, so their launches interleave."""
    from gossip_tpu_torch.runtime import simulator as SIM
    real = SIM.simulate_curve
    barrier = threading.Barrier(2)

    def counting(proto, topo, run, fault=None, device=None):
        barrier.wait(timeout=30)
        for _ in range(run.max_rounds):
            _kernels.count_launch(_kernels.FUSED_ROUND)
            time.sleep(0.002)
        return real(proto, topo, run, fault, device)
    monkeypatch.setattr(SIM, "simulate_curve", counting)
    reports = {}

    def go(rounds):
        reports[rounds] = TB.run_simulation(
            TC.ProtocolConfig(mode="push"), TC.TopologyConfig(n=64),
            TC.RunConfig(max_rounds=rounds, engine="xla"), want_curve=True,
            device=CPU)
    threads = [threading.Thread(target=go, args=(r,)) for r in (5, 9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rounds, rep in reports.items():
        assert rep.meta["launches"]["fused_round"] == rounds


def test_concurrent_handler_runs_serialize_on_the_device_lock(monkeypatch):
    """Through the handlers, solo requests take the device lock: the two
    runs do not overlap, and each report's wall is its own run's, not
    the wait."""
    from gossip_tpu_torch.runtime import simulator as SIM
    real = SIM.simulate_curve
    spans = []

    def slow(proto, topo, run, fault=None, device=None):
        t0 = time.monotonic()
        time.sleep(0.3)
        out = real(proto, topo, run, fault, device)
        spans.append((t0, time.monotonic()))
        return out
    monkeypatch.setattr(SIM, "simulate_curve", slow)
    out = [None, None]

    def go(i):
        out[i] = _local(SC._run, _req("push", 64, i))
    t0 = time.monotonic()
    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = time.monotonic() - t0
    (a0, a1), (b0, b1) = sorted(spans)
    assert a1 <= b0                      # one after the other
    assert total >= 0.6
    for rep in out:
        assert 0.3 <= rep["wall_s"] < 0.55


def test_build_all_builds_each_library_once_under_two_threads(monkeypatch,
                                                               tmp_path):
    """Two first requests at once: one nvcc a library.  The stand-in
    build sleeps and counts."""
    started = []

    class Fake(_kernels.Kernel):
        def start_build(self):
            started.append(self.name)
            time.sleep(0.2)
            return None

        def finish_build(self, started_, t0):
            self._fn = object()
            self.build_s = time.perf_counter() - t0

        def library(self):
            return tmp_path / f"{self.source.stem}.so"

    ks = [Fake("a", "fused_round.cu", "x", []),
          Fake("b", "sampler.cu", "y", [])]
    before = _kernels.build_events()
    threads = [threading.Thread(target=_kernels.build_all, args=(ks,))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(started) == ["a", "b"]
    assert _kernels.build_events() - before == 2


def test_thread_tallies_are_per_thread():
    k = _kernels.SAMPLER
    base = _kernels.thread_launches()["sampler"]
    seen = {}

    def other():
        _kernels.count_launch(k)
        seen["other"] = _kernels.thread_launches()["sampler"]
    t = threading.Thread(target=other)
    t.start()
    t.join()
    _kernels.count_launch(k)
    _kernels.count_launch(k)
    assert seen["other"] == 1
    assert _kernels.thread_launches()["sampler"] == base + 2
