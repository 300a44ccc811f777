"""The request-axis serving mesh: ``rpc.batcher.Batcher`` with
``ServingConfig.devices`` K above 1 on a pool of K spawned gloo CPU ranks
(``parallel.group.Pool``, ``request_sweep_curves(group=)``), against the
port's solo runs and the JAX package's mesh batcher at K = 4 on its
8-device CPU mesh (its executable store off).

Tolerance 0: every reply's curve, msgs, rounds, coverage and final
state's digest.  The requests are the shapes of
``tests/test_serving.py::_mesh_requests`` (the churn member at rumors =
2 among them); the rumor bucket splits them into a three-request group
and a one-request group, so at K = 4 the lone group runs on one rank
and leaves three ranks with slices that are all padding.

Every mesh observation of this file is made once a test session, in one
pool for each K (shared through a file by the xdist workers of one run:
a spawn costs seconds), and every tick runs under a deadline, so a
deadlocked collective fails its test instead of hanging the run.
"""

import dataclasses
import os
import pickle
import signal
import threading

import numpy as np
import pytest
import torch

from gossip_tpu_torch import backend as TB
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.parallel import sweep as SWP
from gossip_tpu_torch.rpc import batcher as B
from gossip_tpu_torch.runtime.simulator import simulate_curve
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
KS = (2, 4)
TICK_TIMEOUT_S = 120.0


def _mesh_requests(salt=0):
    """The request dicts of ``tests/test_serving.py::_mesh_requests``."""
    return [
        {"proto": {"mode": "pushpull", "fanout": 2},
         "topology": {"family": "complete", "n": 500},
         "run": {"max_rounds": 10, "seed": 1 + salt, "engine": "xla"},
         "curve": True},
        {"proto": {"mode": "pull", "fanout": 2},
         "topology": {"family": "complete", "n": 300},
         "run": {"max_rounds": 10, "seed": 2 + salt, "engine": "xla"},
         "fault": {"node_death_rate": 0.1, "drop_prob": 0.1,
                   "seed": 5 + salt},
         "curve": True},
        {"proto": {"mode": "antientropy", "fanout": 2, "period": 2},
         "topology": {"family": "complete", "n": 500},
         "run": {"max_rounds": 10, "seed": 3 + salt,
                 "target_coverage": 0.9, "engine": "xla"},
         "fault": {"drop_prob": 0.2, "seed": 1},
         "curve": True},
        {"proto": {"mode": "pushpull", "fanout": 2, "rumors": 2},
         "topology": {"family": "complete", "n": 500},
         "run": {"max_rounds": 10, "seed": 3, "engine": "xla"},
         "fault": {"drop_prob": 0.05, "seed": 5,
                   "churn": {"events": [[3 + salt, 1, 4], [7, 2, -1]],
                             "partitions": [[1, 3, 250]],
                             "ramp": [0, 2, 0.0, 0.2]}},
         "curve": True},
    ]


REQS = _mesh_requests(0)


def _tick(batcher, reqs):
    """Submit ``reqs`` and drain one tick under :data:`TICK_TIMEOUT_S`:
    every request's reply, or ``("error", message)``.  A tick that does
    not end tears the pool down and answers ``"deadlock"``."""
    pend = []
    for r in reqs:
        p, why = batcher.submit_run(TB.request_to_args(r), None)
        assert p is not None, why
        pend.append(p)
    if _bounded(batcher._drain_once, batcher) == "deadlock":
        return "deadlock"
    out = []
    for p in pend:
        try:
            out.append(p.wait())
        except B.BatchError as e:
            out.append(("error", str(e)))
    return out


def _bounded(fn, batcher):
    """``fn()`` under :data:`TICK_TIMEOUT_S`; past it the pool is torn
    down and the answer is ``"deadlock"``."""
    out = {}
    t = threading.Thread(target=lambda: out.update(v=fn()), daemon=True)
    t.start()
    t.join(TICK_TIMEOUT_S)
    if t.is_alive():
        batcher._pool._teardown("the test's tick deadline")
        return "deadlock"
    return out["v"]


def _alive(pids):
    return [p for p in pids if os.path.exists(f"/proc/{p}")]


def _observe(k):
    """Everything the tests read of a K-rank batcher (module doc)."""
    torch.set_num_threads(1)
    b = B.Batcher(TC.ServingConfig(tick_ms=1e6, max_batch=64, devices=k),
                  CPU)
    pids = b.pool_pids()
    obs = {"pids": pids}
    try:
        obs["mixed"] = _tick(b, REQS)
        obs["salted"] = _tick(b, _mesh_requests(1))
        obs["lone"] = _tick(b, [REQS[0]])
        # the driver alone on the pool: one lane padded to 2K lanes
        spec = TB_spec(REQS[0])
        ranks = _bounded(lambda: b._pool.run(B._mesh_batch, (spec,), None,
                                             512, 2 * k), b)
        res = ranks[0][0]
        obs["driver_padded"] = (res.curves[0], res.msgs[0], res.dropped[0],
                                res.state_digests[0], res.meta)
        if k == 2:
            # a dead rank: the tick fails, and so does the next, never solo
            os.kill(pids[1], signal.SIGKILL)
            obs["dead_rank"] = [_tick(b, [REQS[0]]), _tick(b, [REQS[1]])]
    finally:
        b.close()
    obs["alive_after_close"] = _alive(pids)
    return obs


def TB_spec(req):
    _, spec, _ = B.classify_run(TB.request_to_args(req), CPU)
    return spec


def _session_runs(tmp_path_factory):
    """``{K: observations}`` once a session (module doc)."""
    from concurrent.futures import ThreadPoolExecutor

    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_serving_mesh_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        with ThreadPoolExecutor(len(KS)) as pool:
            runs = dict(zip(KS, pool.map(_observe, KS)))
        path.write_bytes(pickle.dumps(runs))
    return runs


@pytest.fixture(scope="session")
def mesh(tmp_path_factory):
    return _session_runs(tmp_path_factory)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's mesh batcher at K = 4 on its 8-device CPU mesh,
    one tick of :data:`REQS` (the executable store off)."""
    import jax
    from gossip_tpu.backend import request_to_args
    from gossip_tpu.config import ServingConfig
    from gossip_tpu.rpc.batcher import Batcher
    assert len(jax.devices()) >= 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOSSIP_COMPILE_CACHE", "")
        b = Batcher(ServingConfig(tick_ms=60_000.0, max_batch=64,
                                  devices=4))
        try:
            pend = [b.submit_run(request_to_args(r), None)[0] for r in REQS]
            b._drain_once()
            return [p.wait() for p in pend]
        finally:
            b.close()


@pytest.fixture(scope="module")
def solo():
    """The port's solo run of each request: its reply and its final
    state's digest."""
    out = []
    for req in REQS:
        args = TB.request_to_args(req)
        rep = TB.dispatch(**args, device=CPU).to_dict()
        sp = TB_spec(req)
        res = simulate_curve(sp.proto, G.complete(sp.n), sp.run, sp.fault,
                             CPU)
        out.append((rep, SWP.state_digest(res.state.seen, sp.n,
                                          sp.proto.rumors)))
    return out


CASES = [(k, i) for k in KS for i in range(len(REQS))]
IDS = [f"k{k}-req{i}" for k, i in CASES]


@pytest.mark.parametrize("k,i", CASES, ids=IDS)
def test_mesh_reply_equals_port_solo(mesh, solo, k, i):
    rep = mesh[k]["mixed"][i]
    want, digest = solo[i]
    for field in ("curve", "msgs", "rounds", "coverage"):
        assert rep[field] == want[field], field
    assert rep["meta"]["state_digest"] == digest


@pytest.mark.parametrize("k,i", CASES, ids=IDS)
def test_mesh_reply_equals_reference_mesh_batcher(mesh, reference, k, i):
    rep, ref = mesh[k]["mixed"][i], reference[i]
    for field in ("curve", "msgs", "rounds", "coverage", "mode", "n"):
        assert rep[field] == ref[field], field
    assert rep["meta"]["state_digest"] == ref["meta"]["state_digest"]
    assert rep["meta"]["dropped_total"] == ref["meta"]["dropped_total"]
    assert rep["meta"]["devices"] == k and ref["meta"]["devices"] == 4


@pytest.mark.parametrize("k", KS)
def test_batch_meta_reports_the_width_and_the_groups(mesh, reference, k):
    """Both groups of the tick ride the K ranks (the reference's split:
    three requests in the rumor bucket 1, one in bucket 2)."""
    reps = mesh[k]["mixed"]
    assert [r["meta"]["batch"]["size"] for r in reps] == \
        [r["meta"]["batch"]["size"] for r in reference] == [3, 3, 3, 1]
    assert all(r["meta"]["batch"]["devices"] == k for r in reps)
    assert all(r["meta"]["devices"] == k for r in reps)


@pytest.mark.parametrize("k", KS)
def test_lone_member_on_inert_ranks_equals_its_full_batch_row(mesh, k):
    """Composition invariance under inert padding: request 0 alone pads
    to K lanes, so K - 1 ranks hold nothing but padding (and take part
    in every gather); its reply is its row of the mixed tick."""
    (lone,) = mesh[k]["lone"]
    full = mesh[k]["mixed"][0]
    assert lone["meta"]["batch"]["size"] == 1
    for field in ("curve", "msgs", "rounds", "coverage"):
        assert lone[field] == full[field], field
    assert lone["meta"]["state_digest"] == full["meta"]["state_digest"]


@pytest.mark.parametrize("k", KS)
def test_driver_padded_lanes_are_inert(mesh, k):
    """``request_sweep_curves(group=)`` with one request in 2K lanes (one
    real lane on rank 0, every other lane inert) equals the request's
    row of the single-device batch."""
    curve, msgs, dropped, digest, meta = mesh[k]["driver_padded"]
    one = SWP.request_sweep_curves([TB_spec(REQS[0])], n_pad=512,
                                   device=CPU)
    assert np.array_equal(curve, one.curves[0])
    assert np.array_equal(msgs, one.msgs[0])
    assert np.array_equal(dropped, one.dropped[0])
    assert digest == one.state_digests[0]
    assert meta["lanes"] == 2 * k and meta["devices"] == k


@pytest.mark.parametrize("k", KS)
def test_salted_reentry_builds_no_kernel(mesh, k):
    """Other requests of the same shapes run on the same ranks with no
    ``kernel_build`` event, theirs included (the batch's compile
    verdict), and their content changed."""
    salted = mesh[k]["salted"]
    assert all(r["meta"]["batch"]["cache"] == "warm" for r in salted)
    assert salted[0]["curve"] != mesh[k]["mixed"][0]["curve"]


@pytest.mark.parametrize("k", KS)
def test_close_leaves_no_live_child(mesh, k):
    assert len(mesh[k]["pids"]) == k
    assert mesh[k]["alive_after_close"] == []


def test_mesh_rank_zero_continues_the_run_ledger(tmp_path):
    """Under a run ledger, a K = 2 tick writes the request sweep's
    ``driver_timing`` event once, from the pool's rank 0, as the K = 1
    tick writes it from the serving process."""
    from gossip_tpu_torch.utils import telemetry
    torch.set_num_threads(1)
    fns = {}
    for k in (1, 2):
        path = str(tmp_path / f"k{k}.jsonl")
        led = telemetry.Ledger(path)
        prev = telemetry.activate(led)
        try:
            b = B.Batcher(TC.ServingConfig(tick_ms=1e6, max_batch=64,
                                           devices=k), CPU)
            try:
                (rep,) = _tick(b, [REQS[0]])
            finally:
                b.close()
        finally:
            telemetry.activate(prev)
            led.close()
        assert rep["meta"]["devices"] == k
        fns[k] = [e["fn"] for e in telemetry.load_ledger(path)
                  if e.get("ev") == "driver_timing"]
    # the mesh's timed function gathers the ranks' lanes too
    assert fns == {1: ["run_chunks"], 2: ["run_gathered"]}


def test_dead_rank_fails_the_tick_and_never_falls_back(mesh):
    first, second = mesh[2]["dead_rank"]
    assert first != "deadlock" and second != "deadlock"
    (kind, msg), = first
    assert kind == "error"
    assert msg.startswith("batch execution failed: RuntimeError: rank 1 "
                          "of the pool exited with code -9")
    (kind, msg), = second
    assert kind == "error" and "the rank pool is down" in msg


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("kw", [dict(devices=3), dict(devices=0),
                                dict(devices=6)])
def test_width_not_a_power_of_two_refused_word_for_word(kw):
    from gossip_tpu import config as JC
    assert _error(lambda: TC.ServingConfig(**kw)) == \
        _error(lambda: JC.ServingConfig(**kw))


def test_more_ranks_than_cards_refused_in_the_references_words(monkeypatch):
    """The reference refuses a mesh wider than its JAX devices; the port
    refuses more ranks than cards without ``--share-card``, in the same
    words up to the device kind and the remedy.  The CPU's ranks are
    processes, so the CPU holds any width."""
    import jax
    from gossip_tpu.config import ServingConfig as JServing
    from gossip_tpu.rpc.batcher import Batcher as JBatcher
    too_many = max(16, len(jax.devices()) * 2)
    ref = _error(lambda: JBatcher(JServing(devices=too_many)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    port = _error(lambda: B.refuse_mesh_width(too_many, "cuda", False))
    head = f"ServingConfig.devices={too_many} but this process has only "
    words = " — the megabatch mesh would silently degrade; "
    assert ref.startswith(head) and port.startswith(head + "1 CUDA device")
    assert words in ref and words in port
    B.refuse_mesh_width(too_many, "cuda", True)     # --share-card holds it
    B.refuse_mesh_width(too_many, "cpu", False)


def test_lanes_must_divide_over_the_ranks_in_the_references_words():
    """A lane count that does not divide by K is refused before any
    collective, in the reference's words for its mesh."""
    import jax
    from gossip_tpu.parallel import sweep as JS
    from gossip_tpu.rpc.batcher import classify_run as jclassify
    from gossip_tpu.backend import request_to_args as jargs
    from jax.sharding import Mesh
    _, jspec, _ = jclassify(jargs(REQS[0]))
    ref = _error(lambda: JS.request_sweep_curves(
        [jspec], mesh=Mesh(jax.devices()[:4], ("request",)), lanes=6))
    group = dataclasses.make_dataclass("G", ["rank", "size", "device"])(
        0, 4, CPU)
    port = _error(lambda: SWP.request_sweep_curves(
        [TB_spec(REQS[0])], group=group, lanes=6))
    assert port == ref
