"""The failover router (``gossip_tpu_torch.rpc.router``) and the serving
commands (``serve``, ``route``, ``fleet-status``): the control plane's
views against the JAX package's ``ControlPlane`` after the same
operations, the probe hysteresis against its ``Router``, shedding and
deadlines, the client's retry budget, and one spawned fleet of two
``python -m gossip_tpu_torch serve --device cpu`` replicas for the
failover of an in-flight request (bitwise the replay's reply), the
control-plane catch-up of a restarted replica and ``fleet-status``'s
exit codes.  Needs ``grpc`` (the transport)."""

import json
import threading
import time

import numpy as np
import pytest

from gossip_tpu_torch import cli as TCLI
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.rpc import router as RT
from gossip_tpu_torch.rpc import sidecar as SC
from gossip_tpu_torch.utils import telemetry

grpc = pytest.importorskip("grpc")

# (operation, replica) scripts run on both control planes
SCRIPT = [("append_up", 0), ("append_up", 1), ("append_down", 0),
          ("gossip", None), ("append_up", 2), ("gossip", None),
          ("gossip", None), ("flush", 1), ("wipe", 0), ("catchup", 0),
          ("append_up", 0), ("gossip", None), ("wipe", 2),
          ("append_down", 1), ("catchup", 2), ("gossip", None)]


def _apply(cp, op, i, up, down):
    if op == "append_up":
        return cp.append(i, up)
    if op == "append_down":
        return cp.append(i, down)
    if op == "gossip":
        return cp.gossip_tick()
    return getattr(cp, op)(i)


def test_control_plane_views_equal_the_references():
    """Every view, epoch and state after each step of :data:`SCRIPT` is
    the reference's (its ``ops/logs`` on JAX arrays, the port's on CPU
    tensors)."""
    from gossip_tpu.rpc import router as JRT
    port, ref = RT.ControlPlane(3, 8), JRT.ControlPlane(3, 8)
    assert port.width == ref.width
    for op, i in SCRIPT:
        got = _apply(port, op, i, RT.STATE_UP, RT.STATE_DOWN)
        want = _apply(ref, op, i, JRT.STATE_UP, JRT.STATE_DOWN)
        assert got == want, (op, i)
        assert np.array_equal(port.views, np.asarray(ref.views)), (op, i)
        assert port.epochs() == ref.epochs()
        assert [port.state_of(j) for j in range(3)] == \
            [ref.state_of(j) for j in range(3)]
        assert [port.epoch(j) for j in range(3)] == \
            [ref.epoch(j) for j in range(3)]


def test_control_plane_full_ring_refused_in_the_references_words():
    from gossip_tpu.rpc import router as JRT
    msgs = []
    for M in (RT, JRT):
        cp = M.ControlPlane(1, 4)
        for state in (M.STATE_UP, M.STATE_DOWN, M.STATE_UP, M.STATE_DOWN):
            cp.append(0, state)
        with pytest.raises(ValueError) as ei:
            cp.append(0, M.STATE_UP)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "ring wrap" in msgs[0]


# a scripted probe sequence: admission, a blip, a down, a flap, a return
PROBES = [True, False, False] + [True, False] * 3 + [True, True, True,
                                                      False, True]


def test_probe_hysteresis_follows_the_reference():
    from gossip_tpu import config as JC
    from gossip_tpu.rpc import router as JRT
    states = []
    for M, cfg in ((RT, TC.FleetConfig), (JRT, JC.FleetConfig)):
        router = M.Router(["127.0.0.1:1", "127.0.0.1:2"],
                          cfg(down_after=2, up_after=3,
                              probe_interval_ms=10_000))
        r = router.replicas[0]
        try:
            seq = []
            for ok in PROBES:
                router.observe_probe(r, ok)
                seq.append((r.healthy, router.control.epoch(0),
                            router.control.state_of(0)))
            states.append(seq)
        finally:
            router.close()
    assert states[0] == states[1]
    # the flap kept it out until three healthy probes in a row
    healthy = [h for h, _, _ in states[0]]
    assert healthy == [True, True, False] + [False] * 6 + \
        [False, False, True, True, True]


class _Ctx:
    """A server context stand-in: a deadline and a recording abort."""

    def __init__(self, remaining=None):
        self._remaining = remaining
        self.code = self.details = None

    def time_remaining(self):
        return self._remaining

    def invocation_metadata(self):
        return ()

    def abort(self, code, details):
        self.code, self.details = code, details
        raise SC.Aborted(code, details)


def test_router_sheds_and_honors_abandoned_deadlines(tmp_path):
    led_path = str(tmp_path / "router.jsonl")
    led = telemetry.Ledger(led_path)
    prev = telemetry.activate(led)
    router = RT.Router(["127.0.0.1:1"],
                       TC.FleetConfig(probe_interval_ms=10_000))
    try:
        ctx = _Ctx()
        with pytest.raises(SC.Aborted, match="shed"):
            router.dispatch("run", b"{}", ctx)
        assert ctx.code is SC.StatusCode.RESOURCE_EXHAUSTED
        router.observe_probe(router.replicas[0], True)
        ctx = _Ctx(remaining=-0.01)
        with pytest.raises(SC.Aborted, match="deadline"):
            router.dispatch("run", b"{}", ctx)
        assert ctx.code is SC.StatusCode.DEADLINE_EXCEEDED
        assert router.counters["failovers"] == 0
        assert router.counters["deadline_rejects"] == 1
        router.replicas[0].inflight = router.cfg.max_inflight
        ctx = _Ctx()
        with pytest.raises(SC.Aborted, match="shed"):
            router.dispatch("run", b"{}", ctx)
        assert ctx.code is SC.StatusCode.RESOURCE_EXHAUSTED
    finally:
        router.close()
        telemetry.activate(prev)
        led.close()
    sheds = [e for e in telemetry.load_ledger(led_path)
             if e.get("ev") == "shed"]
    assert [e["reason"] for e in sheds] == [
        "no healthy replica", "all replicas at the in-flight cap"]


def test_client_retry_budget_clamps_attempt_deadlines():
    class Unavailable(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNAVAILABLE

        def details(self):
            return "fake transport failure"

    client = SC.SidecarClient("127.0.0.1:1", max_attempts=4,
                              backoff_base=0.03, backoff_cap=0.05)
    calls = []

    def fake(payload, timeout=None, metadata=None):
        calls.append((timeout, time.monotonic()))
        raise Unavailable()
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError):
        client._call_with_retry(fake, b"{}", 0.5, "run")
    timeouts = [c[0] for c in calls]
    assert len(calls) == 4
    assert all(a > b for a, b in zip(timeouts, timeouts[1:]))
    for tmo, at in calls:
        assert abs(tmo - (t0 + 0.5 - at)) < 0.05
    assert time.monotonic() - t0 < 0.7
    client2 = SC.SidecarClient("127.0.0.1:1", max_attempts=4,
                               backoff_base=0.2, backoff_cap=0.4)
    calls.clear()
    with pytest.raises(grpc.RpcError):
        client2._call_with_retry(fake, b"{}", 0.05, "run")
    assert len(calls) < 4
    client.close()
    client2.close()


def test_replica_health_reports_one_serving_device():
    """A replica serves on one device (the request-axis mesh is not
    ported), and its ``Health`` and ``Metrics`` say so over gRPC."""
    server, port = SC.serve(port=0, max_workers=2,
                            batching=TC.ServingConfig(tick_ms=25.0),
                            device="cpu")
    client = SC.SidecarClient(f"127.0.0.1:{port}")
    try:
        assert client.health()["serving_devices"] == 1
        assert client.metrics()["serving_devices"] == 1
    finally:
        client.close()
        server.gossip_batcher.close()
        server.stop(grace=None)


def test_fleet_env_carries_the_repository_and_the_store(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    monkeypatch.delenv("GOSSIP_COMPILE_CACHE", raising=False)
    env = RT.fleet_env("/store")
    assert env["PYTHONPATH"].split(":")[:2] == [RT._REPO, "/elsewhere"]
    assert env["GOSSIP_COMPILE_CACHE"] == "/store"
    assert "GOSSIP_COMPILE_CACHE" not in RT.fleet_env()


@pytest.mark.parametrize("argv,words", [
    (["route", "--replicas", "0"], "replicas must be >= 1"),
    (["route", "--devices-per-replica", "3"], "power of two"),
    (["route", "--devices-per-replica", "4", "--no-batching"],
     "--devices-per-replica needs batching replicas"),
    (["serve", "--devices", "3", "--device", "cpu"], "power of two"),
    (["serve", "--num-processes", "2", "--coordinator", "h:1",
      "--device", "cpu"], "not ported yet"),
    (["serve", "--batch-tick-ms", "0", "--device", "cpu"],
     "tick_ms must be > 0"),
])
def test_serving_flag_refusals(capsys, argv, words):
    assert TCLI.main(argv) == 2
    assert words in capsys.readouterr().err


def test_serve_refuses_more_ranks_than_cards(capsys, monkeypatch):
    """``serve --devices 2`` on one card without ``--share-card`` exits 2
    in the reference's words, before any rank starts."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TCLI.main(["serve", "--port", "0", "--devices", "2"]) == 2
    err = capsys.readouterr().err
    assert "ServingConfig.devices=2 but this process has only 1 CUDA " \
        "device(s) — the megabatch mesh would silently degrade" in err


def test_replica_health_reports_its_mesh_width():
    """A replica serving a K = 2 megabatch mesh says so in ``Health`` and
    ``Metrics`` over gRPC; closing its batcher stops both ranks."""
    import os
    server, port = SC.serve(port=0, max_workers=2, device="cpu",
                            batching=TC.ServingConfig(tick_ms=25.0,
                                                      devices=2))
    pids = server.gossip_batcher.pool_pids()
    client = SC.SidecarClient(f"127.0.0.1:{port}")
    try:
        assert client.health()["serving_devices"] == 2
        assert client.metrics()["serving_devices"] == 2
    finally:
        client.close()
        server.gossip_batcher.close()
        server.stop(grace=None)
    assert len(pids) == 2
    assert not any(os.path.exists(f"/proc/{p}") for p in pids)


def test_replica_device_verification_refuses_degraded_mesh(monkeypatch):
    """A replica that serves one device where the fleet wants two is
    refused loudly (the reference's check), and a fleet whose replica
    comes up narrower kills it before it raises."""
    server, port = SC.serve(port=0, max_workers=2, device="cpu",
                            batching=TC.ServingConfig(tick_ms=25.0))
    try:
        addr = f"127.0.0.1:{port}"
        RT._verify_replica_devices(addr, "r0_g0", 1)
        with pytest.raises(RuntimeError) as ei:
            RT._verify_replica_devices(addr, "r0_g0", 2)
        assert "serving_devices=1" in str(ei.value)
        assert "devices_per_replica=2" in str(ei.value)
    finally:
        server.gossip_batcher.close()
        server.stop(grace=None)
    started = []
    real = RT._start_replica

    def start(*a, **kw):
        out = real(*a, **kw)
        started.append(out[0])
        return out
    monkeypatch.setattr(RT, "_start_replica", start)
    with pytest.raises(RuntimeError, match="serving_devices=1"):
        RT.Fleet(n=1, cfg=TC.FleetConfig(devices_per_replica=2),
                 replica_argv=["--device", "cpu"])
    assert len(started) == 1 and started[0].poll() is not None


def test_fleet_status_unreachable_exits_2(capsys):
    assert TCLI.main(["fleet-status", "127.0.0.1:1", "--timeout",
                      "0.5"]) == 2
    assert "unreachable" in capsys.readouterr().err


def _req(seed):
    return dict(backend="jax-tpu", proto={"mode": "pushpull", "fanout": 2},
                topology={"family": "complete", "n": 200},
                run={"max_rounds": 6, "engine": "xla", "seed": seed},
                curve=True)


def test_spawned_fleet_fails_over_an_inflight_request(tmp_path, capsys):
    """Two spawned replicas (collector tick 700 ms) behind the router:
    a request waits in replica 0's queue, replica 0 is SIGKILLed, and
    the router redispatches it to replica 1, whose reply is bitwise the
    replay's (and the port's solo run's numbers).  ``fleet-status``
    exits 0 before the kill and 1 after; the restarted replica rejoins
    after a control-plane catch-up."""
    led_path = str(tmp_path / "fleet.jsonl")
    led = telemetry.Ledger(led_path)
    prev = telemetry.activate(led)
    fleet = RT.Fleet(n=2, cfg=TC.FleetConfig(probe_interval_ms=100,
                                             down_after=1, up_after=2),
                     workdir=str(tmp_path / "fleet"),
                     replica_argv=["--device", "cpu", "--batch-tick-ms",
                                   "700"])
    try:
        assert fleet.router.wait_healthy(2, timeout_s=60)
        assert TCLI.main(["fleet-status", fleet.address]) == 0
        assert "fleet 2/2 healthy" in capsys.readouterr().out
        client = SC.SidecarClient(fleet.address, max_attempts=1)
        # a replica's well-formed refusal passes through as it is
        with pytest.raises(grpc.RpcError) as ei:
            client._call_with_retry(client._run, b'{"nope": 1}', 30, "run")
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert ei.value.details() == "unknown request fields: ['nope']"
        assert fleet.router.stats()["failovers"] == 0
        out = {}
        t = threading.Thread(target=lambda: out.update(
            a=client.run(timeout=120, **_req(0))))
        t.start()
        deadline = time.monotonic() + 10
        while fleet.router.replicas[0].inflight == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        assert fleet.router.replicas[0].inflight == 1
        fleet.kill(0)
        t.join(timeout=120)
        a = out["a"]
        s = fleet.router.stats()
        assert s["failovers"] >= 1 and s["states"][0] == "down"
        assert a["meta"]["batch"]["batched"] is True
        replay = client.run(timeout=120, **_req(0))
        for field in ("curve", "msgs", "coverage", "rounds", "mode", "n"):
            assert replay[field] == a[field], field
        assert replay["meta"]["state_digest"] == a["meta"]["state_digest"]
        from gossip_tpu_torch.backend import dispatch, request_to_args
        solo = dispatch(**request_to_args(_req(0)), device="cpu")
        assert solo.curve == a["curve"] and solo.msgs == a["msgs"]
        assert TCLI.main(["fleet-status", fleet.address, "--json"]) == 1
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert doc["degraded"] and "replica 0 down" in doc["reasons"]
        fleet.restart(0)
        assert fleet.router.wait_healthy(2, timeout_s=60)
        assert fleet.router.stats()["catchups"] == 1
        assert fleet.router.control.epochs()[0] == 3       # up, down, up
        client.close()
    finally:
        fleet.close()
        telemetry.activate(prev)
        led.close()
    kinds = {e.get("ev") for e in telemetry.load_ledger(led_path)}
    assert {"replica_down", "failover", "replica_up",
            "control_catchup"} <= kinds
