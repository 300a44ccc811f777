"""The port's serving tools (``gossip_tpu_torch.tools.load_harness``,
``fleet_crashloop`` and ``trace_report``) and the mesh through a spawned
fleet, on the CPU: each tool's smoke holds the reference's gates, the
harness's request mix equals the JAX package's ``run_simulation``
(tolerance 0: curve, msgs, coverage, rounds), and the trace report joins
the router's and a replica's ledgers into the waterfalls the repository's
``tools/trace_report.py`` prints from the same files.  Needs ``grpc``."""

import contextlib
import io
import json
import os
import signal
import sys
import time

import pytest
import torch

from gossip_tpu_torch import backend as TB
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.rpc import router as RT
from gossip_tpu_torch.rpc import sidecar as SC
from gossip_tpu_torch.tools import fleet_crashloop as FC
from gossip_tpu_torch.tools import load_harness as LH
from gossip_tpu_torch.tools import trace_report as TR
from gossip_tpu_torch.utils import telemetry

grpc = pytest.importorskip("grpc")

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    """``(exit code, the last JSON line)`` of a tool's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return code, json.loads(lines[-1])


def _events(path, kind):
    return [e for e in telemetry.load_ledger(path) if e.get("ev") == kind]


def test_load_harness_smoke_holds_its_gates(tmp_path):
    out = str(tmp_path / "serving.jsonl")
    code, line = _run(LH.main, ["--smoke", "--device", "cpu", "--out", out])
    assert code == 0 and line["ok"] and line["bitwise_equal"]
    assert line["steady_all_warm"] and line["max_batch_size"] > 1
    path = out[:-len(".jsonl")] + ".smoke.jsonl"
    (gate,) = _events(path, "serving_gate")
    assert gate["ok"] and gate["coalesced"] and gate["measure_compiles"] == 0
    legs = {e["leg"]: e for e in _events(path, "load_leg")}
    assert set(legs) == {"solo", "batched"}
    for leg in legs.values():
        assert leg["errors"] == 0 and leg["requests"] == 8
        assert 0 < leg["p50_ms"] <= leg["p95_ms"] <= leg["p99_ms"]


def test_load_harness_mesh_smoke_holds_its_gates(tmp_path):
    """``--mesh-devices 1,2`` at a steady arrival rate: both legs bitwise
    the driver's references, no kernel build in either window, and the
    scaling's resolution recorded with its reason (eight schedulable CPUs
    or fewer decide it here)."""
    out = str(tmp_path / "mesh.jsonl")
    code, line = _run(LH.main, ["--smoke", "--device", "cpu",
                                "--mesh-devices", "1,2", "--connections",
                                "16", "--rate", "40", "--out", out])
    assert code == 0 and line["ok"] and line["bitwise_equal"]
    assert line["steady_all_warm"]
    (gate,) = _events(out[:-len(".jsonl")] + ".smoke.jsonl",
                      "meshserve_gate")
    assert gate["ok"] and gate["mismatches"] == 0 and gate["errors"] == 0
    assert set(gate["legs"]) == {"mesh_r1_d1", "mesh_r1_d2"}
    assert gate["legs"]["mesh_r1_d2"]["devices"] == 2
    assert gate["legs"]["mesh_r1_d2"]["rate"] == 40.0
    assert gate["scaling_resolved"] == (gate["sched_cpus"] >= 2)
    assert "CPU ranks" in gate["scaling_reason"]
    assert gate["min_ratio"] == 0.0     # --smoke: no throughput gate


def test_mesh_gate_holds_the_references_bounds():
    """The ratio gate's bounds are the reference's: 1.5 by default, the
    serial floor 0.85 where the scaling is unresolved."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import load_harness as ref
    finally:
        sys.path.pop(0)
    assert LH._SERIAL_HOST_FLOOR == ref._SERIAL_HOST_FLOOR == 0.85
    assert LH.parser().parse_args([]).mesh_min_ratio == 1.5
    assert LH.parser().parse_args([]).min_ratio == 3.0
    assert LH.request_mix(n=64, rounds=4, repeats=2) == ref.request_mix(
        n=64, rounds=4, repeats=2)
    resolved, _, reason = LH.scaling_resolution(2, torch.device("cuda"))
    assert not resolved and "share one card" in reason


SMOKE_MIX = LH.request_mix(n=128, rounds=8, repeats=2)


@pytest.fixture(scope="module")
def harness_references():
    return LH.reference_replies(SMOKE_MIX, TC.ServingConfig(), CPU)


@pytest.mark.parametrize("i", range(len(SMOKE_MIX)))
def test_harness_mix_equals_the_references_run_simulation(
        harness_references, monkeypatch, i):
    """Every reply the harness holds its legs to is the JAX package's
    ``run_simulation`` of the same request."""
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")
    from gossip_tpu.backend import request_to_args, run_simulation
    ref = run_simulation(**request_to_args(dict(SMOKE_MIX[i]))).to_dict()
    got = harness_references[i]
    for field in ("curve", "msgs", "coverage", "rounds"):
        assert got[field] == ref[field], field


def test_fleet_crashloop_smoke_holds_its_gates(tmp_path):
    out = str(tmp_path / "fleet.jsonl")
    code, line = _run(FC.main, ["--smoke", "--device", "cpu", "--workdir",
                                str(tmp_path / "fleet"), "--out", out])
    assert code == 0 and line["ok"]
    assert line["kills"] == 1 and line["acked"] == line["requests"] == 8
    assert line["bitwise_equal"] and line["failovers"] >= 1
    assert line["healthy"] == 2
    (verdict,) = _events(out, "verdict")
    assert verdict["ok"] and verdict["zero_acked_loss"]
    assert verdict["recovered_full_capacity"] and verdict["problems"] == []
    kinds = {e.get("ev") for e in telemetry.load_ledger(out)}
    assert {"kill", "replica_down", "failover", "replica_up",
            "control_catchup"} <= kinds


def test_replica_mesh_argv(monkeypatch):
    assert RT.replica_mesh_argv(1, "cpu") == []
    assert RT.replica_mesh_argv(2, "cpu") == ["--devices", "2"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert RT.replica_mesh_argv(4) == ["--devices", "4", "--share-card"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert RT.replica_mesh_argv(4, "cuda") == ["--devices", "4"]


def _ranks_of(pid):
    """The pids of the spawned ranks (``multiprocessing`` spawn children)
    of process ``pid``."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and b"spawn_main" in cmd:
            out.append(int(d))
    return sorted(out)


def _live(pids, wait_s=30.0):
    """Those of ``pids`` still running (zombies count as ended) after
    waiting up to ``wait_s`` for them to end."""
    deadline = time.monotonic() + wait_s
    while True:
        live = []
        for p in pids:
            try:
                with open(f"/proc/{p}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state != "Z":
                live.append(p)
        if not live or time.monotonic() > deadline:
            return live
        time.sleep(0.1)


@pytest.mark.parametrize("sig", ["SIGKILL", "SIGTERM"])
def test_stopped_mesh_replica_leaves_no_rank(tmp_path, sig):
    """A ``serve --devices 2 --device cpu`` replica sent ``sig`` (the
    replica alone, not its session) leaves neither rank alive: a rank
    ends when its spawner is gone, and SIGTERM runs serve's shutdown."""
    proc, _ = RT.spawn_replica(str(tmp_path), "r",
                               ["--devices", "2", "--device", "cpu"],
                               env=RT.fleet_env())
    try:
        ranks = _ranks_of(proc.pid)
        assert len(ranks) == 2
        os.kill(proc.pid, getattr(signal, sig))
        assert proc.wait(timeout=60) == (-9 if sig == "SIGKILL" else 143)
        assert _live(ranks) == []
    finally:
        RT.kill_replica(proc)


def _traced_req(seed):
    return {"backend": "jax-tpu", "proto": {"mode": "pushpull", "fanout": 2},
            "topology": {"family": "complete", "n": 200},
            "run": {"max_rounds": 6, "engine": "xla", "seed": seed},
            "curve": True}


@pytest.fixture(scope="module")
def mesh_fleet(tmp_path_factory):
    """One spawned replica serving ``--devices 2 --device cpu`` behind the
    router, writing its own ledger; three traced requests through the
    router at once, the router's events in this process's ledger."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("mesh_fleet")
    router_led = str(tmp / "router.jsonl")
    replica_led = str(tmp / "replica.jsonl")
    led = telemetry.Ledger(router_led)
    prev = telemetry.activate(led)
    env = {**RT.fleet_env(), "GOSSIP_TELEMETRY": replica_led}
    fleet = RT.Fleet(n=1, cfg=TC.FleetConfig(devices_per_replica=2),
                     workdir=str(tmp / "fleet"), env=env,
                     replica_argv=[*RT.replica_mesh_argv(2, "cpu"),
                                   "--device", "cpu", "--batch-tick-ms",
                                   "300"])
    try:
        assert fleet.router.wait_healthy(1, timeout_s=60)
        health = SC.SidecarClient(fleet.router.replicas[0].address)
        width = health.health()["serving_devices"]
        health.close()
        client = SC.SidecarClient(fleet.address, max_attempts=1)
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda s: client.run(
                timeout=120, **_traced_req(s)), range(3)))
        client.close()
        ranks = _ranks_of(fleet.router.replicas[0].proc.pid)
    finally:
        fleet.close()
        telemetry.activate(prev)
        led.close()
    return {"width": width, "replies": replies, "ranks": ranks,
            "live_after_close": _live(ranks),
            "ledgers": [router_led, replica_led]}


def test_route_devices_per_replica_serves_the_mesh(mesh_fleet):
    """``serve --devices 2`` behind ``route``'s fleet: the replica reports
    its width, and each reply came off the two ranks, bitwise the port's
    solo run."""
    assert mesh_fleet["width"] == 2
    for seed, rep in enumerate(mesh_fleet["replies"]):
        assert rep["meta"]["devices"] == 2
        assert rep["meta"]["batch"]["batched"] is True
        solo = TB.dispatch(**TB.request_to_args(_traced_req(seed)),
                           device=CPU)
        assert (rep["curve"], rep["msgs"], rep["rounds"]) == \
            (solo.curve, solo.msgs, solo.rounds)


def test_fleet_close_leaves_no_rank(mesh_fleet):
    """Closing the fleet kills each replica's session: its two ranks
    end with it."""
    assert len(mesh_fleet["ranks"]) == 2
    assert mesh_fleet["live_after_close"] == []


def test_trace_report_joins_the_router_and_the_replica(mesh_fleet, capsys):
    """Each traced request's router half (this process's ledger) and
    replica half (the replica's) join into one complete waterfall, and
    the report is the repository's ``tools/trace_report.py``'s on the same
    ledgers, less the markdown heading (it names the tool)."""
    paths = mesh_fleet["ledgers"]
    rows = TR.waterfalls(TR.load_events(paths))
    assert len(rows) == 3 and all(r["complete"] for r in rows)
    assert all(r["batched"] and r["replica"] == 0 for r in rows)
    assert all(r["queue_wait_ms"] is not None for r in rows)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import trace_report as ref
    finally:
        sys.path.pop(0)
    outs = {}
    for name, mod in (("port", TR), ("ref", ref)):
        for flag in ("--json", None):
            assert mod.main([*paths, *([flag] if flag else [])]) == 0
            outs[name, flag] = capsys.readouterr().out
    assert json.loads(outs["port", "--json"]) == \
        json.loads(outs["ref", "--json"])
    port_md, ref_md = (outs[k, None].splitlines() for k in ("port", "ref"))
    assert port_md[0] == "## Request traces (trace_id join, " \
        "gossip_tpu_torch/tools/trace_report.py)"
    assert port_md[1:] == ref_md[1:]
    tid = rows[0]["trace_id"]
    assert TR.main([*paths, "--trace", tid]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["waterfall"]["trace_id"] == tid and doc["events"]
