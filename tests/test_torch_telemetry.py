"""The port's run ledger (``gossip_tpu_torch.utils.telemetry``): the
counterparts of ``tests/test_telemetry.py``, the flight recorder of a
SIGKILLed port command, and one schema with the JAX package: a port
ledger loads through the reference's ``load_ledger(strict=True)`` and
passes its ``tools/telemetry_report.py --check`` health gate."""

import contextlib
import importlib.util
import io
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gossip_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ledger_schema_spans_counters_gauges(tmp_path):
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p, argv=["prog", "--x"]) as led:
        with led.span("outer", tag="t") as ext:
            with led.span("inner"):
                pass
            ext["rows"] = 3
        led.counter("timeouts")
        led.counter("timeouts", 2)
        led.gauge("coverage", 0.5)
        led.event("probe", outcome="ok")
    events = telemetry.load_ledger(p)
    prov = events[0]
    assert prov["ev"] == "provenance"
    for key in ("run_id", "git_commit", "captured", "argv", "torch",
                "schema"):
        assert key in prov, key
    assert prov["argv"] == ["prog", "--x"]
    assert all(e["run"] == prov["run_id"] and "ts" in e for e in events)
    starts = {e["name"]: e for e in events if e["ev"] == "span_start"}
    ends = {e["name"]: e for e in events if e["ev"] == "span_end"}
    assert starts["inner"]["parent"] == starts["outer"]["span"]
    assert ends["outer"]["wall_ms"] >= ends["inner"]["wall_ms"] >= 0
    assert ends["outer"]["ok"] and ends["outer"]["rows"] == 3
    assert starts["outer"]["tag"] == "t"
    assert [e["total"] for e in events if e["ev"] == "counter"] == [1, 3]


def test_span_records_failure_and_start_precedes_work(tmp_path):
    p = str(tmp_path / "led.jsonl")
    led = telemetry.Ledger(p)
    with pytest.raises(RuntimeError):
        with led.span("doomed"):
            raise RuntimeError("boom")
    led.close()
    events = telemetry.load_ledger(p)
    assert next(e for e in events if e["ev"] == "span_end")["ok"] is False
    assert [e["ev"] for e in events] == ["provenance", "span_start",
                                        "span_end"]


def test_from_env_null_and_activate(tmp_path, monkeypatch):
    monkeypatch.delenv(telemetry.ENV_VAR, raising=False)
    led = telemetry.from_env()
    assert isinstance(led, telemetry.NullLedger)
    with led.span("x") as ext:
        ext["k"] = 1
    led.event("y")
    led.counter("z")
    monkeypatch.setenv(telemetry.ENV_VAR, "")
    assert isinstance(telemetry.from_env(str(tmp_path / "d.jsonl")),
                      telemetry.NullLedger)
    p = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(telemetry.ENV_VAR, p)
    real = telemetry.from_env()
    assert real.path == os.path.abspath(p)
    prev = telemetry.activate(real)
    try:
        assert telemetry.current() is real
    finally:
        telemetry.activate(prev)
    real.close()
    assert telemetry.load_ledger(p)[0]["ev"] == "provenance"


def test_torn_lines_dropped_and_strict_mode(tmp_path):
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p) as led:
        led.event("a")
        led.event("b")
    n = len(telemetry.load_ledger(p))
    with open(p, "a") as f:
        f.write('{"ev": "torn_mid_wri')
    assert len(telemetry.load_ledger(p)) == n
    assert len(telemetry.load_ledger(p, strict=True)) == n   # a torn tail
    lines = [ln for ln in open(p).read().splitlines() if ln.strip()]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(lines[0] + "\nGARBAGE\n" + lines[1] + "\n")
    assert len(telemetry.load_ledger(bad)) == 2
    with pytest.raises(ValueError, match="corrupt"):
        telemetry.load_ledger(bad, strict=True)


@pytest.mark.parametrize("torn", ['{"ev": "killed_mid_wri',
                                  '{"ev": "step", "n": 2, "half_writ'])
def test_new_writer_heals_torn_tail_of_shared_file(tmp_path, torn):
    """A writer opening a file whose last line is torn keeps the fragment
    its own (dropped) line; the default reader keeps every event on both
    sides, and strict mode refuses the mid-file tear."""
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p) as led:
        led.event("a")
    with open(p, "a") as f:
        f.write(torn)
    with telemetry.Ledger(p) as led2:
        led2.event("b")
    events = telemetry.load_ledger(p)
    assert [e["ev"] for e in events].count("provenance") == 2
    assert [e["ev"] for e in events if e["ev"] in "ab"] == ["a", "b"]
    with pytest.raises(ValueError, match="corrupt"):
        telemetry.load_ledger(p, strict=True)


def test_load_ledger_run_filter(tmp_path):
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p) as a:
        a.event("first_run_event")
    with telemetry.Ledger(p) as b:
        b.event("second_run_event", trace_id="t1")
    last = telemetry.load_ledger(p, run="last")
    assert {e["run"] for e in last} == {b.run_id}
    only_a = telemetry.load_ledger(p, run=a.run_id)
    assert any(e["ev"] == "first_run_event" for e in only_a)
    assert not any(e["ev"] == "second_run_event" for e in only_a)
    assert [e["ev"] for e in telemetry.load_ledger(p, trace_id="t1")] == [
        "second_run_event"]


def test_reserved_keys_never_collide(tmp_path):
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p) as led:
        led.event("probe", ts="2026-01-01T00:00:00", run="bogus", ev="x")
    events = telemetry.load_ledger(p, run="last")
    probe = next(e for e in events if e["ev"] == "probe")
    assert probe["run"] == events[0]["run_id"]
    assert probe["x_ts"] == "2026-01-01T00:00:00"
    assert probe["x_run"] == "bogus" and probe["x_ev"] == "x"


def test_non_finite_values_stay_strict_json(tmp_path):
    p = str(tmp_path / "led.jsonl")
    with telemetry.Ledger(p) as led:
        led.gauge("bad_rate", float("nan"))
        led.gauge("worse_rate", float("inf"))
        led.event("probe", wall_s=float("-inf"),
                  nested={"deep": float("nan"), "fine": 1.5},
                  npval=np.float32(0.5))
        led.gauge("fine", 0.25)

    def no_constants(s):
        raise ValueError(f"non-strict JSON constant {s!r}")

    with open(p) as f:
        rows = [json.loads(ln, parse_constant=no_constants)
                for ln in f if ln.strip()]
    gauges = {r["name"]: r["value"] for r in rows if r["ev"] == "gauge"}
    assert gauges == {"bad_rate": "nan", "worse_rate": "inf", "fine": 0.25}
    probe = next(r for r in rows if r["ev"] == "probe")
    assert probe["wall_s"] == "-inf"
    assert probe["nested"] == {"deep": "nan", "fine": 1.5}
    assert not any(isinstance(e.get("value"), float)
                   and math.isnan(e["value"])
                   for e in telemetry.load_ledger(p))


def test_disabled_file_keeps_echo_diagnostics(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(telemetry.ENV_VAR, "")
    led = telemetry.from_env(str(tmp_path / "d.jsonl"), echo=True)
    assert isinstance(led, telemetry.EchoLedger) and led.path is None
    led.event("probe", outcome="timeout")
    led.counter("probe_timeouts")
    err = capsys.readouterr().err
    assert '"probe"' in err and "timeout" in err
    assert not os.path.exists(tmp_path / "d.jsonl")


def test_sync_false_event_still_lands_and_skips_fsync(tmp_path):
    p = str(tmp_path / "led.jsonl")
    led = telemetry.Ledger(p)
    before = led.fsyncs
    led.event("driver_timing", sync=False, steady_s=0.1)
    assert led.fsyncs == before
    events = telemetry.load_ledger(p)
    led.close()
    assert any(e["ev"] == "driver_timing" and e["steady_s"] == 0.1
               for e in events)


def test_device_memory_stats_on_the_cpu():
    """No card: no stats (never fabricated zeros), and a snapshot writes
    nothing."""
    assert telemetry.device_memory_stats() is None


def test_handoff_rank_zero_writes_peers_do_not(tmp_path):
    """A spawned group's ranks: rank 0 continues the launcher's file
    under its run id, without a second provenance line; the others are
    peers that write nothing."""
    p = str(tmp_path / "led.jsonl")
    led = telemetry.Ledger(p)
    prev = telemetry.activate(led)
    try:
        handle = telemetry.handoff()
        assert handle == (led.path, led.run_id, True)
        telemetry.adopt(handle, 1)
        assert isinstance(telemetry.current(), telemetry.PeerLedger)
        telemetry.adopt(handle, 0)
        rank0 = telemetry.current()
        rank0.event("driver_timing", steady_s=1.0)
        rank0.close()
    finally:
        telemetry.activate(prev)
        led.close()
    events = telemetry.load_ledger(p, strict=True)
    assert [e["ev"] for e in events] == ["provenance", "driver_timing"]
    assert {e["run"] for e in events} == {led.run_id}
    assert telemetry.handoff() is None          # nothing recording


def _ledger_rank(bad, good, group):
    """One rank of a launched group: the ledger ``cli`` opens for it at an
    unwritable and at a writable path, and a ledgered two-rank run's
    rounds and exit code at the unwritable one."""
    from gossip_tpu_torch import cli
    kinds = []
    for path in (bad, good):
        os.environ[telemetry.ENV_VAR] = path
        led = cli._open_ledger()
        kinds.append(type(led).__name__)
        led.close()
    os.environ[telemetry.ENV_VAR] = bad
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["run", "--mode", "pull", "--n", "1001", "--rumors",
                       "40", "--devices", "2", "--engine", "xla",
                       "--device", "cpu"])
    return kinds, rc, json.loads(buf.getvalue().splitlines()[-1])["rounds"]


def test_group_records_only_when_rank_zero_opened_its_ledger(tmp_path):
    """Under a launcher's group rank 0 decides for every rank: a path it
    cannot open leaves it a NullLedger and the peers too (a peer that
    recorded would wait in the round-metrics flush's collective for a
    rank 0 that never joins it), so the ledgered run ends on both ranks;
    at a writable path rank 0 writes and the other rank is a peer."""
    from gossip_tpu_torch.parallel import group as GR
    (tmp_path / "file").write_text("")
    bad = str(tmp_path / "file" / "led.jsonl")     # under a regular file
    good = str(tmp_path / "led.jsonl")
    got = GR.launch(_ledger_rank, 2, bad, good, device="cpu")
    assert [g[0] for g in got] == [["NullLedger", "Ledger"],
                                   ["NullLedger", "PeerLedger"]]
    assert [g[1] for g in got] == [0, 0]
    assert got[0][2] == got[1][2]
    assert not os.path.exists(bad)


def test_percentile_and_metrics_window():
    assert telemetry.percentile([], 0.5) == 0.0
    assert telemetry.percentile([3, 1, 2], 0.5) == 2.0
    assert telemetry.percentile(range(1, 21), 0.95) == 19.0
    with pytest.raises(ValueError):
        telemetry.percentile([1], 1.5)
    w = telemetry.MetricsWindow(window_s=10.0)
    for i in range(5):
        w.record(float(i), now=100.0 + i)
    w.bump("sheds")
    snap = w.snapshot(now=104.0)
    assert snap["n"] == 5 and snap["p50_ms"] == 2.0 and snap["sheds"] == 1
    assert w.snapshot(now=200.0)["n"] == 0


def test_parse_dryrun_table():
    text = 'noise\n{"dryrun_family_ms": {"a": 1}}\n{"other": 1}\nteardown'
    assert telemetry.parse_dryrun_table(text) == {"dryrun_family_ms":
                                                  {"a": 1}}
    assert telemetry.parse_dryrun_table("nothing") is None


def _cli(args, env=None, **kw):
    return subprocess.run([sys.executable, "-m", "gossip_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO,
                               **(env or {})}, **kw)


@pytest.fixture(scope="module")
def cli_ledger(tmp_path_factory):
    """A port command's ledger: a packed run on two gloo ranks (rank 0
    writes its driver's records into the launcher's file)."""
    path = str(tmp_path_factory.mktemp("cli") / "run.jsonl")
    p = _cli(["run", "--mode", "pull", "--n", "1001", "--rumors", "40",
              "--devices", "2", "--engine", "xla", "--device", "cpu"],
             env={telemetry.ENV_VAR: path}, timeout=300)
    assert p.returncode == 0, p.stderr
    return path, json.loads(p.stdout.strip().splitlines()[-1])


def test_cli_ledger_holds_the_runs_records(cli_ledger):
    path, report = cli_ledger
    events = telemetry.load_ledger(path, strict=True)
    assert events[0]["ev"] == "provenance"
    assert len({e["run"] for e in events}) == 1
    kinds = [e["ev"] for e in events]
    assert "driver_timing" in kinds
    (rm,) = [e for e in events if e["ev"] == "round_metrics"]
    assert rm["driver"] == "simulate_until_packed_sharded"
    assert rm["rounds"] == report["rounds"] and rm["shards"] == 2


def test_reference_reader_and_health_gate_accept_the_port_ledger(
        cli_ledger):
    """One schema: the reference's strict reader parses the port's file
    and its report tool's ``--check`` passes it."""
    from gossip_tpu.utils import telemetry as JT
    path, _ = cli_ledger
    events = JT.load_ledger(path, strict=True)
    assert events == telemetry.load_ledger(path, strict=True)
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(REPO, "tools",
                                         "telemetry_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    assert report.main([path, "--check"]) == 0
    assert isinstance(report.render_markdown(events), str)


@pytest.mark.skipif(not hasattr(signal, "SIGKILL"), reason="needs SIGKILL")
def test_flight_recorder_survives_sigkill_mid_run(tmp_path):
    """SIGKILL a checkpointed port command mid-run: the ledger still
    parses strictly, provenance first, and its last ``checkpoint`` event
    is the checkpoint file's durable round."""
    ledger = str(tmp_path / "killed.jsonl")
    ckpt = str(tmp_path / "c.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gossip_tpu_torch", "run", "--mode",
         "pushpull", "--n", "20000", "--max-rounds", "400", "--checkpoint",
         ckpt, "--checkpoint-every", "2", "--device", "cpu"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, telemetry.ENV_VAR: ledger},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            assert proc.poll() is None, "the run ended before the kill"
            if os.path.exists(ledger) and sum(
                    e["ev"] == "checkpoint"
                    for e in telemetry.load_ledger(ledger)) >= 2:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
        else:
            pytest.fail("no checkpoint event within 120 s")
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    events = telemetry.load_ledger(ledger, strict=True)
    assert events[0]["ev"] == "provenance"
    rounds = [e["round"] for e in events if e["ev"] == "checkpoint"]
    assert rounds == list(range(2, 2 * len(rounds) + 1, 2))
    with np.load(ckpt, allow_pickle=False) as z:
        durable = json.loads(str(z["__meta__"]))["extra"]["round"]
    # the kill can land between a save and its event, never before
    assert rounds[-1] in (durable, durable - 2)
