"""The port's profile hooks (``gossip_tpu_torch.utils.trace``), its
build-cache flags, the checkpoint and streamed planner's ledger events
against the JAX package's, and the crashloop harness's one-kill smoke on
the CPU."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gossip_tpu_torch import cli as tcli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.planner import budget as PB
from gossip_tpu_torch.utils import telemetry as PT
from gossip_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The reference's executable store off, and the port's kernel store
    restored after each test (the flags set it process-wide)."""
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")
    monkeypatch.setattr(_kernels, "_STORE", {"dir": None, "fresh": False})


def _chrome_events(logdir):
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "prof")
    with trace.trace(logdir, "cpu") as prof:
        with trace.annotate("phase"):
            torch.ones(64).cumsum(0)
    assert prof.trace_path.startswith(logdir)
    names = {e.get("name") for e in _chrome_events(logdir)}
    assert "phase" in names
    with trace.trace(None) as off:          # no directory: a plain block
        assert off is None


def test_profile_hook_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv(trace.PROFILE_ENV, raising=False)
    assert trace.profile_dir() is None
    with trace.profile("bench:cpu", "cpu"):
        pass
    logdir = str(tmp_path / "amb")
    monkeypatch.setenv(trace.PROFILE_ENV, logdir)
    with trace.profile("bench:cpu", "cpu"):
        torch.arange(10).sum()
    assert "bench:cpu" in {e.get("name") for e in _chrome_events(logdir)}


def test_round_timer_percentiles():
    t = trace.RoundTimer()
    t.times = [0.001 * i for i in range(1, 21)]
    assert t.mean_ms == pytest.approx(10.5)
    assert t.p50_ms == pytest.approx(10.0)
    assert t.p95_ms == pytest.approx(19.0)
    assert trace.RoundTimer().p95_ms == 0.0
    with t:
        pass
    assert len(t.times) == 21


def test_run_profile_puts_the_logdir_on_the_line(tmp_path, capsys):
    logdir = str(tmp_path / "p")
    assert tcli.main(["run", "--mode", "pull", "--n", "500", "--device",
                      "cpu", "--profile", logdir]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["profile_logdir"] == logdir
    assert os.listdir(logdir)


def _line(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the commands' small lines: (argv, where the reference puts the key)
CACHE_LINES = [
    ("run", ["run", "--mode", "pull", "--n", "300"]),
    ("crdt", ["crdt", "--n", "32", "--max-rounds", "20"]),
    ("log", ["log", "--n", "32", "--keys", "2", "--send", "0:0:0:9"]),
    ("txn", ["txn", "--n", "32", "--keys", "4"]),
]


@pytest.mark.parametrize("name,argv", CACHE_LINES,
                         ids=[c[0] for c in CACHE_LINES])
def test_compile_cache_key_where_the_reference_puts_it(name, argv, capsys,
                                                       tmp_path):
    """``compile_cache`` is on the lines the reference puts it on: the
    store's directory, or null with the cache off (the reference's
    ``--no-compile-cache`` line, in this process)."""
    from gossip_tpu import cli as jcli
    want = _line(jcli.main, argv + ["--no-compile-cache"], capsys)
    off = _line(tcli.main, argv + ["--no-compile-cache", "--device", "cpu"],
                capsys)
    assert "compile_cache" in want and want["compile_cache"] is None
    assert off["compile_cache"] is None
    store = str(tmp_path / "store")
    on = _line(tcli.main, argv + ["--compile-cache", store, "--device",
                                  "cpu"], capsys)
    assert on["compile_cache"] == store
    assert _kernels.build_dir() == _kernels.Path(store).resolve()


def test_ensemble_and_scale_run_lines_carry_no_cache_key(tmp_path, capsys):
    """As the reference's: ``run --ensemble`` and ``scale-run`` print no
    ``compile_cache``; the flags are taken all the same."""
    ens = _line(tcli.main, ["run", "--mode", "pushpull", "--n", "200",
                            "--ensemble", "2", "--max-rounds", "10",
                            "--no-compile-cache", "--device", "cpu"], capsys)
    assert "compile_cache" not in ens
    pf = str(tmp_path / "plan.json")
    with open(pf, "w") as f:
        f.write(_forced_plan(PB, TC).to_json())
    line = _line(tcli.main, ["scale-run", "--plan", pf, "--compile-cache",
                             str(tmp_path / "s"), "--device", "cpu"], capsys)
    assert "compile_cache" not in line


def test_fresh_store_is_a_cold_temporary_directory():
    d = _kernels.use_fresh_build_dir()
    assert d.exists() and _kernels._STORE["fresh"]
    assert _kernels.build_dir() == d
    lib = _kernels.FUSED_ROUND.library()
    assert lib.parent == d and not lib.exists()


def _mixed(C):
    return C.FaultConfig(drop_prob=0.05, seed=2, churn=C.ChurnConfig(
        events=((3, 1, 4), (9, 2, -1)), partitions=((1, 4, 256),),
        ramp=(0, 3, 0.0, 0.15)))


def _forced_plan(B, C, tiles=2):
    """The forced plan of tests/test_torch_scale_stream.py."""
    fault = _mixed(C)
    dev = B.forced_device_for_tiles(512, rumors=128, fanout=2, max_rounds=6,
                                    fault=fault, tiles_at_least=tiles,
                                    devices=1, host_ram_bytes=1 << 30)
    return B.plan_scale(512, rumors=128, device=dev, fanout=2, max_rounds=6,
                        fault=fault, segment_every=3, seed=0)


@pytest.fixture(scope="module")
def ref():
    from gossip_tpu import cli as jcli
    from gossip_tpu import config as JC
    from gossip_tpu.planner import budget as JB
    from gossip_tpu.utils import telemetry as JT
    return types.SimpleNamespace(cli=jcli, C=JC, B=JB, T=JT)


def _ledgered(T, path, main, argv, capsys):
    led = T.Ledger(path)
    prev = T.activate(led)
    try:
        assert main(argv) == 0
        capsys.readouterr()
    finally:
        T.activate(prev)
        led.close()
    return [e for e in T.load_ledger(path, strict=True)
            if e["ev"] != "provenance"]


# fields that are walls, paths or a backend's own measurement
WALLS = {"ts", "run", "wall_ms", "wait_ms", "put_ms", "dispatch_ms",
         "copy_ms", "overlap_efficiency", "path", "measured_bytes",
         "measured_loop_bytes", "ok", "headroom_frac", "source"}


def _fields(events, kinds):
    return [(e["ev"], {k: v for k, v in e.items() if k not in WALLS})
            for e in events if e["ev"] in kinds]


def test_scale_and_xcheck_events_equal_the_reference(ref, tmp_path, capsys):
    """On the scale-stream tests' forced plan (2 tiles, 6 rounds every 3, the mixed
    program) the streamed run writes the reference's ``scale_plan``,
    ``tile_stream``, ``scale_segment``, ``scale_run`` and
    ``budget_xcheck`` events, field for field less walls and the
    backend's own memory reading."""
    pf = str(tmp_path / "plan.json")
    with open(pf, "w") as f:
        f.write(_forced_plan(PB, TC).to_json())
    kinds = {"scale_plan", "tile_stream", "scale_segment", "scale_run",
             "budget_xcheck"}
    got = _ledgered(PT, str(tmp_path / "p.jsonl"), tcli.main, [
        "scale-run", "--plan", pf, "--checkpoint", str(tmp_path / "p.npz"),
        "--measure-memory", "--check-bitwise", "--device", "cpu"], capsys)
    want = _ledgered(ref.T, str(tmp_path / "r.jsonl"), ref.cli.main, [
        "scale-run", "--plan", pf, "--checkpoint", str(tmp_path / "r.npz"),
        "--measure-memory", "--check-bitwise"], capsys)
    for kind in kinds:
        assert _fields(got, {kind}) == _fields(want, {kind}), kind
    # the port's budget_xcheck follows its first segment's tiles: its
    # peak is read over them, where the reference's XLA analysis is read
    # before the first dispatch
    assert [e["ev"] for e in got if e["ev"] in kinds] == [
        "scale_plan", "tile_stream", "tile_stream", "budget_xcheck",
        "scale_segment", "tile_stream", "tile_stream", "scale_segment",
        "scale_run"]
    for kind in kinds:
        assert ({k for e in got if e["ev"] == kind for k in e}
                == {k for e in want if e["ev"] == kind for k in e}), kind


def test_checkpoint_flight_record_equals_the_reference(ref, tmp_path,
                                                      capsys):
    """One ``checkpoint`` event a published checkpoint, with the round and
    under the program the exact dropped total, as the reference's."""
    argv = ["run", "--mode", "pushpull", "--n", "1000", "--fanout", "2",
            "--max-rounds", "12", "--checkpoint-every", "4",
            "--churn-event", "3:2:6", "--churn-event", "7:3",
            "--partition", "2:6:500", "--drop-ramp", "1:4:0.0:0.15"]
    got = _ledgered(PT, str(tmp_path / "p.jsonl"), tcli.main, argv + [
        "--checkpoint", str(tmp_path / "p.npz"), "--device", "cpu"], capsys)
    want = _ledgered(ref.T, str(tmp_path / "r.jsonl"), ref.cli.main, argv + [
        "--checkpoint", str(tmp_path / "r.npz")], capsys)
    rows = [_fields(x, {"checkpoint"}) for x in (got, want)]
    assert rows[0] == rows[1]
    assert [f["round"] for _, f in rows[0]] == [4, 8, 12]
    assert all(f["dropped"] > 0 for _, f in rows[0][1:])


def test_crashloop_single_kill_smoke(tmp_path):
    """The reference's tier-1 smoke configuration (4096 nodes, 12 rounds,
    a checkpoint every 4, one kill): the resumed run is bitwise the
    uninterrupted one and the ledger's kill and resume sit at the last
    checkpoint event's round."""
    p = subprocess.run(
        [sys.executable, "-m", "gossip_tpu_torch.tools.crashloop", "--n",
         "4096", "--max-rounds", "12", "--every", "4", "--kills", "1",
         "--poll-ms", "2", "--device", "cpu", "--workdir",
         str(tmp_path / "w")], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=600)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["kills"] == 1 and out["coverage"] == 1.0
    events = PT.load_ledger(out["ledger"], strict=True)
    kinds = [e["ev"] for e in events]
    assert kinds[0] == "provenance"
    assert kinds.count("kill") == kinds.count("resume") == 1
    verdict = next(e for e in events if e["ev"] == "verdict")
    assert verdict["ok"] and verdict["bitwise_equal"]
    assert np.isfinite(out["dropped"])
