"""``sweep``, ``run --backend go-native`` and ``run --parity-check``
through the port's command line against the JAX package's, on the CPU.

Every deterministic field of every line must be equal (exact
equality); only the wall clocks (``wall_s``, ``row_wall_s``,
``row_overhead_s``, ``meta.*_s`` other than the simulated
``sim_time_s``), the package's ``backend`` name (``torch-cpu`` against
``jax-tpu``), ``compile_cache`` (a directory of each package) and the
port's added ``meta`` keys are left out.  ``--devices 4`` runs the
reference on four XLA host devices and the port on four gloo ranks.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from gossip_tpu_torch.ops import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALLS = ("wall_s", "row_wall_s", "row_overhead_s", "compile_cache")


@pytest.fixture(autouse=True)
def _stores(tmp_path_factory, monkeypatch):
    """The reference runs with its executable store off; the port's
    event core is built into a directory of this session."""
    monkeypatch.setitem(_kernels._STORE, "dir", None)
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    yield tmp_path_factory.getbasetemp() / "native_build"


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    assert rc == 0, argv
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def _port(argv, build):
    from gossip_tpu_torch import cli
    return _lines(cli.main, [*argv, "--device", "cpu", "--compile-cache",
                             str(build)])


def _jax(argv):
    """The reference's command in this process, whose JAX has the test
    session's host devices: its ``sweep`` takes ``--devices 1`` (its
    default in a process of one device, and the port's on the CPU)."""
    from gossip_tpu import cli as jcli
    if argv[0] == "sweep" and "--devices" not in argv:
        argv = [*argv, "--devices", "1"]
    return _lines(jcli.main, [*argv, "--no-compile-cache"])


def _report(rep: dict, ref: dict) -> dict:
    """``rep`` on the reference's keys, walls and the backend's name
    left out; its ``meta`` on the reference's deterministic keys."""
    out = {k: v for k, v in rep.items()
           if k in ref and k not in WALLS and k not in ("backend", "meta")}
    if "meta" in ref:
        out["meta"] = {k: rep["meta"].get(k, "missing")
                       for k in ref["meta"]
                       if not k.endswith("_s") or k == "sim_time_s"}
    for key in ("gonative_ref", "jax", "gonative"):
        if key in ref:
            out[key] = _report(rep[key], ref[key])
            if ref[key]["backend"] == "go-native":
                out[key]["backend"] = rep[key]["backend"]
    return out


def _same(port_lines, jax_lines):
    assert len(port_lines) == len(jax_lines)
    for got, want in zip(port_lines, jax_lines):
        assert _report(got, want) == _report(want, want), want.get("config")


def test_sweep_rows_are_the_references(_stores):
    """The five BASELINE rows at scale 0.002, row 1's go-native reference
    run included; row 5 takes the xla engine on the CPU, as the
    reference's ``auto`` does off its TPU."""
    argv = ["sweep", "--scale", "0.002"]
    port, jax = _port(argv, _stores), _jax(argv)
    _same(port, jax)
    assert [r["config"] for r in port] == [
        "push-complete-64-goref", "pushpull-er-10k", "antientropy-ws-100k",
        "swim-powerlaw-1m", "multirumor-10m-sharded"]
    assert port[0]["gonative_ref"]["meta"]["engine"] == "NativeGoSim"
    assert port[4]["config_revision"] == 2
    assert port[4]["meta"]["engine"] == "bit-packed"
    for row in port:
        assert row["row_wall_s"] >= row["wall_s"] >= 0
        assert row["row_overhead_s"] >= 0


def test_sweep_only_with_swim_diss_and_curve(_stores):
    argv = ["sweep", "--scale", "0.002", "--only", "swim-powerlaw-1m",
            "push-complete-64-goref", "--swim-diss", "pack", "--curve"]
    port, jax = _port(argv, _stores), _jax(argv)
    _same(port, jax)
    assert len(port) == 2 and port[1]["curve"]
    assert port[0]["gonative_ref"]["curve"] == jax[0]["gonative_ref"]["curve"]


def test_sweep_devices_4_runs_row_5_on_four_ranks(_stores):
    argv = ["sweep", "--scale", "0.002", "--only", "multirumor-10m-sharded",
            "--devices", "4"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-m", "gossip_tpu", *argv,
                           "--no-compile-cache"], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax = [json.loads(ln) for ln in proc.stdout.splitlines()]
    port = _port(argv, _stores)
    _same(port, jax)
    assert port[0]["meta"]["devices"] == 4
    assert port[0]["meta"]["process_group"] == "gloo"


def test_run_go_native_is_the_references(_stores):
    argv = ["run", "--backend", "go-native", "--mode", "flood", "--family",
            "grid", "--n", "1024", "--curve"]
    port, jax = _port(argv, _stores), _jax(argv)
    _same(port, jax)
    assert port[0]["backend"] == "go-native" and port[0]["curve"]


@pytest.mark.parametrize("graph", [
    ["--family", "ring", "--k", "2", "--n", "512", "--max-rounds", "300"],
    ["--family", "watts_strogatz", "--k", "4", "--p", "0.1", "--n", "2000"],
], ids=["ring_k2", "ws2000"])
def test_parity_check_is_the_references(graph, _stores):
    """The flood rounds against the event core: on a race-free ring the
    curves meet exactly; on a small-world graph the hop bound and the
    fixed point hold, with the reference's numbers."""
    argv = ["run", "--mode", "flood", "--parity-check", *graph]
    port, jax = _port(argv, _stores), _jax(argv)
    _same(port, jax)
    out = port[0]
    assert out["jax"]["curve"] is None and out["gonative"]["curve"] is None
    if "ring" in graph:
        assert out["curve_gap"] == 0.0
    assert out["hop_bound_violation"] == jax[0]["hop_bound_violation"]
    assert out["fixed_point_gap"] == 0.0


@pytest.mark.parametrize("argv", [
    ["run", "--mode", "pull", "--parity-check"],
    ["run", "--mode", "flood", "--parity-check", "--curve"],
    ["run", "--mode", "flood", "--parity-check", "--ensemble", "2"],
    ["run", "--mode", "flood", "--parity-check", "--drop", "0.1"],
    ["run", "--mode", "flood", "--family", "ring", "--parity-check",
     "--max-rounds", "3"],
    ["run", "--backend", "go-native", "--mode", "flood", "--ensemble", "2"],
    ["run", "--backend", "go-native", "--mode", "flood", "--checkpoint",
     "x.npz"],
    ["run", "--mode", "pull", "--n", "1000", "--engine", "native"],
], ids=["pull", "curve", "ensemble", "fault", "cut_short", "gn_ensemble",
        "gn_checkpoint", "native_on_jax_tpu"])
def test_run_refusals_are_the_references(argv, capsys, _stores):
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli
    assert cli.main([*argv, "--device", "cpu"]) == 2
    got = capsys.readouterr()
    assert jcli.main([*argv, "--no-compile-cache"]) == 2
    want = capsys.readouterr()
    assert got.err == want.err and not got.out
