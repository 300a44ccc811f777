"""The port's budget model (``gossip_tpu_torch.planner.budget``) against
the JAX package's (``gossip_tpu.planner.budget``), and the ``plan``
command against the JAX command.

The model is pure host arithmetic, so every pin here is exact: the plan
documents, their JSON and their fingerprints are the reference's byte
for byte for the packed and dense engines; the fused engine's document
adds the port's ``lane_major_pingpong`` term (ROADMAP queue 3), pinned
below; the defaults of a ``DeviceSpec`` are the card's.
"""

import ast
import json
import os
from pathlib import Path

import pytest

from gossip_tpu import config as JC
from gossip_tpu.planner import budget as JB
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.bitpack import n_words
from gossip_tpu_torch.planner import budget as PB

REPO = Path(__file__).resolve().parent.parent


def _mixed(cfg):
    """tests/test_planner.py's MIXED program in ``cfg``'s classes."""
    return cfg.FaultConfig(drop_prob=0.05, seed=2, churn=cfg.ChurnConfig(
        events=((3, 1, 4), (9, 2, -1)), partitions=((1, 4, 256),),
        ramp=(0, 3, 0.0, 0.15)))


MIXED = _mixed(TC)


def _forced_plan(B, cfg, n=512, rumors=128, tiles=2, max_rounds=6, seed=0,
                 devices=1):
    fault = _mixed(cfg)
    dev = B.forced_device_for_tiles(
        n, rumors=rumors, fanout=2, max_rounds=max_rounds, fault=fault,
        tiles_at_least=tiles, devices=devices, host_ram_bytes=1 << 30)
    return B.plan_scale(n, rumors=rumors, device=dev, fanout=2,
                        max_rounds=max_rounds, fault=fault, segment_every=3,
                        seed=seed)


# ------------------------------------------------------------- algebra


def test_arithmetic_twins_cannot_drift():
    """budget.py keeps its own word count and canonical horizon; they
    equal the port's ops/bitpack and ops/nemesis."""
    for r in (1, 31, 32, 33, 64, 255, 256, 1000):
        assert PB.n_words(r) == n_words(r)
    for ch in (TC.ChurnConfig(events=((0, 1, 2),)),
               TC.ChurnConfig(partitions=((0, 40, 8),)),
               TC.ChurnConfig(ramp=(0, 100, 0.0, 0.5)),
               MIXED.churn):
        f = TC.FaultConfig(churn=ch)
        assert PB.sched_t_pad(f) == NE.canonical_horizon(ch), ch
    assert PB.sched_t_pad(None) == NE.SCHED_T_MIN == PB.SCHED_T_MIN
    # and the module is pure arithmetic: no torch, no jax, no gossip_tpu
    src = REPO / "gossip_tpu_torch" / "planner" / "budget.py"
    for node in ast.walk(ast.parse(src.read_text())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "torch",
                                              "gossip_tpu"), name


def test_device_spec_defaults_are_the_cards():
    """The defaults are one H100's memory and its machine's host RAM,
    not the reference's TPU chip and 64 GiB host."""
    spec = PB.DeviceSpec()
    assert spec.hbm_bytes_per_chip == PB.H100_HBM_BYTES
    assert spec.host_ram_bytes == PB.HOST_RAM_BYTES
    assert PB.H100_HBM_BYTES > 80 * 10**9
    assert JB.DeviceSpec().hbm_bytes_per_chip == 16 * 1024**3
    forced = PB.forced_device_for_tiles(512, rumors=128, fanout=2,
                                        max_rounds=6, fault=None,
                                        tiles_at_least=2)
    assert forced.host_ram_bytes == PB.HOST_RAM_BYTES


@pytest.mark.parametrize("engine", PB.ENGINES)
def test_budget_monotone_in_n(engine):
    last = 0
    for n in (1000, 4096, 10**5, 10**6, 10**7, 10**8):
        p = sum(PB.engine_components(
            engine, n=n, rumors=64, fanout=2, tile_words=1, devices=4,
            fault=MIXED, max_rounds=64).values())
        assert p >= last, (engine, n)
        last = p


def test_bucket_stability_and_determinism():
    dev = PB.DeviceSpec(chips=1, hbm_bytes_per_chip=64 * 1024**2,
                        host_ram_bytes=1 << 34)
    last_bucket = None
    for n in (10**4, 10**5, 3 * 10**5, 10**6):
        plan = PB.plan_scale(n, rumors=256, device=dev, fanout=1,
                             max_rounds=32)
        assert (plan.bucket_words & (plan.bucket_words - 1)) == 0
        assert plan.tiles * plan.bucket_words >= plan.total_words
        if last_bucket is not None:
            assert plan.bucket_words <= last_bucket, n
        last_bucket = plan.bucket_words
        again = PB.plan_scale(n, rumors=256, device=dev, fanout=1,
                              max_rounds=32)
        assert again.to_dict() == plan.to_dict()


def _refusal(B, fn):
    with pytest.raises(ValueError) as ei:
        fn(B)
    return ei.value


@pytest.mark.parametrize("case", [
    "hbm", "host", "node_ids", "mode", "engine", "fanout", "rumors",
    "rounds", "reserve", "n"])
def test_refusals_name_the_binding_constraint(case):
    """Each refusal is the reference's: its type, message and binding."""
    calls = {
        "hbm": lambda B: B.plan_scale(
            10**8, rumors=64, device=B.DeviceSpec(
                chips=1, hbm_bytes_per_chip=10**6, host_ram_bytes=1 << 40),
            fanout=2, max_rounds=64),
        "host": lambda B: B.plan_scale(
            10**8, rumors=1024, device=B.DeviceSpec(
                chips=256, hbm_bytes_per_chip=1 << 34,
                host_ram_bytes=10**9)),
        "node_ids": lambda B: B.plan_scale(2**31, device=B.DeviceSpec(
            hbm_bytes_per_chip=1 << 34, host_ram_bytes=1 << 36)),
        "mode": lambda B: B.plan_scale(1000, mode="antientropy"),
        "engine": lambda B: B.plan_scale(1000, engine="warp"),
        "fanout": lambda B: B.plan_scale(1000, fanout=0),
        "rumors": lambda B: B.plan_scale(1000, rumors=0),
        "rounds": lambda B: B.plan_scale(1000, max_rounds=0),
        "reserve": lambda B: B.plan_scale(1000, reserve_frac=1.0),
        "n": lambda B: B.plan_scale(0),
    }[case]
    got, want = _refusal(PB, calls), _refusal(JB, calls)
    assert str(got) == str(want)
    assert (type(got).__name__, getattr(got, "binding", None)) == \
        (type(want).__name__, getattr(want, "binding", None))
    if case == "hbm":
        assert got.binding in str(got) and "1-word tile" in str(got)
        assert got.binding in PB.engine_components(
            "packed", n=10**8, rumors=64, fanout=2, tile_words=1,
            devices=1, fault=None, max_rounds=64)
    if case == "host":
        assert got.binding == "host_state" and "host RAM" in str(got)


def test_device_spec_refusals_are_the_references():
    for kw in (dict(chips=0), dict(slices=0), dict(chips=3, slices=2),
               dict(hbm_bytes_per_chip=0)):
        with pytest.raises(ValueError) as mine:
            PB.DeviceSpec(**kw)
        with pytest.raises(ValueError) as ref:
            JB.DeviceSpec(**kw)
        assert str(mine.value) == str(ref.value)


def test_plan_json_round_trip_and_validation():
    plan = _forced_plan(PB, TC)
    doc = json.loads(plan.to_json())
    again = PB.plan_from_dict(doc)
    assert again.to_dict() == plan.to_dict()
    assert again.fault == plan.fault      # churn tuples survive JSON
    edits = [
        (lambda d: d["tiling"].__setitem__("bucket_words", 3),
         "power of two", PB.validate_plan),
        (lambda d: d.pop("segments"), "segments", PB.validate_plan),
        (lambda d: d.__setitem__("version", 99), "version",
         PB.validate_plan),
        (lambda d: d["tiling"].__setitem__("tiles", plan.tiles * 2),
         "tiling", PB.plan_from_dict),
        (lambda d: d["budget"].pop("reserve_frac"), "reserve_frac",
         PB.plan_from_dict),
        (lambda d: d["device"].__setitem__("warp_drives", 1), "device",
         PB.plan_from_dict),
    ] + [(lambda d, s=sec: d.__setitem__(s, 7), sec, PB.validate_plan)
         for sec in ("target", "tiling", "segments", "budget", "device")]
    jdoc = json.loads(_forced_plan(JB, JC).to_json())
    assert jdoc == doc
    for edit, word, fn in edits:
        bad = json.loads(plan.to_json())
        edit(bad)
        with pytest.raises(ValueError, match=word) as mine:
            fn(bad)
        jbad = json.loads(plan.to_json())
        edit(jbad)
        with pytest.raises(ValueError) as ref:
            getattr(JB, fn.__name__)(jbad)
        assert str(mine.value) == str(ref.value)
    # fingerprints: content-sensitive, order-insensitive, the reference's
    fp = PB.plan_fingerprint(doc)
    assert fp == PB.plan_fingerprint(json.loads(plan.to_json()))
    assert fp == JB.plan_fingerprint(jdoc)
    assert fp != PB.plan_fingerprint(_forced_plan(PB, TC, seed=1).to_dict())


def test_forced_device_verifies_the_tile_count():
    for tiles in (2, 4):
        dev = PB.forced_device_for_tiles(
            512, rumors=128, fanout=2, max_rounds=6, fault=MIXED,
            tiles_at_least=tiles)
        plan = PB.plan_scale(512, rumors=128, device=dev, fanout=2,
                             max_rounds=6, fault=MIXED)
        assert plan.tiles >= tiles
        ref = JB.forced_device_for_tiles(
            512, rumors=128, fanout=2, max_rounds=6, fault=_mixed(JC),
            tiles_at_least=tiles, host_ram_bytes=PB.HOST_RAM_BYTES)
        assert ref.hbm_bytes_per_chip == dev.hbm_bytes_per_chip
    with pytest.raises(ValueError, match="cannot force"):
        PB.forced_device_for_tiles(4, rumors=256, fanout=1, max_rounds=4,
                                   fault=None, tiles_at_least=4)
    with pytest.raises(ValueError, match="word"):
        PB.forced_device_for_tiles(512, rumors=32, fanout=1, max_rounds=4,
                                   fault=None, tiles_at_least=2)


def test_crosscheck_peak_verdicts():
    ok = PB.crosscheck_peak(1000, 900, n=10, tiles=2, plan_fingerprint="f")
    assert ok["ok"] is True and ok["headroom_frac"] == 0.1
    assert ok["source"] == "torch.cuda.max_memory_allocated"
    assert PB.crosscheck_peak(1000, 1001)["ok"] is False
    null = PB.crosscheck_peak(1000, None)
    assert null["ok"] is None and null["measured_bytes"] is None
    # the reference's keys, its source aside
    assert set(ok) == {"engine", "n", "tiles", "predicted_bytes",
                       "measured_bytes", "ok", "headroom_frac", "source",
                       "plan_fingerprint"}


# ------------------------------------------- the reference, plan by plan

GRID = [
    # (n, rumors, fanout, chips, slices, hbm GiB, program, max_rounds,
    #  segment_every)
    (10**8, 64, 1, 8, 1, 16.0, None, 64, None),
    (10**8, 64, 1, 1, 1, 6.0, None, 32, 16),
    (10**8, 64, 1, 1, 1, 6.0, "mixed", 16, 8),
    (10**7, 64, 1, 2, 1, 0.4, None, 16, 8),
    (10**7, 64, 1, 2, 2, 0.6, None, 16, 8),
    (10**9, 64, 1, 1, 1, 80.0, None, 64, None),
    (4096, 256, 2, 1, 1, 0.001, "mixed", 6, 3),
    (123457, 33, 3, 4, 2, 0.01, "deaths", 20, 7),
    (5 * 10**6, 1000, 2, 8, 4, 1.0, "mixed", 100, 30),
    (2**20, 256, 1, 1, 1, 0.05, None, 12, 4),
]


def _fault(cfg, kind):
    if kind is None:
        return None
    if kind == "mixed":
        return _mixed(cfg)
    return cfg.FaultConfig(node_death_rate=0.1, drop_prob=0.02, seed=5)


@pytest.mark.parametrize("engine", PB.ENGINES)
@pytest.mark.parametrize("case", GRID, ids=[f"g{i}" for i in
                                            range(len(GRID))])
def test_plans_are_the_references(case, engine):
    """The port's plan document is the reference's, byte for byte, with
    explicit device flags (the defaults are the card's); the fused
    engine's adds the port's ``lane_major_pingpong`` term, a second plane
    stack (ROADMAP queue 3), and is otherwise the reference's."""
    n, rumors, fanout, chips, slices, hbm, kind, rounds, every = case
    out = []
    for B, cfg in ((PB, TC), (JB, JC)):
        dev = B.DeviceSpec(chips=chips, slices=slices,
                           hbm_bytes_per_chip=int(hbm * 1024**3),
                           host_ram_bytes=64 * 1024**3)
        try:
            plan = B.plan_scale(n, rumors=rumors, device=dev, fanout=fanout,
                                max_rounds=rounds, engine=engine,
                                fault=_fault(cfg, kind),
                                segment_every=every)
            out.append(plan)
        except ValueError as e:
            out.append((type(e).__name__, str(e),
                        getattr(e, "binding", None)))
    mine, ref = out
    if engine != "fused":
        if isinstance(ref, tuple):
            assert mine == ref
            return
        assert mine.to_json() == ref.to_json()
        assert PB.plan_fingerprint(mine.to_dict()) == \
            JB.plan_fingerprint(ref.to_dict())
        return
    comps = PB.engine_components(
        "fused", n=n, rumors=rumors, fanout=fanout, tile_words=1,
        devices=chips // slices, fault=_fault(TC, kind), max_rounds=rounds)
    want = JB.engine_components(
        "fused", n=n, rumors=rumors, fanout=fanout, tile_words=1,
        devices=chips // slices, fault=_fault(JC, kind), max_rounds=rounds)
    extra = comps.pop("lane_major_pingpong")
    assert extra == comps["plane_stack"]
    pad, want_pad = comps.pop("alignment_pad"), want.pop("alignment_pad")
    assert comps == want
    assert pad == max(4096, (sum(comps.values()) + extra) // 64)
    assert want_pad == max(4096, sum(want.values()) // 64)


# ------------------------------------------------------------------ CLI


def _cli(main, argv, capsys):
    rc = main(argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


@pytest.fixture
def clis(monkeypatch):
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli as tcli
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")
    return jcli.main, tcli.main


def test_cli_plan_validate_and_infeasible(tmp_path, capsys, clis):
    """``plan`` against the JAX command: stdout, stderr and exit codes,
    the plan file byte for byte."""
    jmain, tmain = clis
    flags = ["--n", "4096", "--rumors", "256", "--chips", "1", "--hbm-gb",
             "0.001", "--host-ram-gb", "1", "--max-rounds", "6",
             "--segment-every", "3", "--drop", "0.05", "--scenario",
             "event=1:1:3;partition=1:3:32;ramp=0:2:0.0:0.2"]
    outs = {}
    for tag, main in (("port", tmain), ("ref", jmain)):
        path = str(tmp_path / "plan.json")
        rc, out, err = _cli(main, ["plan", *flags, "--out", path], capsys)
        assert rc == 0 and err == ""
        line = json.loads(out)
        assert line["tiles"] >= 2 and line["plan_written"] == path
        outs[tag] = (line, open(path).read())
        rc, vout, _ = _cli(main, ["plan", "--validate", path], capsys)
        assert rc == 0 and json.loads(vout)["plan_valid"]
        outs[tag + "_valid"] = vout
    assert outs["port"] == outs["ref"]
    assert outs["port_valid"] == outs["ref_valid"]
    # the document on stdout, and the refusals: one line, exit 2
    doc = json.loads(outs["port"][1])
    doc["tiling"]["tiles"] *= 2
    bad = str(tmp_path / "bad.json")
    json.dump(doc, open(bad, "w"))
    for argv in (["plan", *flags],
                 ["plan", "--n", str(10**8), "--chips", "1", "--hbm-gb",
                  "0.001"],
                 ["plan", "--validate", bad],
                 ["plan", "--validate", str(tmp_path / "missing.json")],
                 ["plan", "--n", "1000", "--scenario", "bogus=1"],
                 ["plan", "--n", "1000", "--engine", "dense", "--hbm-gb",
                  "1", "--host-ram-gb", "1"]):
        got, want = _cli(tmain, argv, capsys), _cli(jmain, argv, capsys)
        assert got == want, argv
    rc, out, err = _cli(tmain, ["plan", "--n", str(10**8), "--chips", "1",
                                "--hbm-gb", "0.001"], capsys)
    assert rc == 2 and out == "" and "binding constraint" in err


def test_cli_plan_defaults_are_the_cards(capsys, clis):
    """Without --hbm-gb and --host-ram-gb the port plans for one H100 and
    its machine; given them, its document is the reference's."""
    jmain, tmain = clis
    rc, out, _ = _cli(tmain, ["plan"], capsys)
    assert rc == 0
    doc = json.loads(out)
    assert doc["device"]["hbm_bytes_per_chip"] == PB.H100_HBM_BYTES
    assert doc["device"]["host_ram_bytes"] == PB.HOST_RAM_BYTES
    assert doc["target"]["n"] == 10**8 and doc["tiling"]["tiles"] == 1
    flags = ["plan", "--hbm-gb", "16", "--host-ram-gb", "64"]
    assert _cli(tmain, flags, capsys) == _cli(jmain, flags, capsys)
    assert os.path.basename(PB.__file__) == "budget.py"
