"""The port's streamed executor (``gossip_tpu_torch.planner.stream``)
against the JAX package's (``gossip_tpu.planner.stream``), on the CPU.

Every streaming case shares the reference tests' forced plan
(``tests/test_planner.py::_forced_plan``: n = 512, 128 rumors, fanout 2,
the MIXED fault program, 6 rounds in segments of 3), so the reference
compiles its tile loop once.  The port's node mesh, its two slices and
its 2 x 2 hybrid mesh run in one spawn for each K = 2, 4 a session
(:func:`mesh_runs`; under xdist the first worker to need it computes it
and the others read it).  The spawned ranks import this module for
:func:`_rank_worker`, so its top level imports torch, numpy and the port
only; the JAX package comes in through fixtures, with its executable
store off.

Tolerance: bitwise everywhere — the final words, ``msgs``, the exact
``dropped`` and the coverage (n = 512: every float32 sum is exact).
"""

import dataclasses
import json
import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import si_packed as TP
from gossip_tpu_torch.models.state import init_state
from gossip_tpu_torch.ops.bitpack import pack
from gossip_tpu_torch.parallel import group as GR
from gossip_tpu_torch.planner import budget as PB
from gossip_tpu_torch.planner import stream as PS
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
KS = (2, 4)


def _mixed(cfg, salted=False):
    """tests/test_planner.py's MIXED program (or its salted twin) in
    ``cfg``'s classes."""
    if salted:
        return cfg.FaultConfig(drop_prob=0.05, seed=2, churn=cfg.ChurnConfig(
            events=((7, 1, 4), (15, 2, -1)), partitions=((1, 4, 100),),
            ramp=(0, 3, 0.0, 0.1)))
    return cfg.FaultConfig(drop_prob=0.05, seed=2, churn=cfg.ChurnConfig(
        events=((3, 1, 4), (9, 2, -1)), partitions=((1, 4, 256),),
        ramp=(0, 3, 0.0, 0.15)))


def _forced_plan(B, cfg, n=512, rumors=128, tiles=2, max_rounds=6, seed=0,
                 salted=False, devices=1, chips=None, slices=1):
    """The reference tests' forced plan in package ``B`` (its budget
    module) with ``cfg``'s fault classes; ``chips``/``slices`` re-plan it
    over a mesh with the same per-device budget."""
    fault = _mixed(cfg, salted)
    dev = B.forced_device_for_tiles(
        n, rumors=rumors, fanout=2, max_rounds=max_rounds, fault=fault,
        tiles_at_least=tiles, devices=devices, host_ram_bytes=1 << 30)
    if chips is not None:
        dev = B.DeviceSpec(chips=chips, slices=slices,
                           hbm_bytes_per_chip=dev.hbm_bytes_per_chip,
                           host_ram_bytes=dev.host_ram_bytes)
    return B.plan_scale(n, rumors=rumors, device=dev, fanout=2,
                        max_rounds=max_rounds, fault=fault, segment_every=3,
                        seed=seed)


def _plan(**kw):
    return _forced_plan(PB, TC, **kw)


def _same(a, b):
    """Two results (or ``(state, msgs, dropped)`` triples) bitwise."""
    fa, fb = (x.final_state if hasattr(x, "final_state") else x[0]
              for x in (a, b))
    ma, mb = ((x.msgs, x.dropped) if hasattr(x, "msgs") else tuple(x[1:])
              for x in (a, b))
    return np.array_equal(fa, fb) and ma == mb


@pytest.fixture(scope="module")
def ref():
    """The JAX package's planner, with its executable store off for this
    module's tests (restored after them)."""
    from gossip_tpu import config as JC
    from gossip_tpu.planner import budget as JB
    from gossip_tpu.planner import stream as JS
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOSSIP_COMPILE_CACHE", "")
        yield types.SimpleNamespace(
            C=JC, B=JB, S=JS, plan=lambda **kw: _forced_plan(JB, JC, **kw))


@pytest.fixture(scope="module")
def ref_runs(ref):
    """The reference's straight runs and untiled runs at 2 and 4 tiles."""
    out = {}
    for tiles in (2, 4):
        plan = ref.plan(tiles=tiles)
        out[tiles] = (ref.S.run_at_scale(plan, keep_state=True),
                      ref.S.untiled_reference(plan))
    return out


# ------------------------------------------------------------- one device


def test_host_init_matches_both_packages(ref):
    for n, r, o in ((64, 40, 3), (17, 5, 0), (128, 64, 7), (512, 128, 0)):
        mine = PS.host_init_packed(n, r, o)
        assert np.array_equal(mine, ref.S.host_init_packed(n, r, o))
        st = init_state(TC.RunConfig(seed=0, origin=o),
                        TC.ProtocolConfig(mode="pull", rumors=r), n, CPU)
        assert np.array_equal(mine, pack(st.seen).numpy().view(np.uint32))
        # a row window of it, as a node mesh's rank builds its rows
        assert np.array_equal(PS._init_rows(n, r, o, 5, 9), mine[5:14])


@pytest.mark.parametrize("chunks", [2, 7, 16])
@pytest.mark.parametrize("fault", ["mixed", "deaths", None])
def test_chunked_round_is_the_round(chunks, fault):
    """The tile step's node chunks are the one-chunk round bitwise:
    state, msgs and the nemesis's lost, round after round."""
    n = 301
    f = {"mixed": _mixed(TC),
         "deaths": TC.FaultConfig(node_death_rate=0.2, drop_prob=0.1,
                                  seed=3),
         None: None}[fault]
    proto = TC.ProtocolConfig(mode="pull", fanout=2, rumors=40)
    one = TP.make_packed_round(proto, G.complete(n), f, 0, device=CPU)
    many = TP.make_packed_round(proto, G.complete(n), f, 0, device=CPU,
                                chunks=chunks)
    a = b = TP.init_packed_state(TC.RunConfig(seed=4), proto, n, CPU)
    for _ in range(6):
        a, b = one(a), many(b)
        if fault == "mixed":
            (a, la), (b, lb) = a, b
            assert float(la) == float(lb)
        assert torch.equal(a.seen, b.seen)
        assert float(a.msgs) == float(b.msgs)
    with pytest.raises(ValueError, match="chunks"):
        TP.make_packed_round(TC.ProtocolConfig(mode="antientropy"),
                             G.complete(n), chunks=2, device=CPU)


@pytest.mark.parametrize("tiles", [2, 4])
def test_streamed_bitwise_vs_reference(tiles, ref, ref_runs):
    """THE gate: the port's T-tile streamed trajectory — final words,
    msgs, the exact dropped and the coverage — is bitwise the reference's
    streamed run and its untiled run, and its own untiled run, under the
    mixed program."""
    plan = _plan(tiles=tiles)
    assert plan.tiles == tiles
    assert plan.to_json() == ref.plan(tiles=tiles).to_json()
    res = PS.run_at_scale(plan, check_bitwise=True, keep_state=True,
                          device="cpu")
    jres, juntiled = ref_runs[tiles]
    assert res.bitwise_equal is True and res.dropped > 0
    assert res.rounds == plan.max_rounds == jres.rounds
    assert _same(res, jres) and _same(res, juntiled)
    assert res.coverage == jres.coverage
    assert _same(res, PS.untiled_reference(plan, device="cpu"))
    assert res.measured_loop_bytes is None      # the CPU reports no peak
    mine = res.to_dict()
    theirs = jres.to_dict()
    for d in (mine, theirs):
        d.pop("overlap_efficiency")
        d.pop("bitwise_equal")
    assert mine == theirs


def test_overlap_bitwise_vs_serial_and_walls():
    """The pipelined run is bitwise the serial --no-overlap leg; its
    stats carry every tile's four walls, one record a tile a segment,
    and the segments' walls."""
    plan = _plan(tiles=4)
    stats = []
    piped = PS.run_at_scale(plan, keep_state=True, device="cpu",
                            stats=stats)
    serial = PS.run_at_scale(plan, overlap=False, keep_state=True,
                             device="cpu")
    assert piped.overlap and not serial.overlap
    assert _same(piped, serial)
    assert 0.0 <= piped.overlap_efficiency <= 1.0
    tiles = [s for s in stats if s["event"] == "tile_stream"]
    assert len(tiles) == plan.tiles * plan.segment_count
    assert {s["tile"] for s in tiles} == set(range(plan.tiles))
    for s in tiles:
        for k in ("put_ms", "dispatch_ms", "wait_ms", "copy_ms"):
            assert s[k] >= 0.0, s
    segs = [s for s in stats if s["event"] == "scale_segment"]
    assert [s["round"] for s in segs] == [3, 6]
    assert stats[-1]["event"] == "scale_run"


def test_resume_bitwise_and_refusals_in_the_references_words(tmp_path, ref):
    plan = _plan()
    straight = PS.run_at_scale(plan, keep_state=True, device="cpu")
    ck = str(tmp_path / "scale_ck.npz")
    stats = []
    r1 = PS.run_at_scale(plan, checkpoint_path=ck, halt_after_segments=1,
                         device="cpu", stats=stats)
    assert r1.halted and r1.rounds == plan.segment_every
    seg = [s for s in stats if s["event"] == "scale_segment"][0]
    assert seg["bytes"] == os.path.getsize(ck) and seg["save_ms"] >= 0
    stats = []
    r2 = PS.run_at_scale(plan, checkpoint_path=ck, resume=True,
                         keep_state=True, device="cpu", stats=stats)
    assert r2.resumed and r2.rounds == plan.max_rounds
    assert _same(r2, straight) and r2.coverage == straight.coverage
    assert [s["event"] for s in stats][0] == "load"

    def refusals(S, plan_other, plan_same):
        out = []
        for p in (plan_other, plan_same):
            kw = {"device": "cpu"} if S is PS else {}
            with pytest.raises(ValueError) as ei:
                S.run_at_scale(p, checkpoint_path=ck, resume=True, **kw)
            out.append(str(ei.value))
        return out

    # a different plan's checkpoint, then a foreign fault program
    from gossip_tpu_torch.models.state import SimState
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.utils.checkpoint import save_state
    PS.run_at_scale(plan, checkpoint_path=ck, halt_after_segments=1,
                    device="cpu")
    save_state(str(tmp_path / "foreign.npz"), SimState(
        seen=torch.from_numpy(straight.final_state.view(np.int32)),
        round=3, key=threefry.key(0), msgs=torch.tensor(np.float32(0))),
        extra_meta={"round": 3,
                    "scale_plan": PB.plan_fingerprint(plan.to_dict()),
                    "fault_program": "not-the-real-digest"})
    mine, theirs = [], []
    for p, jp, path in ((_plan(seed=9), ref.plan(seed=9), ck),
                        (plan, ref.plan(), str(tmp_path / "foreign.npz"))):
        with pytest.raises(ValueError) as ei:
            PS.run_at_scale(p, checkpoint_path=path, resume=True,
                            device="cpu")
        mine.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            ref.S.run_at_scale(jp, checkpoint_path=path, resume=True)
        theirs.append(str(ei.value))
    assert mine == theirs
    assert "different scale plan" in mine[0] and "fault program" in mine[1]


def test_checkpoints_cross_between_the_packages(tmp_path, ref, ref_runs):
    """A scale checkpoint written by either package resumes in the other,
    bitwise the straight run (the plan documents, and so their
    fingerprints, agree)."""
    plan, jplan = _plan(), ref.plan()
    jstraight = ref_runs[2][0]
    a = str(tmp_path / "by_ref.npz")
    ref.S.run_at_scale(jplan, checkpoint_path=a, halt_after_segments=1)
    mine = PS.run_at_scale(plan, checkpoint_path=a, resume=True,
                           keep_state=True, device="cpu")
    assert mine.resumed and _same(mine, jstraight)
    b = str(tmp_path / "by_port.npz")
    PS.run_at_scale(plan, checkpoint_path=b, halt_after_segments=1,
                    device="cpu")
    theirs = ref.S.run_at_scale(jplan, checkpoint_path=b, resume=True,
                                keep_state=True)
    assert theirs.resumed and _same(theirs, jstraight)


def test_stream_refusals():
    plan = _plan()
    with pytest.raises(ValueError, match="packed engine only"):
        PS.run_at_scale(dataclasses.replace(plan, engine="dense"),
                        device="cpu")
    with pytest.raises(ValueError, match="PULL rounds only"):
        PS.run_at_scale(dataclasses.replace(plan, mode="antientropy"),
                        device="cpu")
    # more slices than the world has: refused before any rank starts
    with pytest.raises(ValueError, match="devices"):
        PS.run_at_scale(dataclasses.replace(plan, dcn_slices=999),
                        device="cpu")
    # a caller's group that disagrees with the plan's slicing
    with GR.local("cpu") as one:
        with pytest.raises(ValueError, match="hybrid"):
            PS.run_at_scale(dataclasses.replace(plan, dcn_slices=2),
                            group=one)
    with pytest.raises(ValueError, match="checkpoint_path"):
        PS.run_at_scale(plan, resume=True, device="cpu")


def test_no_card_raises():
    """Without a card and without device='cpu' the run raises: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA device"):
        PS.run_at_scale(_plan())
    with pytest.raises(ValueError, match="CUDA device"):
        PS.untiled_reference(_plan())


def test_step_reuse_across_tiles_and_a_salted_reentry(monkeypatch, ref):
    """One tile step serves every tile and segment, and a salted plan
    (another program of the same shapes, another seed) builds none: its
    tables are copied into the cached step's, and its trajectory is the
    reference's salted run and a fresh step's."""
    builds = []
    real = PS.make_packed_round
    monkeypatch.setattr(PS, "make_packed_round",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    PS.run_at_scale(_plan(seed=3), device="cpu")
    assert len(builds) <= 1
    before = len(builds)
    salted = PS.run_at_scale(_plan(seed=4, salted=True), keep_state=True,
                             device="cpu")
    assert len(builds) == before and salted.tiles == 2
    jsalted = ref.S.run_at_scale(ref.plan(seed=4, salted=True),
                                 keep_state=True)
    assert _same(salted, jsalted)
    monkeypatch.setattr(PS, "_STEP_CACHE", {})
    fresh = PS.run_at_scale(_plan(seed=4, salted=True), keep_state=True,
                            device="cpu")
    assert len(builds) == before + 1 and _same(fresh, salted)


# ---------------------------------------------------------------- ranks


def _mesh_cases(k):
    """(name, plan, kind) of the spawn with ``k`` ranks."""
    cases = [(f"mesh{k}", _plan(devices=k), "straight")]
    if k == 2:
        two = _plan(tiles=4, chips=2, slices=2)
        cases += [("slices2", two, "straight"),
                  ("slices2-resume", two, "resume")]
    else:
        cases += [("hybrid2x2", _plan(tiles=4, devices=2, chips=4,
                                      slices=2), "straight")]
    return cases


def _rank_worker(cases, tmp, group):
    """One rank's share of every case (runs in the spawned ranks)."""
    out = {}
    for name, plan, kind in cases:
        if kind == "straight":
            out[name] = PS.run_at_scale(plan, group=group, keep_state=True,
                                        check_bitwise=True)
        else:
            ck = os.path.join(tmp, f"{name}.npz")
            first = PS.run_at_scale(plan, group=group, checkpoint_path=ck,
                                    halt_after_segments=1)
            out[name] = (first, PS.run_at_scale(
                plan, group=group, checkpoint_path=ck, resume=True,
                keep_state=True))
    return out


@pytest.fixture(scope="session")
def mesh_runs(tmp_path_factory):
    """``{K: [rank results]}`` for every case, one spawn for each K, once
    a session (shared through a file by the xdist workers of one run)."""
    from filelock import FileLock
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    path = root / f"torch_scale_stream_{uid or 'solo'}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        tmp = str(root / f"torch_scale_stream_ck_{uid or 'solo'}")
        os.makedirs(tmp, exist_ok=True)
        with ThreadPoolExecutor(len(KS)) as pool:
            spawns = {k: pool.submit(GR.launch, _rank_worker, k,
                                     _mesh_cases(k), tmp, device="cpu")
                      for k in KS}
            runs = {k: f.result() for k, f in spawns.items()}
        path.write_bytes(pickle.dumps(runs))
    return runs


def _single(plan):
    return PS.run_at_scale(plan, keep_state=True, device="cpu")


@pytest.mark.parametrize("k", KS)
def test_node_mesh_bitwise_the_single_device_run(k, mesh_runs, ref_runs):
    """K ranks each stream their node rows of every tile; rank 0 reports
    the gathered state, bitwise the single-device port run and the
    reference's, and every rank's verdict against its rows' untiled run
    holds."""
    plan = _plan(devices=k)
    assert plan.per_slice == k and plan.tiles == 2
    ranks = [r[f"mesh{k}"] for r in mesh_runs[k]]
    res = ranks[0]
    assert res.bitwise_equal is True and res.dropped > 0
    assert _same(res, ref_runs[2][0]) and _same(res, _single(_plan()))
    assert res.coverage == ref_runs[2][0].coverage
    assert all(r.final_state is None for r in ranks[1:])
    assert all((r.msgs, r.dropped, r.coverage, r.bitwise_equal)
               == (res.msgs, res.dropped, res.coverage, True)
               for r in ranks)


def test_two_slices_bitwise_the_single_slice_run(mesh_runs, ref_runs):
    """Two slices stream alternate tiles, exchange their columns before
    each publish, and end bitwise the single-slice run."""
    plan = _plan(tiles=4, chips=2, slices=2)
    assert plan.mesh_kind == "hybrid" and plan.dcn_slices == 2
    assert plan.tiles == 4 and plan.per_slice == 1
    res = mesh_runs[2][0]["slices2"]
    assert res.dcn_slices == 2 and res.bitwise_equal is True
    assert _same(res, ref_runs[4][0]) and _same(res, _single(_plan(tiles=4)))
    assert mesh_runs[2][1]["slices2"].final_state is None


def test_two_slice_resume_bitwise(mesh_runs, ref_runs):
    first, resumed = mesh_runs[2][0]["slices2-resume"]
    assert first.halted and first.rounds == 3
    assert resumed.resumed and resumed.rounds == 6
    assert _same(resumed, ref_runs[4][0])


def test_hybrid_two_by_two_bitwise(mesh_runs, ref_runs):
    """Two slices of a two-rank node mesh each: every rank holds its rows
    of its slice's tiles."""
    res = mesh_runs[4][0]["hybrid2x2"]
    assert res.dcn_slices == 2 and res.bitwise_equal is True
    assert _same(res, ref_runs[4][0])


# ------------------------------------------------------------------ CLI


def _cli(main, argv, capsys):
    rc = main(argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


def _line(out):
    d = json.loads(out)
    d.pop("overlap_efficiency")
    return d


def test_cli_scale_run_and_run_plan_against_the_reference(tmp_path, capsys,
                                                          ref):
    """``scale-run`` and ``run --plan`` print the JAX command's line
    (its plan fingerprint among it; the overlap efficiency is a wall
    clock's) and share its refusals, stderr and exit codes."""
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli as tcli
    pf = str(tmp_path / "plan.json")
    with open(pf, "w") as f:
        f.write(_plan().to_json())
    lines = {}
    for tag, main, dev in (("port", tcli.main, ["--device", "cpu"]),
                           ("ref", jcli.main, [])):
        ck = str(tmp_path / f"{tag}.npz")
        rc, out, err = _cli(main, ["scale-run", "--plan", pf, "--checkpoint",
                                   ck, "--check-bitwise", *dev], capsys)
        assert rc == 0 and err == "", err
        straight = _line(out)
        assert straight["bitwise_equal"] is True and straight["tiles"] == 2
        rc, out, _ = _cli(main, ["run", "--plan", pf, "--checkpoint", ck,
                                 "--resume", *dev], capsys)
        assert rc == 0
        lines[tag] = (straight, _line(out))
    assert lines["port"] == lines["ref"]
    assert lines["port"][1]["resumed"] is True
    rc, out, _ = _cli(tcli.main, ["scale-run", "--plan", pf, "--no-overlap",
                                  "--device", "cpu"], capsys)
    assert rc == 0 and json.loads(out)["overlap"] is False
    # the guard: flags the plan path would discard are refused, derived
    # from the parser's defaults
    for argv in (["--curve"], ["--n", "9999", "--drop", "0.5"],
                 ["--swim-subjects", "16"], ["--resume"]):
        got = _cli(tcli.main, ["run", "--plan", pf, *argv, "--device",
                               "cpu"], capsys)
        want = _cli(jcli.main, ["run", "--plan", pf, *argv], capsys)
        assert got == want, argv
        assert got[0] == 2
    # another plan file, and a missing one
    for bad in (str(tmp_path / "missing.json"),):
        got = _cli(tcli.main, ["scale-run", "--plan", bad, "--device",
                               "cpu"], capsys)
        want = _cli(jcli.main, ["scale-run", "--plan", bad], capsys)
        assert got == want and got[0] == 2


def test_cli_without_a_card_refuses(tmp_path, capsys):
    from gossip_tpu_torch import cli as tcli
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pf = str(tmp_path / "plan.json")
    with open(pf, "w") as f:
        f.write(_plan().to_json())
    for argv in (["scale-run", "--plan", pf], ["run", "--plan", pf]):
        rc, out, err = _cli(tcli.main, argv, capsys)
        assert rc == 2 and out == "" and "CUDA device" in err
