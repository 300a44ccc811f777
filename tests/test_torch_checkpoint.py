"""The port's checkpoints (``gossip_tpu_torch.utils.checkpoint``), its
single-device checkpointed drivers (SI, SWIM, rumor mongering) and ``run
--checkpoint/--checkpoint-every/--resume`` against the JAX package on
the CPU.

* The crash contract: every ``ValueError`` case of the reference's
  ``tests/test_crash_safety.py`` names the file, a stale ``.tmp`` is
  removed before a write and never read, a missing file stays
  ``FileNotFoundError``, and a ``base_round`` that disagrees with the
  state is refused in the reference's words.
* The format: for all four state classes the reference's ``load_state``
  reads the port's file and the port's reads the reference's, with equal
  arrays, dtypes, round, msgs and key words, and equal metadata.
* ``run_with_checkpoints`` against the reference's on the same SI step
  under ``tests/test_crash_safety.py``'s fault program, killed at round 3
  (inside the partition window, mid-ramp): the final state, the flat and
  the named curves and ``extra`` (``round``, ``dropped``, ``curve``)
  bitwise; one host read a segment.
* The drivers: resume equals the straight run, the port's straight run
  equals the reference's, and a run the reference starts and the port
  resumes equals the reference's straight run, all bitwise.  Node counts
  are ones where the reference's folded division (a product with
  ``float32(1 / n)``) and the true quotient differ by an ulp, and the
  curves are checked to meet such a count.
* The command line: both packages' ``main`` in process, the output line
  the reference's less its ``backend`` value, every refusal word for
  word, the fault-program digests; and one SIGKILL of a port child.

The reference runs with its executable store off.  Tolerance: 0
everywhere.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu import cli as JCLI
from gossip_tpu import config as JC
from gossip_tpu.models import rumor as JRU
from gossip_tpu.models import si as JSI
from gossip_tpu.models import state as JST
from gossip_tpu.models import swim as JSW
from gossip_tpu.ops import nemesis as JNE
from gossip_tpu.ops import pallas_round as JPR
from gossip_tpu.runtime import simulator as JSIM
from gossip_tpu.topology import generators as JG
from gossip_tpu.utils import checkpoint as JCK
from gossip_tpu_torch import cli as TCLI
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import rumor as TRU
from gossip_tpu_torch.models import si as TSI
from gossip_tpu_torch.models import state as TST
from gossip_tpu_torch.models import swim as TSW
from gossip_tpu_torch.ops import nemesis as TNE
from gossip_tpu_torch.ops.common import f32_fraction, f32_mean
from gossip_tpu_torch.ops.fused_round import FusedState as TFusedState
from gossip_tpu_torch.runtime import simulator as TSIM
from gossip_tpu_torch.topology import generators as TG
from gossip_tpu_torch.utils import checkpoint as TCK

from _torch_reference import config_pair, fault_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# tests/test_crash_safety.py's program: a crash that recovers, a
# permanent crash, a partition window [2, 6) and a drop ramp [1, 4)
_CHURN = dict(events=((3, 2, 5), (7, 1, -1)), partitions=((2, 6, 32),),
              ramp=(1, 4, 0.0, 0.3))
FAULTS = {
    "none": None,
    "program": dict(drop_prob=0.05, seed=1, churn=_CHURN),
    "deaths": dict(node_death_rate=0.1, drop_prob=0.05, seed=1),
}
N = 250          # the folded and the true quotient differ at 138 counts
T, HALF, EVERY = 10, 3, 3


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _faults(name):
    spec = FAULTS[name]
    return (None, None) if spec is None else fault_pair(**spec)


def _ref_fields(state) -> dict:
    """The reference state's fields as numpy, the key as its words."""
    return {k: np.asarray(jax.random.key_data(v)) if k == "base_key"
            else np.asarray(v) for k, v in state._asdict().items()}


def _assert_fields_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _rule_matters(curve, total: int):
    """Some value of ``curve`` sits at a count where the folded division
    and the true quotient give different float32 values."""
    counts = [round(v * total) for v in curve]
    assert any(f32_mean(c, total) != f32_fraction(c, total) for c in counts)


# -- the crash contract ---------------------------------------------------

def _valid(tmp_path, name="ok.npz", seed=0, extra=None):
    p = str(tmp_path / name)
    st = TST.init_state(TC.RunConfig(seed=seed),
                        TC.ProtocolConfig(mode="pushpull"), 16, CPU)
    TCK.save_state(p, st, extra_meta={"k": 1} if extra is None else extra)
    return p


def test_load_corrupt_names_file(tmp_path):
    p = _valid(tmp_path)
    raw = open(p, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    with open(trunc, "wb") as f:
        f.write(raw[:len(raw) // 3])
    for loader in (TCK.load_meta, TCK.load_state):
        with pytest.raises(ValueError, match="trunc.npz"):
            loader(trunc)
    imp = str(tmp_path / "imposter.npz")
    with open(imp, "wb") as f:
        f.write(b"not a zip archive at all")
    with pytest.raises(ValueError, match="imposter.npz"):
        TCK.load_meta(imp)
    with pytest.raises(FileNotFoundError):
        TCK.load_meta(str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError):
        TCK.load_state(str(tmp_path / "nope.npz"), device="cpu")


@pytest.mark.parametrize("case", ["foreign", "unknown-class", "torn",
                                  "incomplete", "other-key-impl"])
def test_load_refusals_name_the_file(tmp_path, case):
    """A valid npz that is no checkpoint, an unknown class, a member the
    metadata names but the archive lacks, a keyed state without its
    ``key_impl`` (its own diagnosis), and a key impl the port does not
    draw; the reference's loader raises on the first four too."""
    p = str(tmp_path / f"{case}.npz")
    key = dict(seen=np.zeros((4, 1), bool),
               base_key=np.zeros((2,), np.uint32))
    if case == "foreign":
        np.savez(p, a=np.arange(3))
    elif case == "unknown-class":
        np.savez(p, __meta__=json.dumps(
            {"cls": "NoSuchState", "fields": ["x"], "key_field": None}))
    elif case == "torn":
        np.savez(p, __meta__=json.dumps(
            {"cls": "SimState", "fields": ["seen"], "key_field": None}))
    elif case == "incomplete":
        np.savez(p, __meta__=json.dumps(
            {"cls": "SimState", "fields": ["seen", "base_key"],
             "key_field": "base_key"}), **key)
    else:
        np.savez(p, __meta__=json.dumps(
            {"cls": "SimState", "fields": ["seen", "base_key"],
             "key_field": "base_key", "key_impl": "rbg"}), **key)
    match = {"unknown-class": "NoSuchState",
             "incomplete": "incomplete"}.get(case, f"{case}.npz")
    with pytest.raises(ValueError, match=match):
        TCK.load_state(p, device="cpu")
    with pytest.raises(ValueError, match=f"{case}.npz"):
        TCK.load_state(p, device="cpu")
    if case != "other-key-impl":
        with pytest.raises(ValueError):
            JCK.load_state(p)


def test_load_mid_archive_corruption_and_stale_tmp(tmp_path):
    p = _valid(tmp_path, "midrot.npz")
    raw = bytearray(open(p, "rb").read())
    mid = len(raw) // 2
    for i in range(mid, mid + 16):
        raw[i] ^= 0xFF
    with open(p, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="midrot.npz"):
        TCK.load_state(p, device="cpu")
    p = _valid(tmp_path)
    good = TCK.load_meta(p)
    with open(p + ".tmp", "wb") as f:
        f.write(b"partial garbage from a killed writer")
    assert TCK.load_meta(p) == good
    _valid(tmp_path, seed=1, extra={"k": 2})
    assert not os.path.exists(p + ".tmp")
    assert TCK.load_meta(p)["extra"] == {"k": 2}


def test_base_round_refusal_is_the_reference(tmp_path):
    """A state whose round disagrees with ``base_round`` is refused in
    the reference's words, before any round runs."""
    jp, tp = config_pair("ProtocolConfig", mode="pushpull")
    jst = JST.init_state(JC.RunConfig(), jp, 16)._replace(
        round=jnp.int32(3))
    tst = TST.init_state(TC.RunConfig(), tp, 16, CPU)._replace(round=3)
    jstep = JSI.make_si_round(jp, JG.complete(16))
    with pytest.raises(ValueError) as want:
        JCK.run_with_checkpoints(jstep, jst, 2, str(tmp_path / "j.npz"),
                                 base_round=0)
    with pytest.raises(ValueError) as got:
        TCK.run_with_checkpoints(TSI.make_si_round(tp, TG.complete(16),
                                                   device=CPU),
                                 tst, 2, str(tmp_path / "t.npz"),
                                 base_round=0)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "t.npz")


# -- the format, both ways ------------------------------------------------

def _random_state(cls: str, rng):
    """``(reference state, port state)`` of ``cls`` from numpy values."""
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    msgs = np.float32(rng.integers(0, 10**6) + 0.25)
    rnd = int(rng.integers(0, 100))
    jkey = jax.random.wrap_key_data(jnp.asarray(key), impl="threefry2x32")
    if cls in ("SimState", "PackedSimState"):
        seen = (rng.random((37, 3)) < 0.5 if cls == "SimState"
                else rng.integers(0, 2**32, (37, 2), dtype=np.uint32))
        js = JST.SimState(jnp.asarray(seen), jnp.int32(rnd), jkey,
                          jnp.float32(msgs))
        ts = TST.state_from_numpy(seen, rnd, key, msgs, CPU)
    elif cls == "SwimState":
        wire, timer = (rng.integers(-5, 40, (37, 4), dtype=np.int32)
                       for _ in range(2))
        js = JSW.SwimState(jnp.asarray(wire), jnp.asarray(timer),
                           jnp.int32(rnd), jkey, jnp.float32(msgs))
        ts = TCK.state_from_fields("SwimState", dict(
            wire=wire, timer=timer, round=np.int32(rnd), base_key=key,
            msgs=msgs), CPU)
    elif cls == "RumorState":
        seen, hot = (rng.random((37, 3)) < 0.5 for _ in range(2))
        cnt = rng.integers(0, 4, (37, 3), dtype=np.int32)
        js = JRU.RumorState(jnp.asarray(seen), jnp.asarray(hot),
                            jnp.asarray(cnt), jnp.int32(rnd), jkey,
                            jnp.float32(msgs))
        ts = TCK.state_from_fields("RumorState", dict(
            seen=seen, hot=hot, cnt=cnt, round=np.int32(rnd),
            base_key=key, msgs=msgs), CPU)
    else:                   # the fused planes: a [W, rows, 128] stack
        table = rng.integers(0, 2**32, (4, 3, 128), dtype=np.uint32)
        js = JPR.FusedState(jnp.asarray(table), jnp.int32(rnd),
                            jnp.float32(msgs))
        ts = TFusedState(torch.from_numpy(table.view(np.int32).copy()),
                         rnd, msgs)
    return js, ts


@pytest.mark.parametrize("cls", ["SimState", "PackedSimState", "SwimState",
                                 "RumorState", "FusedState"])
def test_files_load_in_the_other_package(tmp_path, cls):
    """Each package loads the other's file: the arrays, dtypes, round,
    msgs and key words equal, and so does the metadata."""
    js, ts = _random_state(cls, np.random.default_rng(len(cls)))
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    extra = {"config": {"n": 37}, "round": 5, "dropped": 3.5}
    JCK.save_state(jp, js, extra_meta=extra)
    TCK.save_state(tp, ts, extra_meta=extra)
    assert TCK.load_meta(tp) == JCK.load_meta(jp)
    want = _ref_fields(js)
    _assert_fields_equal(TCK.state_fields(ts), want)
    _assert_fields_equal(_ref_fields(JCK.load_state(tp)), want)
    back = TCK.load_state(jp, device="cpu")
    assert type(back) is type(ts)
    _assert_fields_equal(TCK.state_fields(back), want)
    if cls == "FusedState":
        assert isinstance(back.msgs, np.float32) and back.round == js.round


class _TwoRanks:
    """One rank of a two-rank group in this process: the other rank holds
    the same rows, so the all_gather stacks them twice."""
    size, device = 2, CPU

    def __init__(self, rank: int):
        self.rank = rank

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x])

    def barrier(self) -> None:
        pass


@pytest.mark.parametrize("how", ["save_state", "run_with_checkpoints"])
@pytest.mark.parametrize("rank", [0, 1])
def test_only_the_writer_copies_the_tables(tmp_path, monkeypatch, how,
                                           rank):
    """At K ranks the gathered tables reach the host on rank 0 alone,
    which writes the padded global file; another rank reads only the
    curve (and the carry) and writes nothing."""
    _, ts = _random_state("SwimState", np.random.default_rng(3))
    fetched, real = [], TCK._fetch
    monkeypatch.setattr(TCK, "_fetch",
                        lambda xs: fetched.extend(xs) or real(xs))
    path, group = str(tmp_path / "s.npz"), _TwoRanks(rank)
    if how == "save_state":
        TCK.save_state(path, ts, group=group)
    else:
        TCK.run_with_checkpoints(
            lambda s: s._replace(round=s.round + 1), ts, 2, path, every=1,
            curve_fn=lambda s: s.wire.sum(), group=group)
        assert fetched           # the curve, on every rank
    tables = [x for x in fetched
              if isinstance(x, torch.Tensor) and x.dim() == 2]
    assert bool(tables) == (rank == 0) == os.path.exists(path)
    if rank == 0:
        back = TCK.load_state(path, device="cpu")
        assert torch.equal(back.wire, torch.cat([ts.wire, ts.wire]))
        assert torch.equal(back.timer, torch.cat([ts.timer, ts.timer]))


# -- run_with_checkpoints against the reference ---------------------------

def _si_pair(fault_name, n=N):
    jf, tf = _faults(fault_name)
    jp, tp = config_pair("ProtocolConfig", mode="pushpull", fanout=2,
                         rumors=2)
    jstep, tables = JSI.make_si_round(jp, JG.complete(n), jf, 0,
                                      tabled=True)
    tstep = TSI.make_si_round(tp, TG.complete(n), tf, 0, CPU)
    js = JST.init_state(JC.RunConfig(seed=0), jp, n)
    ts = TST.init_state(TC.RunConfig(seed=0), tp, n, CPU)
    return (jf, jstep, tables, js), (tf, tstep, ts)


def _curve_fns(jf, tf, kind, n=N):
    """The same curve in both packages: flat (coverage) or named
    (coverage and msgs); the port's counts on the device, the values on
    the host."""
    if kind is None:
        return None, {}
    alive_j = JNE.metric_alive(jf, n, 0)
    alive_t = TNE.metric_alive(tf, n, 0, CPU)
    total = n if alive_t is None else int(alive_t.sum())
    folded = alive_t is None or TNE.folded_denominator(tf)
    frac = f32_mean if folded else f32_fraction

    def jcov(s):
        return JSI.coverage(s.seen, alive_j)

    if kind == "flat":
        return jcov, dict(curve_fn=lambda s: TSI.least_count(s.seen,
                                                              alive_t),
                          curve_value=lambda c: frac(int(c), total))
    return (lambda s: {"coverage": jcov(s), "msgs": s.msgs}), dict(
        curve_fn=lambda s: {"count": TSI.least_count(s.seen, alive_t),
                            "msgs": s.msgs},
        curve_value=lambda row: {"coverage": frac(int(row["count"]),
                                                  total),
                                 "msgs": float(row["msgs"])})


def _legs(runner, tmp_path, tag, resume_from=None):
    """Straight to T, and to HALF then on to T from the file."""
    straight = runner(str(tmp_path / f"{tag}-full.npz"), None, T)
    half_path = str(tmp_path / f"{tag}-half.npz")
    runner(half_path, None, HALF)
    resumed = runner(half_path, resume_from or half_path, T)
    return straight, resumed


@pytest.mark.parametrize("curve", [None, "flat", "named"])
@pytest.mark.parametrize("fault", ["none", "program"])
def test_run_with_checkpoints_equals_reference(tmp_path, fault, curve):
    """The same SI step under both runners, killed at round 3 (inside the
    window, mid-ramp) and resumed from the file: the final state, the
    curve and the metadata (``round``, ``dropped``, ``curve``) equal the
    reference's straight and resumed runs, bitwise, and one host read
    ends each segment."""
    (jf, jstep, tables, js0), (tf, tstep, ts0) = _si_pair(fault)
    jcurve, tkw = _curve_fns(jf, tf, curve)
    lost = tf is not None

    def jrun(path, resume, rounds):
        meta = JCK.load_meta(resume)["extra"] if resume else {}
        st = JCK.load_state(resume) if resume else js0
        prefix = meta.get("curve", ())
        return JCK.run_with_checkpoints(
            jstep, st, rounds - int(st.round), path, every=EVERY,
            step_args=tables, curve_fn=jcurve, track_lost=lost,
            lost_prefix=meta.get("dropped", 0.0), curve_prefix=prefix)

    reads = []
    fetch = TCK._fetch

    def counted(tensors):
        reads.append(len(tensors))
        return fetch(tensors)

    def trun(path, resume, rounds):
        meta = TCK.load_meta(resume)["extra"] if resume else {}
        st = TCK.load_state(resume, device="cpu") if resume else ts0
        TCK._fetch = counted
        try:
            return TCK.run_with_checkpoints(
                tstep, st, rounds - st.round, path, every=EVERY,
                track_lost=lost, lost_prefix=meta.get("dropped", 0.0),
                curve_prefix=meta.get("curve", ()), **tkw)
        finally:
            TCK._fetch = fetch

    jlegs = _legs(jrun, tmp_path, "j")
    tlegs = _legs(trun, tmp_path, "t")
    # 4 + 1 + 3 segments, one read each
    assert len(reads) == 8
    for tag in ("full", "half"):
        assert (TCK.load_meta(str(tmp_path / f"t-{tag}.npz"))
                == JCK.load_meta(str(tmp_path / f"j-{tag}.npz")))
    for j, t in zip(jlegs, tlegs):
        jstate, jc = j if curve else (j, None)
        tstate, tc = t if curve else (t, None)
        _assert_fields_equal(TCK.state_fields(tstate), _ref_fields(jstate))
        assert tc == jc
    full = TCK.load_meta(str(tmp_path / "t-full.npz"))["extra"]
    assert full["round"] == T
    if lost:
        assert full["dropped"] == TCK.load_meta(
            str(tmp_path / "t-half.npz"))["extra"]["dropped"]
        assert full["dropped"] > 0
    if curve == "flat":
        _rule_matters(tlegs[0][1], N)


def test_curve_shape_errors_are_the_reference(tmp_path):
    """A flat prefix with a named curve, and a named prefix with a flat
    curve, raise the reference's ``TypeError``s; with no round to run a
    named curve still names its channels (and the file records them)."""
    (jf, jstep, tables, js0), (tf, tstep, ts0) = _si_pair("none", 16)
    jflat, tflat = _curve_fns(jf, tf, "flat", 16)
    jnamed, tnamed = _curve_fns(jf, tf, "named", 16)
    for jfn, tkw, prefix in ((jnamed, tnamed, [0.5]),
                             (jflat, tflat, {"coverage": [0.5]})):
        with pytest.raises(TypeError) as want:
            JCK.run_with_checkpoints(jstep, js0, 2, str(tmp_path / "j"),
                                     step_args=tables, curve_fn=jfn,
                                     curve_prefix=prefix)
        with pytest.raises(TypeError) as got:
            TCK.run_with_checkpoints(tstep, ts0, 2, str(tmp_path / "t"),
                                     curve_prefix=prefix, **tkw)
        assert str(got.value) == str(want.value)
    _, jc = JCK.run_with_checkpoints(jstep, js0, 0,
                                     str(tmp_path / "j0.npz"),
                                     step_args=tables, curve_fn=jnamed)
    _, tc = TCK.run_with_checkpoints(tstep, ts0, 0,
                                     str(tmp_path / "t0.npz"), **tnamed)
    assert tc == jc == {"coverage": [], "msgs": []}
    assert (TCK.load_meta(str(tmp_path / "t0.npz"))
            == JCK.load_meta(str(tmp_path / "j0.npz")))


# -- the fault-program digest ---------------------------------------------

@pytest.mark.parametrize("program", [
    None, dict(drop_prob=0.1),
    dict(churn=dict(events=((3, 2, 5), (7, 1, -1)))),
    dict(churn=dict(partitions=((0, 6, 100), (9, 40, 30)))),
    dict(churn=dict(ramp=(1, 4, 0.0, 0.3)), drop_prob=0.02),
    dict(FAULTS["program"]),
    dict(FAULTS["program"], node_death_rate=0.2, seed=7),
])
@pytest.mark.parametrize("origin", [0, 11])
def test_schedule_fingerprint_is_the_reference(program, origin):
    """The digest of the static (None), churn, partition, ramp and mixed
    programs, with deaths and another origin, equals the reference's."""
    jf, tf = (None, None) if program is None else fault_pair(**program)
    want = JNE.schedule_fingerprint(jf, 203, origin)
    assert TNE.schedule_fingerprint(tf, 203, origin) == want
    assert (want is None) == (program is None or "churn" not in program)


# -- the single-device drivers --------------------------------------------

def _ref_si(jf, path, rounds, resume=None):
    """The reference's single-device ``--checkpoint`` driver (its
    command's inline code), with the curve."""
    jp = JC.ProtocolConfig(mode="pushpull", fanout=2, rumors=2)
    step, tables = JSI.make_si_round(jp, JG.complete(N), jf, 0,
                                     tabled=True)
    meta = JCK.load_meta(resume)["extra"] if resume else {}
    st = (JCK.load_state(resume) if resume
          else JST.init_state(JC.RunConfig(seed=0), jp, N))
    alive = JNE.metric_alive(jf, N, 0)
    st, curve = JCK.run_with_checkpoints(
        step, st, rounds - int(st.round), path, every=EVERY,
        step_args=tables, curve_fn=lambda s: JSI.coverage(s.seen, alive),
        curve_prefix=meta.get("curve", ()),
        track_lost=JNE.get(jf) is not None,
        lost_prefix=meta.get("dropped", 0.0))
    return st, float(JSI.coverage(st.seen, alive)), curve


def _port_si(tf, path, rounds, resume=None):
    meta = TCK.load_meta(resume)["extra"] if resume else {}
    return TSIM.checkpointed_si(
        TC.ProtocolConfig(mode="pushpull", fanout=2, rumors=2),
        TG.complete(N), TC.RunConfig(seed=0, max_rounds=rounds), path,
        every=EVERY, fault=tf,
        resume_state=TCK.load_state(resume, "cpu") if resume else None,
        want_curve=True, curve_prefix=meta.get("curve", ()),
        lost_prefix=meta.get("dropped", 0.0), device="cpu")


def _ref_swim(jf, path, rounds, resume=None, every=EVERY):
    meta = JCK.load_meta(resume)["extra"] if resume else {}
    return JSIM.checkpointed_swim(
        JC.ProtocolConfig(**_SWIM_PROTO), N,
        JC.RunConfig(seed=2, max_rounds=rounds), path, every=every,
        dead_nodes=(1,), fail_round=2, fault=jf,
        resume_state=JCK.load_state(resume) if resume else None,
        want_curve=True, curve_prefix=meta.get("curve", ()))


def _port_swim(tf, path, rounds, resume=None, every=EVERY):
    meta = TCK.load_meta(resume)["extra"] if resume else {}
    return TSIM.checkpointed_swim(
        TC.ProtocolConfig(**_SWIM_PROTO), N,
        TC.RunConfig(seed=2, max_rounds=rounds), path, every=every,
        dead_nodes=(1,), fail_round=2, fault=tf,
        resume_state=TCK.load_state(resume, "cpu") if resume else None,
        want_curve=True, curve_prefix=meta.get("curve", ()), device="cpu")


def _ref_rumor(jf, path, rounds, resume=None):
    meta = JCK.load_meta(resume)["extra"] if resume else {}
    return JRU.checkpointed_rumor(
        JC.ProtocolConfig(**_RUMOR_PROTO), JG.complete(N),
        JC.RunConfig(seed=4, max_rounds=rounds), path, every=EVERY,
        fault=jf, resume_state=JCK.load_state(resume) if resume else None,
        want_curve=True, curve_prefix=meta.get("curve", ()),
        lost_prefix=meta.get("dropped", 0.0))


def _port_rumor(tf, path, rounds, resume=None):
    meta = TCK.load_meta(resume)["extra"] if resume else {}
    return TRU.checkpointed_rumor(
        TC.ProtocolConfig(**_RUMOR_PROTO), TG.complete(N),
        TC.RunConfig(seed=4, max_rounds=rounds), path, every=EVERY,
        fault=tf,
        resume_state=TCK.load_state(resume, "cpu") if resume else None,
        want_curve=True, curve_prefix=meta.get("curve", ()),
        lost_prefix=meta.get("dropped", 0.0), device="cpu")


_SWIM_PROTO = dict(mode="swim", fanout=2, swim_proxies=2,
                   swim_suspect_rounds=3, swim_subjects=4)
_RUMOR_PROTO = dict(mode="rumor", fanout=2, rumors=2, rumor_k=3)
# SWIM refuses partition windows: its program is the crash events and
# the ramp
_SWIM_FAULT = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (2, 1, -1)), ramp=(1, 4, 0.0, 0.3)))
DRIVERS = {"si": (_ref_si, _port_si), "swim": (_ref_swim, _port_swim),
           "rumor": (_ref_rumor, _port_rumor)}


def _driver_fault(kind, name):
    if kind == "swim" and name == "program":
        return fault_pair(**_SWIM_FAULT)
    return _faults(name)


def _unpack(kind, out):
    """``(final state, coverage, curve)`` of a driver's result."""
    return (out[0], out[1], out[3]) if kind == "rumor" else out


@pytest.mark.parametrize("fault", ["none", "program", "deaths"])
@pytest.mark.parametrize("kind", ["si", "swim", "rumor"])
def test_driver_resume_straight_and_cross_package(tmp_path, kind, fault):
    """The port's straight run equals the reference's; its run killed at
    round 3 and resumed equals its straight run; the reference's half
    file resumed by the port equals the reference's straight run.  The
    state, the eager coverage, the curve (named channels for rumor
    mongering), ``round`` and ``dropped``, bitwise."""
    jf, tf = _driver_fault(kind, fault)
    ref, port = DRIVERS[kind]
    p = lambda name: str(tmp_path / name)            # noqa: E731
    want = _unpack(kind, ref(jf, p("j-full.npz"), T))
    ref(jf, p("j-half.npz"), HALF)
    port(tf, p("t-half.npz"), HALF)
    runs = {"straight": port(tf, p("t-full.npz"), T),
            "resumed": port(tf, p("t-half.npz"), T, p("t-half.npz")),
            "cross": port(tf, p("x.npz"), T, p("j-half.npz"))}
    for name, out in runs.items():
        st, cov, curve = _unpack(kind, out)
        _assert_fields_equal(TCK.state_fields(st), _ref_fields(want[0]))
        assert (cov, curve) == (want[1], want[2]), name
    jm = JCK.load_meta(p("j-full.npz"))["extra"]
    for name in ("t-full.npz", "t-half.npz", "x.npz"):
        assert TCK.load_meta(p(name))["extra"] == jm
    if kind == "si" and fault != "deaths":
        _rule_matters(want[2], N - (fault == "program"))
    if kind == "rumor" and fault == "none":
        _rule_matters(want[2]["coverage"], N)


def test_swim_tables_follow_the_resumed_budget(tmp_path):
    """SWIM's tables are built for ``run.max_rounds``, which the
    configuration fingerprint leaves out: a run of 6 rounds resumed with
    a budget of 40 (the pack lowering's lanes move from 8 to 16 bits)
    equals the reference doing the same, whose trajectory is the
    straight 40-round run's."""
    proto = dict(_SWIM_PROTO, swim_diss="pack")
    jp, tp = config_pair("ProtocolConfig", **proto)
    assert TSW.pack_width(6) != TSW.pack_width(130)
    out = {}
    for pkg, mod, cfg, ck, kw in (
            ("j", JSIM, JC, JCK, {}), ("t", TSIM, TC, TCK,
                                       {"device": "cpu"})):
        path = str(tmp_path / f"{pkg}.npz")
        pc = jp if pkg == "j" else tp
        mod.checkpointed_swim(pc, N, cfg.RunConfig(seed=2, max_rounds=6),
                              path, every=4, dead_nodes=(1,),
                              fail_round=2, **kw)
        st = (ck.load_state(path) if pkg == "j"
              else ck.load_state(path, "cpu"))
        out[pkg] = mod.checkpointed_swim(
            pc, N, cfg.RunConfig(seed=2, max_rounds=130), path, every=64,
            dead_nodes=(1,), fail_round=2, resume_state=st, **kw)
    _assert_fields_equal(TCK.state_fields(out["t"][0]),
                         _ref_fields(out["j"][0]))
    assert out["t"][1] == out["j"][1]


# -- the command line -----------------------------------------------------

def _main(pkg, argv, capsys):
    """``(exit code, stdout's last line as JSON or None, stderr)`` of a
    package's ``main``."""
    if pkg == "j":
        rc = JCLI.main(argv)
    else:
        rc = TCLI.main(argv + ["--device", "cpu"])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err


def _same_line(got, want):
    """The reference's line less the value the port declares, its
    ``backend`` label; ``compile_cache`` is the same store directory (or
    null with the cache off)."""
    assert got["backend"] == "torch-cpu" and want["backend"] == "jax-tpu"
    assert got["compile_cache"] == want["compile_cache"]
    drop = {"backend": None}
    assert {**got, **drop} == {**want, **drop}


CLI_CASES = {
    # README:495-496, scaled down
    "si": (["--mode", "pushpull", "--n", "1000"], 30, 45),
    "si-program": (["--mode", "pull", "--n", "500", "--drop", "0.02",
                    "--churn-event", "1:1:4", "--churn-event", "2:2",
                    "--partition", "3:9:250", "--drop-ramp", "2:8:0:0.1",
                    "--curve"], 5, 12),
    "swim": (["--mode", "swim", "--n", "300", "--fanout", "2",
              "--swim-suspect-rounds", "4", "--curve"], 7, 16),
    "rumor": (["--mode", "rumor", "--n", "400", "--rumor-k", "2",
               "--drop", "0.05", "--churn-event", "5:2:6",
               "--partition", "1:4:200", "--save-curve", "CURVE"], 4, 20),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_checkpoint_then_resume_prints_the_reference(tmp_path, capsys,
                                                         case):
    """``run --checkpoint`` then ``--max-rounds M --resume``: the port's
    lines equal the JAX command's, less the ``backend`` value; the port
    also resumes the reference's first file to the reference's line; with
    ``--save-curve`` the files (``hot_curve`` in the meta line for rumor
    mongering) equal too."""
    import shutil
    flags, first, total = CLI_CASES[case]
    path, curve = str(tmp_path / "ck.npz"), str(tmp_path / "curve.jsonl")
    argv = ["run", *[curve if f == "CURVE" else f for f in flags],
            "--checkpoint", path, "--checkpoint-every", "3"]
    lines, files = {}, {}
    for pkg in ("j", "t", "x"):
        if os.path.exists(path):
            os.remove(path)
        if pkg == "x":
            # the reference's first leg, resumed by the port
            shutil.copy(str(tmp_path / "j-first.npz"), path)
            legs = [None]
        else:
            rc, first_line, err = _main(
                pkg, argv + ["--max-rounds", str(first)], capsys)
            assert rc == 0, err
            legs = [first_line]
            if pkg == "j":
                shutil.copy(path, str(tmp_path / "j-first.npz"))
        rc, second, err = _main("j" if pkg == "j" else "t", argv + [
            "--max-rounds", str(total), "--resume"], capsys)
        assert rc == 0, err
        lines[pkg] = legs + [second]
        if "CURVE" in flags:
            files[pkg] = [json.loads(x) for x in open(curve)]
    _same_line(lines["t"][0], lines["j"][0])
    for pkg in ("t", "x"):
        _same_line(lines[pkg][1], lines["j"][1])
        if files:
            _same_line(files[pkg][0]["meta"], files["j"][0]["meta"])
            assert files[pkg][1:] == files["j"][1:]
    assert lines["t"][1]["resumed"] and lines["t"][1]["rounds"] == total
    if files:
        assert "hot_curve" in files["t"][0]["meta"]
    if case == "si-program":
        assert "dropped" in lines["t"][1] and "fault_program" in lines["t"][1]


@pytest.fixture(scope="module")
def refusal_files(tmp_path_factory):
    """The files the refusals need, written once by the reference's
    command and, for the fault-program digest's three cases, by its
    ``save_state`` with the metadata edited (a configuration that
    matches, a digest that is absent, added or different)."""
    import contextlib
    from unittest import mock
    tmp_path = tmp_path_factory.mktemp("refusals")
    p = lambda name: str(tmp_path / name)            # noqa: E731
    for name, extra in (("plain.npz", []), ("prog.npz", PROG),
                        ("curve.npz", ["--curve"]),
                        ("devs.npz", ["--mode", "pull", "--devices", "2"])):
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null), \
                mock.patch.dict(os.environ, {"GOSSIP_COMPILE_CACHE": ""}):
            assert JCLI.main(BASE + extra + ["--checkpoint", p(name)]) == 0
    with open(p("corrupt.npz"), "wb") as f:
        f.write(b"PK\x03\x04 torn by a filesystem crash")
    prog = JCK.load_meta(p("prog.npz"))["extra"]
    plain = JCK.load_meta(p("plain.npz"))["extra"]
    for name, src, meta in (
            ("nodigest.npz", "prog.npz",
             {k: v for k, v in prog.items() if k != "fault_program"}),
            ("digestnow.npz", "plain.npz",
             {**plain, "fault_program": prog["fault_program"]}),
            ("digest.npz", "prog.npz", {**prog, "fault_program": "0" * 64})):
        JCK.save_state(p(name), JCK.load_state(p(src)), meta)
    return tmp_path


BASE = ["run", "--mode", "pushpull", "--n", "64", "--max-rounds", "4"]
PROG = ["--churn-event", "1:1:3"]
REFUSALS = {
    "no-checkpoint": ["--resume"],
    "missing": ["--resume", "@missing.npz"],
    "corrupt": ["--resume", "@corrupt.npz"],
    "config": ["--resume", "--fanout", "2", "--seed", "3", "@plain.npz"],
    "no-digest-in-file": ["--resume", *PROG, "@nodigest.npz"],
    "no-program-now": ["--resume", "@digestnow.npz"],
    "digest": ["--resume", *PROG, "@digest.npz"],
    "no-curve-history": ["--resume", "--curve", "@plain.npz"],
    "curve-dropped": ["--resume", "@curve.npz"],
    "devices": ["--mode", "pull", "--devices", "4", "--resume",
                "@devs.npz"],
    "fused-push": ["--engine", "fused", "@new.npz"],
    "sharded-push": ["--devices", "2", "@new.npz"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_refusals_are_the_reference_word_for_word(refusal_files,
                                                      capsys, case):
    """Every refusal of ``run --checkpoint``: ``--resume`` without
    ``--checkpoint``, a missing and a corrupt file, a configuration
    mismatch (naming the keys that differ; another number of devices
    among them, whose padding the file holds), a file without the program's
    digest and a program the resume leaves out, a digest mismatch, the
    curve history both ways, and the engines' preconditions: exit 2 and
    the reference's message, to the character."""
    argv = BASE + [x for f in REFUSALS[case] for x in (
        ["--checkpoint", str(refusal_files / f[1:])] if f.startswith("@")
        else [f])]
    got = _main("t", argv, capsys)
    want = _main("j", argv, capsys)
    assert got[0] == want[0] == 2
    assert got[1] is None and want[1] is None
    assert got[2] == want[2] and got[2].startswith("error: ")
    if case == "config":
        assert "(differs in: proto, tc, seed)" in got[2]
    if case == "devices":
        assert "(differs in: devices)" in got[2]


def test_sigkilled_child_resumes_to_the_straight_run(tmp_path):
    """A port command child writing a checkpoint every round is killed
    (SIGKILL) once its file shows round 2 or later, then resumed; the
    resumed file's state and the line's coverage and msgs equal an
    uninterrupted run's."""
    path = str(tmp_path / "kill.npz")
    argv = [sys.executable, "-m", "gossip_tpu_torch", "run", "--mode",
            "pushpull", "--n", "64", "--max-rounds", "300",
            "--checkpoint", path, "--checkpoint-every", "1",
            "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO}
    child = subprocess.Popen(argv, cwd=REPO, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    killed_at = None
    deadline = time.time() + 120
    try:
        while time.time() < deadline and child.poll() is None:
            try:
                killed_at = TCK.load_meta(path)["extra"]["round"]
            except (OSError, ValueError, KeyError):
                killed_at = None
            if killed_at is not None and killed_at >= 2:
                child.send_signal(signal.SIGKILL)
                break
            time.sleep(0.005)
    finally:
        child.wait(timeout=60)
    assert child.returncode == -signal.SIGKILL
    at = TCK.load_meta(path)["extra"]["round"]
    assert 2 <= at < 300
    done = subprocess.run(argv + ["--resume"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["resumed"] and out["rounds"] == 300
    straight = str(tmp_path / "straight.npz")
    st, cov, _ = TSIM.checkpointed_si(
        TC.ProtocolConfig(mode="pushpull"), TG.complete(64),
        TC.RunConfig(max_rounds=300), straight, every=300, device="cpu")
    _assert_fields_equal(TCK.state_fields(TCK.load_state(path, "cpu")),
                         TCK.state_fields(st))
    assert (out["coverage"], out["msgs"]) == (cov, float(st.msgs))
