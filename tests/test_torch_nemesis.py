"""The port's nemesis (gossip_tpu_torch/ops/nemesis.py) and the churn
branches of its SI rounds and loops against the JAX package's, bitwise
(tolerance 0).

Both packages lower the same fault programs (crash/recover events, a
permanent crash, a crash of the rumor origin, partition windows, drop
ramps, the reference's ``mixed_scenarios`` and its ``churn_heal``
program) and run them from the same state, the port on the CPU: the
tables, every per-round helper, and ``seen``, ``msgs`` and ``lost`` after
every round of every SI mode on both layouts must be equal, as must the
loops' rounds, coverage and msgs.  The loops' stop test is held to the
reference's condition evaluated under ``jax.jit`` at counts where the
compiled and the eager float32 coverage disagree.  The reference runs
live, its executable store off.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.backend import run_simulation as jrun_simulation
from gossip_tpu.cli import _parse_churn as j_parse_churn
from gossip_tpu.models import si as JSI
from gossip_tpu.models import si_packed as JP
from gossip_tpu.models.state import init_state as j_init_state
from gossip_tpu.ops import bitpack as JB
from gossip_tpu.ops import nemesis as JNE
from gossip_tpu.runtime import simulator as JS
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import bench
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.cli import _parse_churn
from gossip_tpu_torch.models import si_packed as P
from gossip_tpu_torch.models import state as S
from gossip_tpu_torch.models.si import PULL_DROP_TAG, make_si_round
from gossip_tpu_torch.ops import fast_sampling as FS
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.bitpack import coverage_packed, pack, unpack
from gossip_tpu_torch.ops.sampling import apply_drop
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 240
ROUNDS = 8


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _program(n, death=False, **over):
    """Both packages' FaultConfig keywords for a mixed program: node 3
    down for rounds [1, 4), node 7 down for good from round 0, the
    origin 0 down for rounds [2, 5), a cut at n // 3 for rounds [1, 5)
    and the drop probability ramped 0 -> 0.3 over [0, 4) (0.05 before
    the ramp's start, none here)."""
    kw = dict(node_death_rate=0.1 if death else 0.0, drop_prob=0.05,
              seed=3, churn=dict(events=((3, 1, 4), (7, 0, -1), (0, 2, 5)),
                                 partitions=((1, 5, n // 3),),
                                 ramp=(0, 4, 0.0, 0.3)))
    kw.update(over)
    return kw


def _faults(**kw):
    return JC.FaultConfig(**kw), TC.FaultConfig(**kw)


def _heal(n):
    tf = bench.heal_fault(n)
    ch = tf.churn
    return JC.FaultConfig(drop_prob=tf.drop_prob, seed=tf.seed,
                          churn=JC.ChurnConfig(
                              events=ch.events, partitions=ch.partitions,
                              ramp=ch.ramp)), tf


def _mixed(k, n):
    """The reference's and the port's ``mixed_scenarios(k, n)``, pairwise
    equal in every field."""
    js = JNE.mixed_scenarios(k, n, drop_prob=0.01, seed=2)
    ts = NE.mixed_scenarios(k, n, drop_prob=0.01, seed=2)
    for j, t in zip(js, ts):
        assert (j.drop_prob, j.seed, j.churn.events, j.churn.partitions,
                j.churn.ramp) == (t.drop_prob, t.seed, t.churn.events,
                                  t.churn.partitions, t.churn.ramp)
    return list(zip(js, ts))


def _assert_same(jst, tst):
    seen, rnd, key, msgs = S.state_to_numpy(tst)
    np.testing.assert_array_equal(seen, np.asarray(jst.seen))
    assert rnd == int(jst.round)
    np.testing.assert_array_equal(key, np.asarray(
        jax.random.key_data(jst.base_key)))
    assert msgs == np.float32(jst.msgs)


# -- config ---------------------------------------------------------------

REJECTED = [
    (dict(events=((3, 5, 5),)), "recover_round"),
    (dict(events=((3, 1, 2), (3, 5, -1))), "at most once"),
    (dict(events=((3, -1, 2),)), "die_round"),
    (dict(events=((-3, 1, 2),)), "node"),
    (dict(events=((3, 1),)), "node, die_round, recover_round"),
    (dict(partitions=((0, 5, 8), (4, 9, 16))), "overlap"),
    (dict(partitions=((0, 5, 0),)), "cut"),
    (dict(partitions=((5, 5, 8),)), "start < end"),
    (dict(partitions=((0, 5),)), "start, end, cut"),
    (dict(ramp=(0, 3, 0.0, 1.5)), "outside"),
    (dict(ramp=(3, 3, 0.0, 0.5)), "start < end"),
    (dict(partitions=((0, 1_000_000_000, 8),)), "horizon cap"),
    (dict(ramp=(0, 1_000_000_000, 0.0, 0.5)), "horizon cap"),
    (dict(ramp=(0, 5)), "start, end, from_p, to_p"),
    (dict(events=((5, 0, 1 << 29),)), "horizon cap"),
    (dict(events=((5, 1 << 31, -1),)), "horizon cap"),
]


@pytest.mark.parametrize("kw,match", REJECTED,
                         ids=[f"{m}-{i}" for i, (_, m) in enumerate(REJECTED)])
def test_churn_config_validation(kw, match):
    for cfg in (JC.ChurnConfig, TC.ChurnConfig):
        with pytest.raises(ValueError, match=match):
            cfg(**kw)


def test_churn_config_accepts_and_normalizes():
    ok = dict(events=((3, 2, 5), (7, 1, -1)),
              partitions=((0, 4, 8), (6, 9, 16)), ramp=(0, 3, 0.0, 1.0))
    for kw in (ok, dict(partitions=((0, TC.MAX_CHURN_HORIZON, 8),))):
        j, t = JC.ChurnConfig(**kw), TC.ChurnConfig(**kw)
        assert (t.events, t.partitions, t.ramp, t.horizon()) == \
            (j.events, j.partitions, j.ramp, j.horizon())
    assert TC.MAX_CHURN_HORIZON == JC.MAX_CHURN_HORIZON
    # an empty program is no program; a dict (a JSON object) is coerced
    assert TC.FaultConfig(drop_prob=0.1, churn=TC.ChurnConfig()).churn \
        is None
    d = {"events": [[3, 2, 5]], "partitions": [[0, 4, 8]],
         "ramp": [1, 3, 0, 0.5]}
    t = TC.FaultConfig(drop_prob=0.1, churn=d).churn
    j = JC.FaultConfig(drop_prob=0.1, churn=d).churn
    assert isinstance(t, TC.ChurnConfig)
    assert (t.events, t.partitions, t.ramp) == (j.events, j.partitions,
                                                j.ramp) == \
        (((3, 2, 5),), ((0, 4, 8),), (1, 3, 0.0, 0.5))
    assert TC.ChurnConfig(partitions=((0, 6, 8),)).horizon() == 7
    assert TC.ChurnConfig(events=((1, 2, 4),)).horizon() == 2
    with pytest.raises(ValueError, match="ChurnConfig"):
        TC.FaultConfig(churn=object())


# -- the lowering and the per-round helpers -------------------------------

def _programs(n):
    return [("heal", *_heal(n)),
            ("mixed_program", *_faults(**_program(n, death=True)))] + \
        [(f"mixed_scenarios_{i}", j, t)
         for i, (j, t) in enumerate(_mixed(8, n))]


@pytest.mark.parametrize("t_pad", [None, 64, 256])
def test_build_matches_reference(t_pad):
    n = 96
    for name, jf, tf in _programs(n):
        want = JNE.build(jf, n, n_pad=n + 5, t_pad=t_pad)
        got = NE.build(tf, n, n_pad=n + 5, t_pad=t_pad, device=CPU)
        for field in NE.Schedule._fields:
            g, w = getattr(got, field), np.asarray(getattr(want, field))
            assert g.dtype == {"float32": torch.float32,
                               "int32": torch.int32}[str(w.dtype)], field
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert NE.canonical_horizon(tf.churn) == \
            JNE.canonical_horizon(jf.churn)
    with pytest.raises(ValueError, match="below the schedule horizon"):
        NE.build(tf, n, t_pad=3, device=CPU)
    with pytest.raises(ValueError, match="node ids"):
        NE.build(TC.FaultConfig(churn=TC.ChurnConfig(events=((n, 0, -1),))),
                 n, device=CPU)
    with pytest.raises(ValueError, match="one side"):
        NE.validate_events(TC.FaultConfig(churn=TC.ChurnConfig(
            partitions=((0, 2, n),))), n)


@pytest.mark.parametrize("death", [False, True])
def test_round_helpers_match_reference(death):
    n, origin = 96, 5
    rng = np.random.default_rng(1)
    for name, jf, tf in _programs(n):
        if death:
            kw = dict(node_death_rate=0.2, drop_prob=jf.drop_prob,
                      seed=jf.seed)
            jf = JC.FaultConfig(churn=jf.churn, **kw)
            tf = TC.FaultConfig(churn=tf.churn, **kw)
        js, ts = JNE.build(jf, n), NE.build(tf, n, device=CPU)
        jbase = JNE.base_alive_or_ones(jf, n, origin)
        tbase = NE.base_alive_or_ones(tf, n, origin, CPU)
        np.testing.assert_array_equal(tbase.numpy(), np.asarray(jbase))
        for fn in ("eventual_alive", "metric_alive"):
            np.testing.assert_array_equal(
                getattr(NE, fn)(tf, n, origin, CPU).numpy(),
                np.asarray(getattr(JNE, fn)(jf, n, origin)), err_msg=fn)
        assert NE.permanent_dead_ids(tf.churn) == \
            JNE.permanent_dead_ids(jf.churn)
        src = rng.integers(0, n, 40)
        tgt = rng.integers(0, n + 1, (40, 2))       # n: the sentinel
        act = rng.random(40) < 0.7
        for r in range(js.cut_tbl.shape[0] + 4):
            ja = JNE.alive_rows(js, jbase, r)
            np.testing.assert_array_equal(
                NE.alive_rows(ts, tbase, r).numpy(), np.asarray(ja))
            assert NE.drop_at(ts, r).item() == float(JNE.drop_at(js, r))
            assert NE.drop_at(ts, r).dtype == torch.float32
            assert NE.cut_at(ts, r).item() == int(JNE.cut_at(js, r))
            jcut, tcut = JNE.cut_at(js, r), NE.cut_at(ts, r)
            jpost = JNE.partition_targets(jcut, jnp.asarray(src, jnp.int32),
                                          jnp.asarray(tgt, jnp.int32), n)
            for dt in (torch.int32, torch.int64):
                tpost = NE.partition_targets(
                    tcut, torch.from_numpy(src), torch.from_numpy(tgt).to(dt),
                    n)
                assert tpost.dtype == dt
                np.testing.assert_array_equal(tpost.numpy(),
                                              np.asarray(jpost))
            jl = JNE.lost_count(jnp.asarray(tgt), jpost, jnp.asarray(act), n)
            tl = NE.lost_count(torch.from_numpy(tgt), tpost,
                               torch.from_numpy(act), n)
            assert tl.dtype == torch.float32 and tl.item() == float(jl)
    # metric_alive without a program is the static mask (None: no deaths)
    assert NE.metric_alive(None, n, 0, CPU) is None
    assert NE.metric_alive(TC.FaultConfig(drop_prob=0.1), n, 0, CPU) is None


def test_build_or_static_matches_reference():
    n = 50
    for jf, tf in ((None, None), _faults(drop_prob=0.07),
                   _faults(node_death_rate=0.1, drop_prob=0.1),
                   _heal(n)):
        want = JNE.build_or_static(jf, n, n_pad=n + 3)
        got = NE.build_or_static(tf, n, n_pad=n + 3, device=CPU)
        for field in NE.Schedule._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)), err_msg=field)


def test_drop_lost_and_check_supported():
    assert NE.drop_lost(len, None) is len
    assert NE.drop_lost(lambda x: (x + 1, 0.5), object())(1) == 2
    tf = _heal(N)[1]
    NE.check_supported(tf, engine="xla")
    NE.check_supported(None, engine="x", events=False)
    for kw, match in ((dict(events=False), "does not run churn"),
                      (dict(partitions=False), "partition windows"),
                      (dict(ramp=False), "drop-rate ramp")):
        with pytest.raises(ValueError, match=match):
            NE.check_supported(tf, engine="x", **kw)
    # a program with no ramp passes ramp=False
    NE.check_supported(TC.FaultConfig(churn=dict(events=((1, 1, 2),))),
                       engine="x", ramp=False, partitions=False)


# -- the churn rounds against jax.jit of the reference's ------------------

def _topos(family, n=N):
    if family == "complete":
        return JG.complete(n), G.complete(n)
    if family == "watts_strogatz":
        return (JG.watts_strogatz(n, 4, 0.2, seed=1),
                G.watts_strogatz(n, 4, 0.2, seed=1, device=CPU))
    return (JG.erdos_renyi(n, 0.03, seed=2),
            G.erdos_renyi(n, 0.03, seed=2, device=CPU))


SI_CASES = [(mode, period, family, death)
            for mode, period in (("push", 1), ("pull", 1), ("pushpull", 1),
                                 ("antientropy", 1), ("antientropy", 2))
            for family in ("complete", "erdos_renyi")
            for death in (False, True)] + \
           [("flood", 1, "erdos_renyi", death) for death in (False, True)]


@pytest.mark.parametrize("mode,period,family,death", SI_CASES)
def test_churn_round_matches_reference(mode, period, family, death):
    jt, tt = _topos(family)
    kw = dict(mode=mode, fanout=2, rumors=3, period=period)
    jp, tp = JC.ProtocolConfig(**kw), TC.ProtocolConfig(**kw)
    jf, tf = _faults(**_program(N, death))
    jr, tr = JC.RunConfig(seed=5), TC.RunConfig(seed=5)
    jstep = jax.jit(JSI.make_si_round(jp, jt, jf, jr.origin))
    tstep = make_si_round(tp, tt, tf, tr.origin, CPU)
    jst, tst = j_init_state(jr, jp, N), S.init_state(tr, tp, N, CPU)
    lost = []
    for _ in range(ROUNDS):
        (jst, jl), (tst, tl) = jstep(jst), tstep(tst)
        _assert_same(jst, tst)
        assert tl.dtype == torch.float32 and tl.item() == float(jl)
        lost.append(tl.item())
    assert sum(lost) > 0 and np.asarray(jst.seen).sum() > 3
    if mode == "antientropy" and period == 2:
        assert lost[1::2] == [0.0] * (ROUNDS // 2)    # quiescent rounds


PACKED_CASES = [(mode, period, family, death)
                for mode, period in (("pull", 1), ("antientropy", 1),
                                     ("antientropy", 2))
                for family in ("complete", "watts_strogatz")
                for death in (False, True)]


@pytest.mark.parametrize("mode,period,family,death", PACKED_CASES)
def test_churn_packed_round_matches_reference(mode, period, family, death):
    jt, tt = _topos(family)
    kw = dict(mode=mode, fanout=2, rumors=33, period=period)
    jp, tp = JC.ProtocolConfig(**kw), TC.ProtocolConfig(**kw)
    jf, tf = _faults(**_program(N, death))
    jr, tr = JC.RunConfig(seed=11), TC.RunConfig(seed=11)
    jstep = jax.jit(JP.make_packed_round(jp, jt, jf, jr.origin))
    tstep = P.make_packed_round(tp, tt, tf, tr.origin, device=CPU)
    jst = JP.init_packed_state(jr, jp, N)
    tst = P.init_packed_state(tr, tp, N, CPU)
    for _ in range(ROUNDS):
        (jst, jl), (tst, tl) = jstep(jst), tstep(tst)
        _assert_same(jst, tst)
        assert tl.dtype == torch.float32 and tl.item() == float(jl)


@pytest.mark.parametrize("mode,family", [("pull", "complete"),
                                         ("antientropy", "erdos_renyi")])
def test_churn_packed_equals_bool(mode, family):
    """The reference's packed == unpacked anchor under a program, on the
    port's own two layouts: ``seen`` and ``lost`` every round."""
    _, tt = _topos(family, 64)
    tp = TC.ProtocolConfig(mode=mode, fanout=2, rumors=3, period=2)
    _, tf = _faults(**_program(64, death=True))
    tr = TC.RunConfig(seed=0, max_rounds=6)
    pstep = P.make_packed_round(tp, tt, tf, 0, device=CPU)
    ustep = make_si_round(tp, tt, tf, 0, CPU)
    pst, ust = P.init_packed_state(tr, tp, 64, CPU), S.init_state(tr, tp, 64,
                                                                 CPU)
    for r in range(6):
        (pst, lp), (ust, lu) = pstep(pst), ustep(ust)
        assert torch.equal(unpack(pst.seen, 3), ust.seen), r
        assert lp.item() == lu.item() and pst.msgs.item() == ust.msgs.item()


@pytest.mark.parametrize("layout", ["bool", "packed"])
def test_static_schedule_follows_the_static_trajectory(layout):
    """A step run under ``build_or_static`` follows the static step bit
    for bit; its ``lost`` counts the static drop coins."""
    _, tt = _topos("erdos_renyi")
    mode = "pushpull" if layout == "bool" else "pull"
    tp = TC.ProtocolConfig(mode=mode, fanout=2, rumors=2)
    tr = TC.RunConfig(seed=4)
    for fault in (None, TC.FaultConfig(drop_prob=0.1),
                  TC.FaultConfig(node_death_rate=0.1, drop_prob=0.05)):
        sched = NE.build_or_static(fault, N, device=CPU)
        if layout == "bool":
            plain = make_si_round(tp, tt, fault, 0, CPU)
            under = make_si_round(tp, tt, fault, 0, CPU, schedule=sched)
            a = b = S.init_state(tr, tp, N, CPU)
        else:
            plain = P.make_packed_round(tp, tt, fault, 0, device=CPU)
            under = P.make_packed_round(tp, tt, fault, 0, device=CPU,
                                        schedule=sched)
            a = b = P.init_packed_state(tr, tp, N, CPU)
        lost = 0.0
        for _ in range(5):
            a, (b, lb) = plain(a), under(b)
            assert torch.equal(a.seen, b.seen)
            assert a.msgs.item() == b.msgs.item()
            lost += lb.item()
        assert (lost > 0) == (fault is not None)
    with pytest.raises(ValueError, match="schedule holds"):
        make_si_round(tp, tt, None, 0, CPU,
                      schedule=NE.build_or_static(None, N + 1, device=CPU))


def test_kernel_sampler_churn_round_is_the_composed_replay():
    """``sampler="kernel"`` under a program on the CPU (the sampler's
    plain version) equals a replay composed from ``sample_targets_plain``
    and the nemesis helpers: the threefry coin at the schedule's
    probability, the cut, the round's alive rows, the gather."""
    n, seed = 300, 9
    tp = TC.ProtocolConfig(mode="pull", fanout=1)
    tr = TC.RunConfig(seed=seed)
    tf = _heal(n)[1]
    step = P.make_packed_round(tp, G.complete(n), tf, 0, "kernel", seed,
                               device=CPU)
    st = P.init_packed_state(tr, tp, n, CPU)
    sched = NE.build(tf, n, device=CPU)
    base = NE.base_alive_or_ones(tf, n, 0, CPU)
    ids = torch.arange(n)
    seen, msgs = st.seen.clone(), 0.0
    for r in range(10):
        st, lost = step(st)
        p0 = FS.sample_targets_plain(FS.round_seed(seed, r), n, n, 1, True,
                                     device=CPU)
        rkey = threefry.fold_in(threefry.key(seed, CPU), r)
        p = apply_drop(rkey, PULL_DROP_TAG, ids, p0, NE.drop_at(sched, r), n,
                       force=True)
        p = NE.partition_targets(NE.cut_at(sched, r), ids, p, n)
        alive = NE.alive_rows(sched, base, r)
        vis = torch.where(alive[:, None], seen, 0)
        got = torch.where(p < n, vis[torch.clamp(p, max=n - 1).long(), 0],
                          0)
        seen = seen | torch.where(alive[:, None], got, 0)
        p = torch.where(alive[:, None], p, n)
        msgs = np.float32(msgs + np.float32(2.0) * np.float32(
            int((p < n).sum())))
        want_lost = int(((p0 < n) & alive[:, None]).sum() - (p < n).sum())
        assert torch.equal(st.seen, seen) and st.msgs.item() == msgs, r
        assert lost.item() == want_lost, r
    assert p0.dtype == torch.int32 and int(st.seen.sum()) > n // 4


# -- the loops ------------------------------------------------------------

@pytest.mark.parametrize("loop,mode,family,death", [
    ("until", "pull", "erdos_renyi", False),
    ("until", "pushpull", "complete", True),
    ("curve", "push", "complete", False),
    ("curve", "antientropy", "erdos_renyi", True),
    ("packed", "pull", "complete", False),
    ("packed", "antientropy", "watts_strogatz", True),
])
def test_loops_under_the_heal_program_match_reference(loop, mode, family,
                                                      death):
    jt, tt = _topos(family)
    kw = dict(mode=mode, fanout=1, rumors=2,
              period=2 if mode == "antientropy" else 1)
    jp, tp = JC.ProtocolConfig(**kw), TC.ProtocolConfig(**kw)
    jf, tf = _heal(N)
    if death:
        jf = JC.FaultConfig(node_death_rate=0.1, drop_prob=0.02,
                            churn=jf.churn)
        tf = TC.FaultConfig(node_death_rate=0.1, drop_prob=0.02,
                            churn=tf.churn)
    rk = dict(seed=3, max_rounds=40, target_coverage=0.95)
    jr, tr = JC.RunConfig(**rk), TC.RunConfig(**rk)
    if loop == "until":
        ju, tu = JS.simulate_until(jp, jt, jr, jf), \
            TS.simulate_until(tp, tt, tr, tf, CPU)
        assert (tu.rounds, tu.coverage, tu.msgs) == \
            (ju.rounds, ju.coverage, ju.msgs)
        _assert_same(ju.state, tu.state)
    elif loop == "curve":
        jc, tc = JS.simulate_curve(jp, jt, jr, jf), \
            TS.simulate_curve(tp, tt, tr, tf, CPU)
        np.testing.assert_array_equal(tc.coverage, jc.coverage)
        np.testing.assert_array_equal(tc.msgs, jc.msgs)
        assert (tc.rounds_to_target, tc.final_coverage) == \
            (jc.rounds_to_target, jc.final_coverage)
        _assert_same(jc.state, tc.state)
    else:
        want = JP.simulate_until_packed(jp, jt, jr, jf)
        got = P.simulate_until_packed(tp, tt, tr, tf, CPU)
        assert got[:3] == want[:3]
        _assert_same(want[3], got[3])


def test_partition_heal_dense():
    """The reference's stall check: nothing crosses the open cut at 48 of
    64 (push, fanout 2), then full coverage within the bound after the
    window closes; the no-program control crosses early.  The curve
    equals the reference's."""
    n, end = 64, 6
    jp = JC.ProtocolConfig(mode="push", fanout=2)
    tp = TC.ProtocolConfig(mode="push", fanout=2)
    jf, tf = _faults(seed=0, churn=dict(partitions=((0, end, 48),)))
    rk = dict(seed=0, max_rounds=24, target_coverage=1.0)
    res = TS.simulate_curve(tp, G.complete(n), TC.RunConfig(**rk), tf, CPU)
    want = JS.simulate_curve(jp, JG.complete(n), JC.RunConfig(**rk), jf)
    np.testing.assert_array_equal(res.coverage, want.coverage)
    assert all(c <= 48 / n + 1e-6 for c in res.coverage[:end])
    assert res.rounds_to_target != -1 and \
        res.rounds_to_target <= end + 2 * 4 + 4
    free = TS.simulate_curve(tp, G.complete(n), TC.RunConfig(**rk), None,
                             CPU)
    assert any(c > 48 / n for c in free.coverage[:end])


def _first_alive(alive: np.ndarray, count: int, n: int) -> np.ndarray:
    seen = np.zeros((n, 1), bool)
    seen[np.nonzero(alive)[0][:count], 0] = True
    return seen


def _boundary(death: bool):
    """(n, fault pair, eventual alive mask, count, target): a program at
    n = 1000 and a count c of its eventual alive count A at which
    float32(c) * float32(1/A) and float32(c) / float32(A) differ, with
    the target the larger of the two, so that they fall on two sides of
    it."""
    n = 1000
    jf, tf = _faults(node_death_rate=0.1 if death else 0.0, seed=1,
                     churn=dict(events=((3, 1, 4), (7, 2, -1))))
    alive = NE.metric_alive(tf, n, 0, CPU).numpy()
    a = int(alive.sum())
    for c in range(a - 1, 0, -1):
        prod = np.float32(c) * (np.float32(1) / np.float32(a))
        quot = np.float32(c) / np.float32(a)
        if prod != quot:
            return n, jf, tf, alive, c, max(prod, quot), prod < quot
    raise AssertionError("no boundary count found")


@pytest.mark.parametrize("layout", ["bool", "packed"])
@pytest.mark.parametrize("death", [False, True])
def test_stop_test_is_the_compiled_condition(layout, death):
    """At a count on an ulp boundary the port's loop continues exactly
    when the reference's while-loop condition, evaluated under
    ``jax.jit`` with its in-trace eventual alive set, is True: without
    random deaths XLA folds the alive count and multiplies by its
    reciprocal; with them it divides."""
    n, jf, tf, alive, count, target, prod_below = _boundary(death)
    seen = _first_alive(alive, count, n)
    t = jnp.float32(target)
    if layout == "bool":
        cond = jax.jit(lambda s: JSI.coverage(
            s, JNE.metric_alive(jf, n, 0)) < t)(jnp.asarray(seen))
    else:
        cond = jax.jit(lambda s: JB.coverage_packed(
            s, 1, JNE.metric_alive(jf, n, 0)) < t)(
                JB.pack(jnp.asarray(seen)))
    assert bool(cond) == (not prod_below if death else prod_below)
    assert NE.folded_denominator(tf) == (not death)
    tp = TC.ProtocolConfig(mode="pull")
    start = 9
    for max_rounds in (start + 1, start):
        tr = TC.RunConfig(seed=0, max_rounds=max_rounds,
                          target_coverage=float(target))
        if layout == "bool":
            loop, _ = TS.compiled_until(tp, G.complete(n), tr, tf, CPU)
            st = S.state_from_numpy(seen, start, np.zeros(2, np.uint32),
                                    0.0, CPU)
        else:
            loop, _ = P.compiled_until_packed(tp, G.complete(n), tr, tf,
                                              device=CPU)
            st = S.state_from_numpy(np.asarray(JB.pack(jnp.asarray(seen))),
                                    start, np.zeros(2, np.uint32), 0.0, CPU)
        final = loop(st)
        assert final.round == (start + 1 if bool(cond) and max_rounds >
                               start else start)
    # the reports keep the eager quotient
    assert coverage_packed(pack(torch.from_numpy(seen)), 1,
                           torch.from_numpy(alive)) == \
        float(np.float32(count) / np.float32(int(alive.sum())))


# -- the entry points -----------------------------------------------------

@pytest.mark.parametrize("mode,engine,curve,proto", [
    ("pull", "auto", False, {}),
    ("antientropy", "xla", False, {"period": 2, "rumors": 3}),
    ("pushpull", "auto", True, {"fanout": 2}),
    ("push", "xla", False, {}),
])
def test_run_simulation_under_a_program_matches_reference(mode, engine,
                                                          curve, proto):
    n = 3000
    kw = dict(mode=mode, fanout=proto.pop("fanout", 1), **proto)
    jf, tf = _heal(n)
    rk = dict(engine=engine, seed=3, max_rounds=40)
    tk = dict(family="complete", n=n)
    port = run_simulation(TC.ProtocolConfig(**kw), TC.TopologyConfig(**tk),
                          TC.RunConfig(**rk), tf, want_curve=curve,
                          device="cpu")
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(**kw),
                          JC.TopologyConfig(**tk), JC.RunConfig(**rk), jf,
                          want_curve=curve)
    assert (port.rounds, port.coverage, port.msgs, port.curve) == \
        (ref.rounds, ref.coverage, ref.msgs, ref.curve)
    assert port.meta.get("engine") == ref.meta.get("engine")
    assert "engine_auto" not in port.meta
    with pytest.raises(ValueError, match="does not run churn"):
        run_simulation(TC.ProtocolConfig(mode="pull"),
                       TC.TopologyConfig(**tk), TC.RunConfig(engine="fused"),
                       tf, device="cpu")
    with pytest.raises(ValueError, match="one side empty"):
        run_simulation(TC.ProtocolConfig(**kw), TC.TopologyConfig(n=50),
                       TC.RunConfig(**rk), tf, device="cpu")


def test_bench_churn_heal_matches_reference():
    n = 20000
    rounds, cov, msgs, seconds = bench.run_churn_heal(n, "cpu")
    jf, _ = _heal(n)
    want = JP.simulate_until_packed(JC.ProtocolConfig(mode="pull"),
                                    JG.complete(n),
                                    JC.RunConfig(seed=0, max_rounds=128), jf)
    assert (rounds, cov, msgs) == want[:3] and seconds > 0
    k_rounds, k_cov, _, _ = bench.run_churn_heal(n, "cpu", "kernel")
    assert abs(k_rounds - rounds) <= 2 and k_cov >= np.float32(0.99)


CLI_CASES = [
    dict(churn_event=["3:2:5", "7:1"], partition=["0:4:32"],
         drop_ramp="1:4:0.0:0.3"),
    dict(churn_event=None, partition=None, drop_ramp=None),
    dict(churn_event=["1:1:4", "2:2"], partition=["0:6:5000000", "8:9:3"],
         drop_ramp="0:4:0:0.1"),
    dict(churn_event=None, partition=None, drop_ramp="2:6:0.5:0"),
    dict(churn_event=["3"], partition=None, drop_ramp=None),
    dict(churn_event=["3:1:2:4"], partition=None, drop_ramp=None),
    dict(churn_event=None, partition=["0:4"], drop_ramp=None),
    dict(churn_event=None, partition=None, drop_ramp="0:4:0.1"),
    dict(churn_event=["3:5:5"], partition=None, drop_ramp=None),
    dict(churn_event=None, partition=["0:5:8", "4:9:16"], drop_ramp=None),
]


@pytest.mark.parametrize("ns", CLI_CASES)
def test_cli_churn_parse_matches_reference(ns):
    a = argparse.Namespace(**ns)
    try:
        want = j_parse_churn(a)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _parse_churn(a)
        assert str(got.value) == str(e)
        return
    got = _parse_churn(a)
    if want is None:
        assert got is None
    else:
        assert (got.events, got.partitions, got.ramp) == \
            (want.events, want.partitions, want.ramp)


def test_cli_runs_a_program_end_to_end():
    n = 4000
    flags = ["--mode", "pull", "--n", str(n), "--engine", "auto",
             "--drop-prob", "0.02", "--churn-event", "1:1:4",
             "--churn-event", "2:2", "--partition", f"0:6:{n // 2}",
             "--drop-ramp", "0:4:0:0.1", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run([sys.executable, "-m", "gossip_tpu_torch", "run",
                           *flags], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jf, _ = _heal(n)
    ref = jrun_simulation("jax-tpu", JC.ProtocolConfig(mode="pull"),
                          JC.TopologyConfig(n=n), JC.RunConfig(engine="auto"),
                          jf)
    assert (out["rounds"], out["coverage"], out["msgs"]) == \
        (ref.rounds, ref.coverage, ref.msgs)
    assert out["meta"]["engine"] == "bit-packed"
    for bad in (["--partition", "0:4"], ["--churn-event", f"{n}:1"],
                ["--engine", "fused", "--churn-event", "1:1"]):
        args = flags[:4] + (["--engine", "xla"] if "--engine" not in bad
                            else []) + bad + ["--device", "cpu"]
        proc = subprocess.run([sys.executable, "-m", "gossip_tpu_torch",
                               "run", *args], capture_output=True,
                              text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 2 and not proc.stdout, bad
