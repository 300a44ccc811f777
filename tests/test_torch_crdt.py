"""The port's CRDT payloads (gossip_tpu_torch/ops/crdt.py,
gossip_tpu_torch/models/crdt.py and the ``crdt`` command) against the JAX
package's, bitwise (tolerance 0).

Both packages run the same configuration from the same seed, the port on
the CPU and the reference under ``jax.jit``: every state field after
every round (val, round, key, msgs, and under a fault program the
round's ``lost``) must be equal for every kind, without faults, under
static deaths and drops, and under the full fault program (events, a
permanent crash, a partition window, a drop ramp), with the exchange's
blocks forced small; so must the merges on random states, the injection
lowering and its rows, the ground truth, the loops' per-round converged
counts and msgs, the until loop's integer target and the command line
(CR1 at its own size).  The reference's own single-device cases (config
validation, the merge laws, the vector clock, the acked-adds truth, the
set owner rotation, the partition stall and exact heal, the refusals,
the CLI's run and error paths) run on the port too.  The reference runs
live, its executable store off.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (config_pair, fault_pair, forced_blocks,
                              payload_state_equal)
from gossip_tpu import config as JC
from gossip_tpu.models import crdt as JM
from gossip_tpu.ops import crdt as JCR
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import cli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import crdt as M
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
KINDS = ("gcounter", "pncounter", "gset", "orset")
# the reference's full mixed program: crash/recover, permanent crash,
# partition window, drop ramp
FULL = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (7, 1, -1)), partitions=((0, 6, 16),),
    ramp=(1, 4, 0.0, 0.3)))
STATIC = dict(node_death_rate=0.15, drop_prob=0.1, seed=2)


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _cfgs(kind, **kw):
    if kind in ("gset", "orset"):
        kw.setdefault("elements", 40)
        if kind == "orset":
            kw.setdefault("set_removes", ((5, 3), (11, 6)))
    return config_pair("CrdtConfig", kind=kind, **kw)


def _t(a):
    """numpy (uint32 or int32) -> the port's int32 tensor, same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _np(t, like):
    v = t.cpu().numpy()
    return v.view(np.uint32) if np.asarray(like).dtype == np.uint32 else v


# -- config validation -------------------------------------------------

BAD_CONFIGS = [
    (dict(kind="lww"), "unknown CRDT kind"),
    (dict(kind="gcounter", adds=((0, 0, -1),)), "positive"),
    (dict(kind="pncounter", adds=((0, 0, 0),)), "nonzero"),
    (dict(kind="gset", elements=8, set_adds=((8, 0),)), "universe"),
    (dict(kind="gset", set_adds=((0, 0),), set_removes=((0, 1),)),
     "grow-only"),
    (dict(kind="orset", set_adds=((2, 0), (2, 1))), "at most once"),
    (dict(kind="orset", adds=((0, 0, 1),)), "counter adds"),
    (dict(kind="gcounter", set_adds=((0, 0),)), "set_adds"),
    (dict(kind="gcounter", adds=((0, 10 ** 9, 1),)), "horizon cap"),
    (dict(kind="vclock", adds=((0, 0, 5),)), "no injection program"),
    (dict(kind="orset", elements=8, set_adds=((5, 4),),
          set_removes=((5, 2),)), "happen-after"),
    (dict(kind="orset", set_removes=((5, 0),)), "happen-after"),
    (dict(kind="gcounter", elements=0), "elements must be"),
]


@pytest.mark.parametrize("kw,match", BAD_CONFIGS)
def test_crdt_config_refusals_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        TC.CrdtConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JC.CrdtConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_crdt_config_validation():
    TC.CrdtConfig(kind="gcounter", adds=((0, 0, 5), (3, 2, 1)))
    TC.CrdtConfig(kind="pncounter", adds=((0, 0, -5),))
    TC.CrdtConfig(kind="orset", elements=40, set_adds=((0, 0), (39, 2)),
                  set_removes=((0, 3),))
    # a remove of a never-added element is a harmless no-op: allowed
    TC.CrdtConfig(kind="orset", elements=8, set_adds=((1, 0),),
                  set_removes=((5, 0),))
    assert TC.CrdtConfig(kind="gcounter", adds=((0, 7, 1),)).horizon() == 8
    j, t = _cfgs("orset", set_adds=((3, 2), (9, 5)), set_removes=((3, 4),))
    assert t == TC.CrdtConfig(**{f: getattr(j, f) for f in (
        "kind", "adds", "set_adds", "set_removes", "elements")})


# -- the merges --------------------------------------------------------

def _random_state(kind, n, elements, rng):
    if kind in TC.CRDT_SET_KINDS:
        return rng.integers(0, 2 ** 32, size=(n, 2 * ((elements + 31) // 32)),
                            dtype=np.uint32)
    return rng.integers(0, 1000, size=(n, CR.shard_columns(kind, n)),
                        dtype=np.int32)


@pytest.mark.parametrize("kind", TC.CRDT_KINDS)
def test_merge_algebra_bitwise(kind):
    """The join-semilattice laws on random states, and each merge equal
    to the reference's."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        states = [_random_state(kind, 16, 40, rng) for _ in range(3)]
        a, b, c = (_t(s) for s in states)
        ab = CR.merge(kind, a, b)
        assert np.array_equal(_np(ab, states[0]), np.asarray(
            JCR.merge(kind, jnp.asarray(states[0]), jnp.asarray(states[1]))))
        assert torch.equal(ab, CR.merge(kind, b, a))
        assert torch.equal(CR.merge(kind, ab, c),
                           CR.merge(kind, a, CR.merge(kind, b, c)))
        assert torch.equal(CR.merge(kind, a, a), a)
        assert torch.equal(CR.merge(kind, ab, a), ab)


def test_vclock_tick_and_merge():
    n = 4
    vc = torch.zeros((n, n), dtype=torch.int32)
    ids = torch.arange(n)
    alive = torch.tensor([True, True, False, True])
    vc = CR.vclock_tick(vc, ids, alive, n)
    assert vc.diagonal().tolist() == [1, 1, 0, 1]
    other = torch.zeros((n, n), dtype=torch.int32)
    other[:, 2] = 7
    merged = CR.merge(TC.VCLOCK, vc, other)
    assert (merged[:, 2] == 7).all()
    assert merged.diagonal().tolist() == [1, 1, 7, 1]
    # against the reference on random clocks, ids past the width dropped
    rng = np.random.default_rng(3)
    vc0 = rng.integers(0, 50, size=(9, 6), dtype=np.int32)
    gids = rng.integers(0, 9, size=9).astype(np.int32)
    live = rng.random(9) < 0.7
    want = np.asarray(JCR.vclock_tick(jnp.asarray(vc0), jnp.asarray(gids),
                                      jnp.asarray(live), 9))
    got = CR.vclock_tick(_t(vc0), torch.from_numpy(gids),
                         torch.from_numpy(live), 9)
    assert np.array_equal(got.numpy(), want)


# -- injections and ground truth ---------------------------------------

def test_ground_truth_acked_adds_semantics():
    n = 8
    adds = ((0, 0, 10), (1, 2, 20), (2, 0, 30), (3, 5, 40))
    jc, tc = _cfgs("gcounter", adds=adds)
    jf, tf = fault_pair(churn=dict(events=((1, 1, 4), (2, 3, -1),
                                           (3, 1, 4))))
    truth = CR.ground_truth(tc, CR.inject_args(tc, n, CPU), tf, n, 0, CPU)
    assert truth.tolist() == [10, 0, 0, 40, 0, 0, 0, 0]
    assert truth.tolist() == np.asarray(JCR.ground_truth(
        jc, JCR.inject_args(jc, n), jf, n, 0)).tolist()
    truth0 = CR.ground_truth(tc, CR.inject_args(tc, n, CPU), None, n, 0, CPU)
    assert truth0.tolist() == [10, 20, 30, 40, 0, 0, 0, 0]
    d = TC.CrdtConfig(kind="gcounter")
    td = CR.ground_truth(d, CR.inject_args(d, n, CPU), None, n, 0, CPU)
    assert td.tolist() == [1 + j % 7 for j in range(n)]
    with pytest.raises(ValueError, match="node ids"):
        CR.inject_args(TC.CrdtConfig(kind="gcounter", adds=((99, 0, 1),)),
                       n, CPU)


def test_set_injection_owner_rotation_and_tombstones():
    n = 8
    tc = TC.CrdtConfig(kind="orset", elements=40, set_removes=((5, 3),))

    def members(truth):
        return sum(bin(int(x) & 0xFFFFFFFF).count("1")
                   for x in CR.set_members(truth[None, :])[0].tolist())

    truth = CR.ground_truth(tc, CR.inject_args(tc, n, CPU), None, n, 0, CPU)
    assert members(truth) == 39
    _, tf = fault_pair(churn=dict(events=((7, 1, -1),)))
    trc = CR.ground_truth(tc, CR.inject_args(tc, n, CPU), tf, n, 0, CPU)
    assert members(trc) == 40 - 5 - 1
    assert M.truth_scalar(tc, trc, n) == 34


INJECT_CASES = [
    ("gcounter", dict(adds=((0, 0, 5), (3, 2, 7), (3, 2, 1), (9, 4, 2)))),
    ("pncounter", {}),
    ("pncounter", dict(adds=((0, 0, 9), (1, 1, -4), (1, 1, 3), (5, 3, -8)))),
    ("gset", dict(elements=70, set_adds=((0, 0), (33, 1), (69, 3)))),
    ("orset", dict(elements=40, set_removes=((5, 3), (11, 6)))),
]


@pytest.mark.parametrize("kind,kw", INJECT_CASES)
def test_injection_lowering_matches_reference(kind, kw):
    """inject_args, the in-place apply_injections of every round (the
    reference's dense inject_rows merged into a state) and the truth,
    under a program whose churn downs owners at injection rounds, origin
    3."""
    n, origin = 12, 3
    jc, tc = _cfgs(kind, **kw)
    jf, tf = fault_pair(churn=dict(events=((3, 1, 4), (5, 2, -1),
                                           (1, 0, 2))))
    jinj, tinj = JCR.inject_args(jc, n), CR.inject_args(tc, n, CPU)
    assert [np.asarray(x).tolist() for x in jinj] == \
        [x.tolist() for x in tinj]
    jfn = JCR.alive_at_fn(jf, n, origin)
    tfn = CR.alive_at_fn(tf, n, origin, CPU)
    jev = JCR.eventual_alive_crdt(jf, n, origin)
    tev = CR.eventual_alive_crdt(tf, n, origin, CPU)
    assert np.array_equal(tev.numpy(), np.asarray(jev))
    ids = jnp.arange(n, dtype=jnp.int32)
    rng = np.random.default_rng(0)
    val = _random_state(kind, n, tc.elements, rng) // 2
    for r in range(6):
        want = np.asarray(JCR.inject_rows(jc, jinj, ids, r, n, origin, jfn,
                                          jev))
        merged = (val + want) if kind in TC.CRDT_COUNTER_KINDS \
            else (val | want)
        applied = CR.apply_injections(tc, _t(val), tinj, r, n, origin, tfn,
                                      tev)
        assert np.array_equal(_np(applied, merged), merged), r
    want_t = np.asarray(JCR.ground_truth(jc, jinj, jf, n, origin))
    got_t = CR.ground_truth(tc, tinj, tf, n, origin, CPU)
    assert np.array_equal(_np(got_t, want_t), want_t)
    assert M.truth_scalar(tc, got_t, n) == JM.truth_scalar(jc, want_t, n)


@pytest.mark.parametrize("kind", KINDS)
def test_readouts_match_reference(kind):
    """counter_value / set_members, payload_count and converged_count
    (blocked, blocks of 1, 3 and all rows) on random rows with some
    equal to the truth."""
    n = 16
    jc, tc = _cfgs(kind)
    rng = np.random.default_rng(5)
    rows = _random_state(kind, n, 40, rng)
    truth = rows[3].copy()
    rows[[0, 7, 9]] = truth
    alive = rng.random(n) < 0.8
    alive[[0, 9]] = True
    for b in (1, 3, n):
        with forced_blocks(b):
            got = CR.converged_count(_t(rows), _t(truth),
                                     torch.from_numpy(alive))
        assert int(got) == int(JCR.converged_count(
            jnp.asarray(rows), jnp.asarray(truth), jnp.asarray(alive)))
    assert float(CR.payload_count(tc, _t(rows), torch.from_numpy(alive))) \
        == float(JCR.payload_count(jc, jnp.asarray(rows), jnp.asarray(alive)))
    if kind in TC.CRDT_COUNTER_KINDS:
        want = np.asarray(JCR.counter_value(kind, jnp.asarray(rows), n))
        assert np.array_equal(CR.counter_value(kind, _t(rows), n).numpy(),
                              want)
    else:
        want = np.asarray(JCR.set_members(jnp.asarray(rows)))
        assert np.array_equal(_np(CR.set_members(_t(rows)), want), want)


# -- the round, every field, every round -------------------------------

def _topos(n, family="complete"):
    if family == "complete":
        return JG.complete(n), G.complete(n)
    return (JG.erdos_renyi(n, 0.2, seed=2),
            G.erdos_renyi(n, 0.2, seed=2, device=CPU))


def _same_steps(jc, tc, fanout, fault, n, rounds, origin=0, defend=False,
                block_rows=3, family="complete", seed=4):
    """Step both packages' rounds side by side; every field equal after
    every round (and ``lost`` under a program).  Returns the final
    port state."""
    jf, tf = fault
    jt, tt = _topos(n, family)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=fanout)
    run = dict(seed=seed, origin=origin, max_rounds=rounds + 8)
    jstep = jax.jit(JM.make_crdt_round(jc, jp, jt, jf, origin,
                                       defend=defend))
    with forced_blocks(block_rows):
        tstep = M.make_crdt_round(tc, tp, tt, tf, origin, defend=defend,
                                  device=CPU)
    js = JM.init_crdt_state(JC.RunConfig(**run), jc, n)
    ts = M.init_crdt_state(TC.RunConfig(**run), tc, n, CPU)
    churn = tf is not None and tf.churn is not None
    for r in range(rounds):
        jo, to = jstep(js), tstep(ts)
        if churn:
            (js, jl), (ts, tl) = jo, to
            assert np.float32(jl) == np.float32(tl.item()), r
        else:
            js, ts = jo, to
        assert payload_state_equal(js, ts), f"round {r}"
    return ts


ROUND_CASES = [
    (kind, fault, family)
    for kind in KINDS
    for fault, family in ((None, "complete"), (STATIC, "complete"),
                          (FULL, "complete"), (STATIC, "erdos_renyi"))
]


@pytest.mark.parametrize("kind,fault,family", ROUND_CASES)
def test_round_matches_reference(kind, fault, family):
    n = 32
    jc, tc = _cfgs(kind)
    _same_steps(jc, tc, 2, fault_pair(**(fault or {})), n, 12, origin=5,
                family=family)


def test_donated_step_writes_in_place_and_equals():
    """``donate=True`` (the loops' call) gives the same state as a step
    that keeps its input, and a kept input is left untouched."""
    tc = TC.CrdtConfig(kind="gcounter")
    tp = TC.ProtocolConfig(mode="pull", fanout=2)
    step = M.make_crdt_round(tc, tp, G.complete(20), device=CPU)
    s0 = M.init_crdt_state(TC.RunConfig(seed=1), tc, 20, CPU)
    kept = step(s0)
    assert int(s0.val.abs().sum()) == 0
    donated = step(s0, donate=True)
    assert torch.equal(kept.val, donated.val)
    assert int(s0.val.abs().sum()) > 0


@pytest.mark.parametrize("block_rows", [1, 5, 1 << 20])
def test_blocked_exchange_equals_reference(block_rows):
    """Any block size gives the reference's state (max and OR are
    exact), here a PN-counter under the full program."""
    jc, tc = _cfgs("pncounter")
    _same_steps(jc, tc, 3, fault_pair(**FULL), 24, 10,
                block_rows=block_rows)


def test_block_rows_budget():
    assert CR.block_rows_for(65536, 2) == (1 << 28) // (4 * 2 * 65536)
    assert CR.block_rows_for(1 << 30, 3) == 1


# -- the loops ---------------------------------------------------------

def _both_curve(kind, n, fault, max_rounds=24, **cfg):
    jc, tc = _cfgs(kind, **cfg)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jr, tr = config_pair("RunConfig", seed=0, max_rounds=max_rounds,
                         target_coverage=1.0)
    jf, tf = fault
    j = JM.simulate_curve_crdt(jc, jp, JG.complete(n), jr, jf)
    with forced_blocks(7):
        t = M.simulate_curve_crdt(tc, tp, G.complete(n), tr, tf, device=CPU)
    assert np.array_equal(t[0], np.asarray(j[0]))
    assert np.array_equal(t[1], np.asarray(j[1]))
    assert payload_state_equal(j[2], t[2])
    assert t[3] == j[3]
    return t


def test_partition_stall_and_exact_heal():
    """While the window is open nobody holds the global truth and each
    side saturates its own split; after it closes every node reaches the
    exact truth within the reference's bound."""
    n, cut, end = 64, 48, 8
    fault = fault_pair(seed=0, churn=dict(partitions=((0, end, cut),)))
    conv, _, final, truth_val = _both_curve("gcounter", n, fault)
    assert all(c == 0.0 for c in conv[:end])
    tc = TC.CrdtConfig(kind="gcounter")
    truth = CR.ground_truth(tc, CR.inject_args(tc, n, CPU), fault[1], n, 0,
                            CPU)
    lo, hi = int(truth[:cut].sum()), int(truth[cut:].sum())
    _, _, mid, _ = _both_curve("gcounter", n, fault, max_rounds=end - 1)
    vals = mid.val.sum(dim=1)
    assert (vals[:cut] <= lo).all() and (vals[cut:] <= hi).all()
    assert int(vals[:cut].max()) == lo
    hit = np.nonzero(conv >= 1.0)[0]
    leg = math.ceil(math.log(n) / math.log(3))
    assert len(hit) and int(hit[0]) + 1 <= end + 2 * leg + 4
    assert (final.val == truth[None, :]).all()
    assert truth_val == lo + hi


@pytest.mark.parametrize("kind", KINDS)
def test_heal_under_full_fault_program(kind):
    conv, _, _, _ = _both_curve(kind, 32, fault_pair(**FULL))
    assert conv[-1] == 1.0


@pytest.mark.parametrize("kind,fault", [("gcounter", FULL),
                                        ("orset", FULL),
                                        ("gset", STATIC)])
def test_until_driver_integer_target(kind, fault):
    jc, tc = _cfgs(kind)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jr, tr = config_pair("RunConfig", seed=0, max_rounds=24,
                         target_coverage=1.0)
    jf, tf = fault_pair(**fault)
    j = JM.simulate_until_crdt(jc, jp, JG.complete(32), jr, jf)
    t = M.simulate_until_crdt(tc, tp, G.complete(32), tr, tf, device=CPU)
    assert t[:3] == j[:3] and t[4] == j[4]
    assert payload_state_equal(j[3], t[3])
    if fault is FULL:
        assert t[1] == 1.0 and t[0] < 24


@pytest.mark.parametrize("loop", ["until", "curve"])
def test_loops_hold_two_states(loop):
    """A loop's round holds the state and its successor only (a third
    buffer is 17 GB for a G-counter at n = 65,536): every earlier state,
    the first one included, is released."""
    import weakref
    tc = TC.CrdtConfig(kind="gcounter")
    step = M.make_crdt_round(tc, TC.ProtocolConfig(mode="pull", fanout=2),
                             G.complete(64), device=CPU)
    vals, most = [], [0]

    def counted(state, donate=False):
        vals.append(weakref.ref(state.val))
        out = step(state, donate=donate)
        vals.append(weakref.ref(out.val))
        most[0] = max(most[0], len({id(v()) for v in vals
                                    if v() is not None}))
        return out

    def init():
        return M.init_crdt_state(TC.RunConfig(), tc, 64, CPU)

    truth = CR.ground_truth(tc, CR.inject_args(tc, 64, CPU), None, 64, 0,
                            CPU)
    alive = torch.ones(64, dtype=torch.bool)
    if loop == "until":
        state, count = M.run_until(counted, init, truth, alive, 64, 30)
        assert count == 64
    else:
        *_, state = M.run_curve(counted, init, truth, alive, 12)
    assert most[0] == 2


def test_conv_target_count_matches_reference():
    for total in (1, 7, 31, 4096, 65536, 99991):
        for target in (0.5, 0.9, 0.99, 0.999, 1.0, 1 / 3):
            jr, tr = config_pair("RunConfig", target_coverage=target)
            assert M._conv_target_count(tr, total) == \
                JM._conv_target_count(jr, total)


# -- refusals ----------------------------------------------------------

def test_crdt_rejections_are_loud():
    pull = TC.ProtocolConfig(mode="pull")
    with pytest.raises(ValueError, match="pull exchange only"):
        M.make_crdt_round(TC.CrdtConfig(), TC.ProtocolConfig(mode="push"),
                          G.complete(8), device=CPU)
    with pytest.raises(ValueError, match="no exchange driver"):
        M.make_crdt_round(TC.CrdtConfig(kind="vclock"), pull,
                          G.complete(8), device=CPU)
    with pytest.raises(ValueError, match="can never fire"):
        M.simulate_until_crdt(
            TC.CrdtConfig(kind="gcounter", adds=((0, 100, 5),)), pull,
            G.complete(8), TC.RunConfig(seed=0, max_rounds=8), device=CPU)
    with pytest.raises(ValueError, match="vclock_tick, not injections"):
        CR.apply_injections(TC.CrdtConfig(kind="vclock"),
                            torch.zeros((4, 4), dtype=torch.int32), (), 0, 4,
                            0, None, None)


# -- the command line --------------------------------------------------

def _ref_cli(capsys, args):
    from gossip_tpu import cli as jcli
    capsys.readouterr()
    rc = jcli.main(args + ["--no-compile-cache"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_cli(capsys, args):
    capsys.readouterr()
    rc = cli.main(args + ["--device", "cpu"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


SAME = ("mode", "type", "n", "rounds", "value_conv", "converged",
        "truth_value", "msgs", "devices")


@pytest.mark.parametrize("args", [
    ["crdt", "--type", "gcounter", "--n", "32", "--max-rounds", "24",
     "--partition", "0:4:16", "--churn-event", "3:2:5", "--drop-ramp",
     "1:3:0.0:0.2"],
    ["crdt", "--type", "pncounter", "--n", "16", "--add", "0:0:9",
     "--add", "1:1:-4", "--curve", "--max-rounds", "12"],
    ["crdt", "--type", "orset", "--n", "40", "--elements", "70",
     "--set-remove", "5:3", "--set-add", "5:1", "--set-add", "66:0",
     "--drop", "0.1", "--death", "0.1", "--origin", "7"],
])
def test_cli_crdt_run_matches_reference(capsys, args, tmp_path):
    rc, ref = _ref_cli(capsys, args)
    rc2, out = _port_cli(capsys, args)
    assert rc == rc2 == 0
    assert {k: out[k] for k in SAME} == {k: ref[k] for k in SAME}
    assert list(out)[:len(ref)] == list(ref)
    assert out["backend"] == "torch-cpu" and out["compile_cache"] is None
    for key in ("fault_program", "curve"):
        assert out.get(key) == ref.get(key)
    # --save-curve: the reference's JSONL, row for row
    paths = [tmp_path / "ref.jsonl", tmp_path / "port.jsonl"]
    _ref_cli(capsys, args + ["--save-curve", str(paths[0])])
    _port_cli(capsys, args + ["--save-curve", str(paths[1])])
    ref_rows, rows = ([json.loads(x) for x in p.read_text().splitlines()]
                      for p in paths)
    assert rows[1:] == ref_rows[1:] and len(rows) > 1
    assert {k: rows[0]["meta"][k] for k in SAME} == \
        {k: ref_rows[0]["meta"][k] for k in SAME}


def test_cli_crdt_error_paths(capsys):
    assert cli.main(["crdt", "--type", "gcounter", "--add", "0:0:-1",
                     "--device", "cpu"]) == 2
    assert "positive" in capsys.readouterr().err
    assert cli.main(["crdt", "--add", "0:0", "--device", "cpu"]) == 2
    assert "3 colon-separated" in capsys.readouterr().err
    capsys.readouterr()
    assert cli.main(["crdt", "--n", "64", "--devices", "2", "--device",
                     "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["engine"] == "crdt-sharded"
    with pytest.raises(SystemExit):
        cli.main(["crdt", "--type", "vclock", "--device", "cpu"])
    # the build-cache flags name the kernels' library store
    for flag, want in ((["--no-compile-cache"], None),
                       (["--compile-cache", "d"], "d")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_kernels, "_STORE", {"dir": None, "fresh": False})
            mp.setenv(_kernels.CACHE_ENV, "")
            assert cli.main(["crdt", "--n", "32", "--device", "cpu"]
                            + flag) == 0
        assert json.loads(capsys.readouterr().out)["compile_cache"] == want


def test_cr1_command_line_matches_reference(capsys):
    """CR1 (docs/WORKLOADS.md's gcounter heal under the full program) at
    its own size, n = 4096, with its curve."""
    args = ["crdt", "--type", "gcounter", "--n", "4096", "--partition",
            "0:6:2048", "--churn-event", "3:2:5", "--drop-ramp",
            "1:4:0.0:0.3", "--curve"]
    rc, ref = _ref_cli(capsys, args)
    rc2, out = _port_cli(capsys, args)
    assert rc == rc2 == 0
    assert (out["rounds"], out["value_conv"], out["truth_value"],
            out["msgs"]) == (24, 1.0, 16381, 705870.0)
    assert out["curve"] == ref["curve"]
    assert {k: out[k] for k in SAME} == {k: ref[k] for k in SAME}
