"""The port's LWW registers and txn workload (gossip_tpu_torch/ops/
registers.py, gossip_tpu_torch/models/register.py, the ``txn`` command
and the backend's txn workload) against the JAX package's, bitwise
(tolerance 0).

Both packages run the same configuration from the same seed, the port on
the CPU and the reference under ``jax.jit``: every state field after
every round (and ``lost`` under a fault program) must be equal, without
faults, under static deaths and drops, under the full fault program and
under each liar kind, defended and undefended (``inflate`` past int32
among them), with the exchange's blocks forced small; so must the
skewed traffic generator on a grid of its knobs, the write lowering, the
in-place injection against the reference's dense rows joined by
``merge_lww`` (an inflated timestamp planted before a write included),
the LWW join on random states and its ``out=`` form, the liar transforms
and both admissions on adversarial rows, the ground truth and its
summary, the honest-key mask, the loops' per-round converged counts and
msgs, the until loop's integer target, ``run_simulation``'s txn workload
and the command lines (TX2, TX3, TX4, TXB1d/u, TXB2d, TXB3u at their
own size).  The reference's own single-device cases (config validation,
the skewed program, the join's laws, the owner-order tie, the
acked-writes truth, the partition stall and exact heal, defended exact
where the undefended control diverges, the refusals, the CLI's run and
error paths) run on the port too.  The reference runs live, its
executable store off.
"""

import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (config_pair, fault_pair, forced_blocks,
                              payload_state_equal)
from gossip_tpu import config as JC
from gossip_tpu.models import register as JM
from gossip_tpu.ops import nemesis as JNE
from gossip_tpu.ops import registers as JRG
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import cli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import register as M
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops import registers as RG
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
# the reference's full mixed program: crash/recover, permanent crash,
# partition window, drop ramp
FULL = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (7, 1, -1)), partitions=((0, 6, 16),),
    ramp=(1, 4, 0.0, 0.3)))
STATIC = dict(node_death_rate=0.15, drop_prob=0.1, seed=2)
SKEWED = dict(keys=8, txns=24, zipf_alpha=1.2, hot_key=0.3)
# one liar of each kind; inflate's arg wraps int32 at n = 16
LIARS = {"corrupt": (11, 0, "corrupt", 1 << 20),
         "replay": (9, 0, "replay", 0),
         "equivocate": (7, 1, "equivocate", 0),
         "inflate": (3, 2, "inflate", 200_000_000)}


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


# -- config validation -------------------------------------------------

BAD_CONFIGS = [
    (dict(keys=0), "keys must be"),
    (dict(txns=0), "txns must be"),
    (dict(writes=((0, 0, 0, 0),)), "values must be >= 1"),
    (dict(keys=2, writes=((0, 5, 0, 1),)), "outside"),
    (dict(writes=((0, 0, 10 ** 9, 1),)), "horizon cap"),
    (dict(writes=((0, 0, 1, 5), (0, 0, 1, 6))), "duplicate"),
    (dict(zipf_alpha=0.0), "zipf_alpha"),
    (dict(hot_key=1.5), "hot_key"),
    (dict(load="lunar"), "unknown load"),
    (dict(spread_rounds=0), "spread_rounds"),
    (dict(writes=((-1, 0, 0, 1),)), "write node"),
    (dict(writes=((0, 0, 1),)), "must be"),
]


@pytest.mark.parametrize("kw,match", BAD_CONFIGS)
def test_txn_config_refusals_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        TC.TxnConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JC.TxnConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_txn_config_validation():
    TC.TxnConfig(keys=2, writes=((0, 0, 0, 5), (1, 0, 2, 7), (2, 1, 0, 1)))
    assert TC.TxnConfig(writes=((0, 0, 7, 1),)).horizon() == 8
    assert TC.TxnConfig(spread_rounds=6).horizon() == 6
    assert TC.TXN_LOADS == JC.TXN_LOADS
    assert dataclass_fields(TC.TxnConfig) == dataclass_fields(JC.TxnConfig)


def dataclass_fields(cls):
    import dataclasses
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


# -- the skewed traffic generator --------------------------------------

GRID = [dict(txns=t, keys=k, zipf_alpha=a, hot_key=h, load=ld,
             spread_rounds=s)
        for t, k, a, h, ld, s in (
            (16, 8, 1.1, 0.0, "uniform", 8), (200, 8, 1.5, 0.0, "uniform", 8),
            (200, 8, 1.5, 1.0, "uniform", 8),
            (200, 8, 1.1, 0.0, "diurnal", 10),
            (97, 5, 0.7, 0.4, "diurnal", 7), (32, 2, 1.0, 1.0, "uniform", 8),
            (64, 16, 2.5, 0.5, "diurnal", 1), (33, 1, 1.1, 0.2, "diurnal", 3),
            (1, 3, 0.3, 0.9, "uniform", 2),
            (500, 12, 1.4, 0.5, "diurnal", 40))]


@pytest.mark.parametrize("kw", GRID)
@pytest.mark.parametrize("n", [4, 64, 1024])
def test_txn_writes_match_reference(kw, n):
    """The closed-form program, statement for statement: the same list,
    or the same pigeonhole refusal, word for word."""
    jc, tc = config_pair("TxnConfig", **kw)
    try:
        want = JRG.txn_writes(jc, n)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            RG.txn_writes(tc, n)
        assert str(mine.value) == str(e) and "lower --txns" in str(e)
        return
    assert RG.txn_writes(tc, n) == want
    for i in range(0, kw["txns"], 7):
        for salt in (0, 1, 2):
            assert RG._hash01(i, salt) == JRG._hash01(i, salt)
    for q in (0.0, 0.013, 0.5, 0.77, 0.9999):
        assert RG._load_round(q, kw["load"], kw["spread_rounds"]) == \
            JRG._load_round(q, kw["load"], kw["spread_rounds"])
        assert RG._zipf_key(q, kw["keys"], kw["zipf_alpha"]) == \
            JRG._zipf_key(q, kw["keys"], kw["zipf_alpha"])


def test_skewed_default_program_is_closed_form_and_skewed():
    """The reference's pins on the port: deterministic, the zipf head
    above its tail, the storm window on key 0, the diurnal peak, the
    collision-free writers and the pigeonhole refusal."""
    n = 64
    cfg = TC.TxnConfig(keys=8, txns=200, zipf_alpha=1.5)
    ws = RG.txn_writes(cfg, n)
    assert ws == RG.txn_writes(cfg, n)
    counts = [0] * 8
    for _, k, _, _ in ws:
        counts[k] += 1
    assert counts[0] > counts[4]
    hws = RG.txn_writes(TC.TxnConfig(keys=8, txns=200, zipf_alpha=1.5,
                                     hot_key=1.0), n)
    mid = [k for i, (_, k, _, _) in enumerate(hws) if 66 <= i < 133]
    assert mid and all(k == 0 for k in mid)
    di = TC.TxnConfig(keys=8, txns=200, load="diurnal", spread_rounds=10)
    rounds = [r for _, _, r, _ in RG.txn_writes(di, n)]
    assert sum(3 <= r <= 6 for r in rounds) > \
        sum(r <= 1 or r >= 8 for r in rounds)
    RG.inject_args(di, n, CPU)
    RG.inject_args(TC.TxnConfig(keys=2, txns=32, hot_key=1.0), 4, CPU)
    with pytest.raises(ValueError, match="lower --txns"):
        RG.txn_writes(TC.TxnConfig(keys=1, txns=32, spread_rounds=1), 4)


# -- the LWW join ------------------------------------------------------

def _rand_rows(rng, shape, keys, lo=0, hi=40):
    """Register rows with arbitrary planes: equal timestamps with
    different values are common at this range."""
    vals = rng.integers(lo, hi + 10, size=shape + (keys,)).astype(np.int32)
    ts = rng.integers(lo, hi, size=shape + (keys,)).astype(np.int32)
    return np.concatenate([vals, ts], axis=-1)


@pytest.mark.parametrize("lo,hi", [(0, 40), (-2 ** 31, 2 ** 31 - 1), (-3, 3)])
def test_lww_merge_algebra_bitwise(lo, hi):
    """Commutative, associative, idempotent, an upper bound, absorbing,
    and equal to the reference's join, on random states (ties and int32
    extremes included)."""
    rng = np.random.default_rng(7)
    for _ in range(10):
        a, b, c = (_rand_rows(rng, (6,), 4, lo, hi) for _ in range(3))
        ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
        ab = RG.merge_lww(ta, tb)
        assert np.array_equal(ab.numpy(),
                              np.asarray(JRG.merge_lww(jnp.asarray(a),
                                                       jnp.asarray(b))))
        assert torch.equal(ab, RG.merge_lww(tb, ta))
        assert torch.equal(RG.merge_lww(ab, tc),
                           RG.merge_lww(ta, RG.merge_lww(tb, tc)))
        assert torch.equal(RG.merge_lww(ta, ta), ta)
        assert (ab[:, 4:] >= ta[:, 4:]).all()
        assert torch.equal(RG.merge_lww(ab, ta), ab)


def test_lww_merge_out_aliases():
    """``out=`` may be either operand or a slice of a larger buffer (the
    block loop writes ``new[a:b]``): the value choice is made before the
    timestamps are written."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(_rand_rows(rng, (9,), 5, -3, 3))
            for _ in range(2))
    want = RG.merge_lww(a, b)
    for into in ("a", "b"):
        x, y = a.clone(), b.clone()
        out = x if into == "a" else y
        assert RG.merge_lww(x, y, out=out) is out
        assert torch.equal(out, want)
    big = torch.full((20, 10), 77, dtype=torch.int32)
    RG.merge_lww(a, b, out=big[4:13])
    assert torch.equal(big[4:13], want)
    assert (big[:4] == 77).all() and (big[13:] == 77).all()


def test_pull_merge_reg_matches_reference():
    n = 30
    rng = np.random.default_rng(2)
    rows = _rand_rows(rng, (n,), 3)
    partners = rng.integers(0, n + 1, size=(n, 3))
    serve = rng.random(n) < 0.8
    want = np.asarray(JRG.pull_merge_reg(
        jnp.where(jnp.asarray(serve)[:, None], jnp.asarray(rows), 0),
        jnp.asarray(partners.astype(np.int32)), n))
    got = RG.pull_merge_reg(torch.from_numpy(rows),
                            torch.from_numpy(partners), n,
                            serve=torch.from_numpy(serve))
    assert np.array_equal(got.numpy(), want)


# -- lowering, truth and the in-place injection ------------------------

def test_tie_break_at_equal_round_is_owner_order():
    """Two writes to one key at the same round: the higher owner wins,
    on the truth and on a whole trajectory; a later round beats any
    owner (the reference's pin, TX4's shape)."""
    n = 16
    cfg = TC.TxnConfig(keys=2, writes=((3, 0, 1, 9), (5, 0, 1, 7),
                                       (1, 1, 0, 4)))
    truth = RG.ground_truth(cfg, RG.inject_args(cfg, n, CPU), None, n, 0)
    assert int(truth[0]) == 7
    assert RG.truth_summary(cfg, truth, n)["ts_owner"][0] == 5
    conv, _, final, ts = M.simulate_curve_txn(
        cfg, TC.ProtocolConfig(mode="pull", fanout=2), G.complete(n),
        TC.RunConfig(seed=0, max_rounds=12, target_coverage=1.0),
        device=CPU)
    assert conv[-1] == 1.0 and ts["values"][0] == 7
    assert ts["ts_owner"][0] == 5
    cfg2 = TC.TxnConfig(keys=2, writes=((15, 0, 1, 9), (0, 0, 2, 7)))
    assert int(RG.ground_truth(cfg2, RG.inject_args(cfg2, n, CPU), None, n,
                               0)[0]) == 7


def test_ground_truth_acked_write_semantics():
    n = 8
    cfg = TC.TxnConfig(keys=2, writes=((0, 0, 0, 10), (7, 0, 3, 20),
                                       (1, 0, 2, 30), (2, 1, 1, 40)))
    _, f = fault_pair(churn=dict(events=((7, 1, -1), (1, 1, 4))))
    inj = RG.inject_args(cfg, n, CPU)
    truth = RG.ground_truth(cfg, inj, f, n, 0)
    assert truth[:2].tolist() == [10, 40]
    assert int(RG.ground_truth(cfg, inj, None, n, 0)[0]) == 20
    with pytest.raises(ValueError, match="node ids"):
        RG.inject_args(TC.TxnConfig(writes=((99, 0, 0, 1),)), n, CPU)
    with pytest.raises(ValueError, match="overflows int32") as mine:
        RG.check_ts_packable(TC.TxnConfig(writes=((0, 0, 90_000, 1),)),
                             50_000)
    with pytest.raises(ValueError) as ref:
        JRG.check_ts_packable(JC.TxnConfig(writes=((0, 0, 90_000, 1),)),
                              50_000)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    {}, SKEWED, dict(keys=3, txns=40, load="diurnal", spread_rounds=6),
    dict(keys=2, writes=((3, 0, 1, 9), (5, 0, 1, 7), (1, 1, 0, 4),
                         (7, 1, 3, 2), (6, 0, 2, 5)))])
def test_injection_lowering_matches_reference(kw):
    """inject_args, the in-place injection of every round against the
    reference's dense rows joined into the same state, the truth and its
    summary, under a program that downs writers at their rounds."""
    n, origin = 10, 2
    jc, tc = config_pair("TxnConfig", **kw)
    jf, tf = fault_pair(churn=dict(events=((7, 1, -1), (1, 1, 4),
                                           (6, 2, 3))))
    jinj, tinj = JRG.inject_args(jc, n), RG.inject_args(tc, n, CPU)
    assert [np.asarray(x).tolist() for x in jinj] == \
        [x.tolist() for x in tinj]
    ids = jnp.arange(n, dtype=jnp.int32)
    rng = np.random.default_rng(1)
    val = _rand_rows(rng, (n,), tc.keys, 0, 60)
    for r in range(tc.horizon() + 1):
        want = JRG.merge_lww(jnp.asarray(val), JRG.inject_rows(
            jc, jinj, ids, r, n, origin, jf))
        got = RG.apply_injections(tc, torch.from_numpy(val.copy()), tinj, r,
                                  n, origin, tf)
        assert np.array_equal(got.numpy(), np.asarray(want)), r
    want_t = np.asarray(JRG.ground_truth(jc, jinj, jf, n, origin))
    got_t = RG.ground_truth(tc, tinj, tf, n, origin)
    assert np.array_equal(got_t.numpy(), want_t)
    assert RG.truth_summary(tc, got_t, n) == \
        JRG.truth_summary(jc, want_t, n)
    assert RG.injection_rounds(tinj[2]) == frozenset(
        r for _, _, r, _ in RG.txn_writes(tc, n))


def test_injection_is_a_join_not_an_overwrite():
    """A timestamp inflated by an undefended liar before the write round
    stays over the new write, and at an equal timestamp the larger value
    wins: as the reference's ``merge_lww(state, inject_rows)``."""
    n = 16
    writes = ((3, 0, 2, 9), (5, 1, 2, 7), (6, 1, 2, 4))
    jc, tc = config_pair("TxnConfig", keys=2, writes=writes)
    jinj, tinj = JRG.inject_args(jc, n), RG.inject_args(tc, n, CPU)
    val = np.zeros((n, 4), np.int32)
    val[3] = [44, 0, 2 * n + 3 + 1 + 5 * n, 0]       # forged, later round
    val[5] = [0, 3, 0, 2 * n + 5 + 1]                # the write's own ts
    val[6] = [0, 8, 0, 2 * n + 6 + 1]                # same ts, larger value
    val[0] = [0, 0, -2 ** 31, -5]                    # below the zero row
    want = np.asarray(JRG.merge_lww(jnp.asarray(val), JRG.inject_rows(
        jc, jinj, jnp.arange(n, dtype=jnp.int32), 2, n, 0, None)))
    got = RG.apply_injections(tc, torch.from_numpy(val.copy()), tinj, 2, n,
                              0, None).numpy()
    assert np.array_equal(got[1:], want[1:])
    assert got[3].tolist() == [44, 0, 2 * n + 4 + 5 * n, 0]
    assert got[5].tolist() == [0, 7, 0, 2 * n + 6]
    assert got[6].tolist() == [0, 8, 0, 2 * n + 7]
    # a row no write touches is left as it is (reachable rows are never
    # below the zero row, which the reference's dense join would lift)
    assert got[0].tolist() == val[0].tolist()


# -- the liar transforms and admissions on adversarial rows ------------

def test_claimed_owner_and_round_floor_as_jnp():
    rng = np.random.default_rng(5)
    t = np.concatenate([rng.integers(-2 ** 31 + 1, 2 ** 31, size=400),
                        [1, 0, -1, 2 ** 31 - 1, -2 ** 31 + 1, 17, 16]]
                       ).astype(np.int32)
    for n in (16, 70_000, 3):
        owner, rnd = RG._claimed(torch.from_numpy(t), n)
        tj = jnp.asarray(t) - 1
        assert np.array_equal(owner.numpy(), np.asarray(tj % n))
        assert np.array_equal(rnd.numpy(), np.asarray(tj // n))


def _adversarial(n, nl, k, keys, rng):
    """(got, safe, active, gids): int32 extremes, timestamps claimed by
    the liars themselves and by others, partners mostly liars,
    receivers with large ids."""
    got = rng.integers(-2 ** 31, 2 ** 31, size=(nl, k, 2 * keys),
                       dtype=np.int64).astype(np.int32)
    liar_ids = np.array([3, 11, 7, 9, 20, 5])
    safe = rng.choice(np.concatenate([liar_ids, rng.integers(0, n, 4)]),
                      size=(nl, k)).astype(np.int32)
    own = safe[:, :, None] + 1 + n * rng.integers(0, 50, size=(nl, k, keys))
    got[..., keys:] = np.where(rng.random((nl, k, keys)) < 0.4, own,
                               got[..., keys:])
    got[0, :, keys:] = 2 ** 31 - 1
    got[1, :, keys:] = -2 ** 31
    got[2, :, keys:] = 0
    active = rng.random((nl, k)) < 0.8
    gids = rng.integers(n - 5000, n, size=nl).astype(np.int32)
    return got, safe, active, gids


LIAR_ARGS = ((3, 0, "inflate", 2 ** 31 - 1), (11, 0, "corrupt", 2 ** 31 - 1),
             (7, 0, "equivocate", 5), (9, 0, "replay", 0),
             (20, 0, "equivocate", 977), (5, 0, "inflate", 200_000_000))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_liar_transforms_match_reference(seed):
    n = 70_000
    rng = np.random.default_rng(seed)
    got, safe, active, gids = _adversarial(n, 16, 3, 5, rng)
    jf, tf = fault_pair(byz=dict(liars=LIAR_ARGS))
    want = np.asarray(JRG._byz_serve_reg(
        jnp.asarray(got), jnp.asarray(safe), jnp.asarray(active),
        jnp.asarray(gids), JNE.build_byz(jf, n), n))
    mine = RG._byz_serve_reg(
        torch.from_numpy(got), torch.from_numpy(safe).long(),
        torch.from_numpy(active), torch.from_numpy(gids),
        NE.build_byz(tf, n, device=CPU), n)
    assert np.array_equal(mine.numpy(), want)


@pytest.mark.parametrize("defend", [False, True])
@pytest.mark.parametrize("r", [0, 3, 40])
def test_byz_exchange_matches_reference(defend, r):
    """pull_merge_reg_byz on adversarial rows and partners (sentinels,
    liars down at the round), both arms, against the reference's on the
    masked rows."""
    n, k, keys, origin = 24, 3, 4, 2
    jf, tf = fault_pair(churn=dict(events=((7, 2, 6),)),
                        byz=dict(liars=((3, 0, "inflate", 2 ** 30),
                                        (11, 1, "corrupt", 12345),
                                        (7, 0, "equivocate", 0),
                                        (9, 0, "replay", 0),
                                        (14, 9, "inflate", 3))))
    rng = np.random.default_rng(r)
    rows = rng.integers(-2 ** 31, 2 ** 31, size=(n, 2 * keys),
                        dtype=np.int64).astype(np.int32)
    claim = (rng.integers(0, n, size=(n, keys)) + 1
             + n * rng.integers(0, 8, size=(n, keys)))
    rows[:, keys:] = np.where(rng.random((n, keys)) < 0.6, claim,
                              rows[:, keys:])
    partners = rng.choice([3, 11, 7, 9, 14, 0, 1, 5, n], size=(n, k))
    serve = np.array(JRG.alive_at_fn(jf, n, origin)(jnp.arange(n), r))
    want = np.asarray(JRG.pull_merge_reg_byz(
        jnp.where(jnp.asarray(serve)[:, None], jnp.asarray(rows), 0),
        jnp.asarray(partners.astype(np.int32)), n,
        byz=JNE.build_byz(jf, n), round_=r,
        gids=jnp.arange(n, dtype=jnp.int32), n=n,
        alive_fn=JRG.alive_at_fn(jf, n, origin), defend=defend))
    mine = RG.pull_merge_reg_byz(
        torch.from_numpy(rows), torch.from_numpy(partners), n,
        byz=NE.build_byz(tf, n, device=CPU), round_=r, gids=torch.arange(n),
        n=n, alive_fn=RG.alive_at_fn(tf, n, origin, CPU), defend=defend,
        serve=torch.from_numpy(serve))
    assert np.array_equal(mine.numpy(), want)


# -- the round, every field, every round -------------------------------

def _same_steps(cfg, fanout, fault, n, rounds, origin=0, defend=False,
                block_rows=3, seed=4):
    """Step both packages' rounds side by side; every field equal after
    every round (and ``lost`` under a program)."""
    jc, tc = config_pair("TxnConfig", **cfg)
    jf, tf = fault
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=fanout)
    run = dict(seed=seed, origin=origin, max_rounds=rounds + 8)
    jstep = jax.jit(JM.make_register_round(jc, jp, JG.complete(n), jf,
                                           origin, defend=defend))
    with forced_blocks(block_rows):
        tstep = M.make_register_round(tc, tp, G.complete(n), tf, origin,
                                      defend=defend, device=CPU)
    js = JM.init_reg_state(JC.RunConfig(**run), jc, n)
    ts = M.init_reg_state(TC.RunConfig(**run), tc, n, CPU)
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


@pytest.mark.parametrize("cfg,fault,block_rows", [
    ({}, None, 3), (SKEWED, STATIC, 5), (SKEWED, FULL, 1),
    (dict(keys=3, txns=30, load="diurnal"), FULL, 1 << 20)])
def test_round_matches_reference(cfg, fault, block_rows):
    _same_steps(cfg, 2, fault_pair(**(fault or {})), 32, 12, origin=3,
                block_rows=block_rows)


def test_round_matches_reference_tx2_program():
    """TX2's program (a cut at n/2 for rounds [0, 8), an event, a ramp)
    at n = 64, both packages' every field for 24 rounds."""
    _same_steps({}, 2, fault_pair(churn=dict(
        events=((3, 2, 5),), partitions=((0, 8, 32),),
        ramp=(1, 4, 0.0, 0.3))), 64, 24, block_rows=7)


@pytest.mark.parametrize("kind", list(LIARS))
@pytest.mark.parametrize("defend", [False, True])
def test_byz_round_matches_reference(kind, defend):
    """Each liar kind, defended and undefended, under an event, fanout 3
    (TXB's deployment), every field of every round."""
    fault = fault_pair(drop_prob=0.05, seed=1,
                       churn=dict(events=((4, 6, 12),)),
                       byz=dict(liars=(LIARS[kind],)))
    _same_steps(dict(keys=6), 3, fault, 16, 24, defend=defend,
                block_rows=5, seed=0)


def test_byz_round_all_kinds_matches_reference():
    fault = fault_pair(churn=dict(events=((4, 6, 12),)),
                       byz=dict(liars=tuple(LIARS.values())))
    for defend in (False, True):
        _same_steps(dict(keys=6, txns=20), 3, fault, 16, 30, defend=defend,
                    block_rows=4, seed=0)


def test_port_step_from_reference_state():
    """The state is ``int32[N, 2K]`` in both packages: a port step taken
    from the reference's state at round 5 gives the reference's round
    6."""
    jc, tc = config_pair("TxnConfig", **SKEWED)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jf, tf = fault_pair(**FULL)
    jstep = jax.jit(JM.make_register_round(jc, jp, JG.complete(32), jf))
    tstep = M.make_register_round(tc, tp, G.complete(32), tf, device=CPU)
    js = JM.init_reg_state(JC.RunConfig(seed=2), jc, 32)
    for _ in range(5):
        js, _ = jstep(js)
    ts = M.RegState(val=torch.from_numpy(np.asarray(js.val).copy()),
                    round=int(js.round),
                    base_key=torch.from_numpy(np.asarray(
                        jax.random.key_data(js.base_key)).astype(np.int64)),
                    msgs=torch.tensor(float(js.msgs), dtype=torch.float32))
    assert np.array_equal(threefry.key_to_words(ts.base_key),
                          np.asarray(jax.random.key_data(js.base_key)))
    (js, _), (ts, _) = jstep(js), tstep(ts)
    assert payload_state_equal(js, ts)


@pytest.mark.parametrize("byz", [False, True])
def test_blocked_exchange_equals_unblocked(byz):
    """The round's own exchange (``step.exchange``) gives the same rows
    for blocks of 1, 3 and 7 rows as for one block."""
    n, r = 40, 3
    tc = TC.TxnConfig(**SKEWED)
    tf = TC.FaultConfig(churn=TC.ChurnConfig(events=((3, 2, 5),)),
                        byz=TC.ByzConfig(liars=(LIARS["inflate"],
                                                LIARS["corrupt"]))
                        if byz else None)
    rng = np.random.default_rng(0)
    val = torch.from_numpy(_rand_rows(rng, (n,), 8, 0, 300))
    partners = torch.from_numpy(rng.integers(0, n + 1, size=(n, 3)))
    alive = torch.from_numpy(rng.random(n) < 0.8)
    outs = []
    for rows in (1, 3, 7, 1 << 20):
        with forced_blocks(rows):
            step = M.make_register_round(
                tc, TC.ProtocolConfig(mode="pull", fanout=3), G.complete(n),
                tf, defend=byz, device=CPU)
        outs.append(step.exchange(val, partners, r, alive))
    assert all(torch.equal(o, outs[-1]) for o in outs)


# -- the loops ---------------------------------------------------------

def _both_curve(cfg, n, fault, max_rounds=24, defend=False, fanout=2,
                seed=0):
    jc, tc = config_pair("TxnConfig", **cfg)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=fanout)
    jr, tr = config_pair("RunConfig", seed=seed, max_rounds=max_rounds,
                         target_coverage=1.0)
    jf, tf = fault
    j = JM.simulate_curve_txn(jc, jp, JG.complete(n), jr, jf, defend=defend)
    with forced_blocks(7):
        t = M.simulate_curve_txn(tc, tp, G.complete(n), tr, tf,
                                 defend=defend, device=CPU)
    assert np.array_equal(t[0], np.asarray(j[0]))
    assert np.array_equal(t[1], np.asarray(j[1]))
    assert payload_state_equal(j[2], t[2])
    assert t[3] == j[3]
    return t


def test_partition_stall_and_exact_heal():
    """While the window is open convergence stalls; after it closes
    every eventual-alive node holds the truth row, both planes, and the
    permanently dead writer won nothing (the reference's pin)."""
    n = 32
    conv, _, final, truth = _both_curve(SKEWED, n, fault_pair(**FULL))
    assert all(c < 1.0 for c in conv[:6]) and conv[-1] == 1.0
    tc = TC.TxnConfig(**SKEWED)
    _, tf = fault_pair(**FULL)
    truth_row = RG.ground_truth(tc, RG.inject_args(tc, n, CPU), tf, n, 0)
    eventual = RG.eventual_alive_crdt(tf, n, 0, CPU)
    assert (final.val[eventual] == truth_row[None, :]).all()
    assert 7 not in truth["ts_owner"]


@pytest.mark.parametrize("cfg,fault,target", [
    (dict(keys=8, txns=16), FULL, 1.0), (SKEWED, STATIC, 1.0),
    (SKEWED, FULL, 0.9)])
def test_until_driver_integer_target(cfg, fault, target):
    jc, tc = config_pair("TxnConfig", **cfg)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jr, tr = config_pair("RunConfig", seed=0, max_rounds=24,
                         target_coverage=target)
    jf, tf = fault_pair(**fault)
    j = JM.simulate_until_txn(jc, jp, JG.complete(32), jr, jf)
    t = M.simulate_until_txn(tc, tp, G.complete(32), tr, tf, device=CPU)
    assert t[:3] == j[:3] and t[4] == j[4]
    assert payload_state_equal(j[3], t[3])
    if fault is FULL and target == 1.0:
        assert t[1] == 1.0 and t[0] < 24


@pytest.mark.parametrize("loop", ["until", "curve"])
def test_loops_hold_two_states(loop):
    """A loop's round holds the state and its successor only: every
    earlier state, the first one included, is released."""
    n = 64
    tc = TC.TxnConfig(**SKEWED)
    step = M.make_register_round(tc, TC.ProtocolConfig(mode="pull",
                                                       fanout=2),
                                 G.complete(n), device=CPU)
    vals, most = [], [0]

    def counted(state, donate=False):
        vals.append(weakref.ref(state.val))
        out = step(state, donate=donate)
        vals.append(weakref.ref(out.val))
        most[0] = max(most[0], len({id(v()) for v in vals
                                    if v() is not None}))
        return out

    def init():
        return M.init_reg_state(TC.RunConfig(), tc, n, CPU)

    truth = RG.ground_truth(tc, RG.inject_args(tc, n, CPU), None, n, 0)
    alive = torch.ones(n, dtype=torch.bool)
    if loop == "until":
        state, count = M.run_until(counted, init, truth, alive, n, 30)
        assert count == n
    else:
        *_, state = M.run_curve(counted, init, truth, alive, 12)
    assert most[0] == 2


# -- honest convergence under liars ------------------------------------

BFAULT = dict(churn=dict(events=((4, 6, 12),)),
              byz=dict(liars=((3, 2, "inflate", 5),
                              (11, 0, "corrupt", 1 << 20)), quorum=2))


def test_defended_exact_where_undefended_control_diverges():
    """The register leg of the reference's byzantine scenario: the
    defended run's honest eventually-alive rows hold the truth on every
    honest-won key, the undefended control's do not, and both final
    states and counts equal the reference's."""
    n = 16
    cfg = dict(txns=12, keys=6, spread_rounds=8)
    jf, tf = fault_pair(**BFAULT)
    tc, jc = TC.TxnConfig(**cfg), JC.TxnConfig(**cfg)
    counts = {}
    for defend in (False, True):
        _, _, fin, _ = _both_curve(cfg, n, (jf, tf), max_rounds=100,
                                   defend=defend, fanout=3, seed=7)
        inj = RG.inject_args(tc, n, CPU)
        truth = RG.ground_truth(tc, inj, tf, n, 0)
        honest = NE.honest_mask(tf, n, CPU)
        alive_h = RG.eventual_alive_crdt(tf, n, 0, CPU) & honest
        km = RG.honest_key_mask(tc, inj, tf, n, 0, honest)
        counts[defend] = RG.byz_converged_count(tc, fin.val, truth, alive_h,
                                                km)
        jinj = JRG.inject_args(jc, n)
        jh = JNE.honest_mask(jf, n)
        jkm = JRG.honest_key_mask(jc, jinj, jf, n, 0, jh)
        assert np.array_equal(km.numpy(), np.asarray(jkm))
        assert counts[defend] == int(JRG.byz_converged_count(
            jc, jnp.asarray(fin.val.numpy()),
            JRG.ground_truth(jc, jinj, jf, n, 0),
            JRG.eventual_alive_crdt(jf, n, 0) & jh, jkm))
        denom = int(alive_h.sum())
    assert denom == n - 2
    assert counts[True] == denom and counts[False] < denom


@pytest.mark.parametrize("liars", [
    ((9, 0, "replay", 0),), ((3, 2, "inflate", 5), (5, 0, "corrupt", 1)),
    ()])
def test_honest_key_mask_matches_reference(liars):
    n = 16
    jc, tc = config_pair("TxnConfig", keys=6)
    jf, tf = fault_pair(churn=dict(events=((4, 6, 12),)),
                        byz=dict(liars=liars))
    want = JRG.honest_key_mask(jc, JRG.inject_args(jc, n), jf, n, 0,
                               JNE.honest_mask(jf, n))
    got = RG.honest_key_mask(tc, RG.inject_args(tc, n, CPU), tf, n, 0,
                             NE.honest_mask(tf, n, CPU))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- refusals ----------------------------------------------------------

def test_txn_rejections_are_loud():
    pull = TC.ProtocolConfig(mode="pull", fanout=2)
    with pytest.raises(ValueError, match="pull exchange only"):
        M.make_register_round(TC.TxnConfig(), TC.ProtocolConfig(mode="push"),
                              G.complete(8), device=CPU)
    with pytest.raises(ValueError, match="can never fire"):
        M.simulate_until_txn(TC.TxnConfig(writes=((0, 0, 100, 1),)), pull,
                             G.complete(8), TC.RunConfig(seed=0, max_rounds=8),
                             device=CPU)
    jp = JC.ProtocolConfig(mode="pull", fanout=2)
    with pytest.raises(ValueError, match="without a byzantine") as mine:
        M.make_register_round(TC.TxnConfig(), pull, G.complete(8),
                              defend=True, device=CPU)
    with pytest.raises(ValueError) as ref:
        JM.make_register_round(JC.TxnConfig(), jp, JG.complete(8),
                               defend=True)
    assert str(mine.value) == str(ref.value)


# -- run_simulation's txn workload -------------------------------------

@pytest.mark.parametrize("curve", [False, True])
def test_run_simulation_txn_matches_reference(curve):
    from gossip_tpu.backend import run_simulation as jrun
    from gossip_tpu_torch.backend import run_simulation
    jc, tc = config_pair("TxnConfig", **SKEWED)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jt, tt = config_pair("TopologyConfig", n=48)
    jr, tr = config_pair("RunConfig", seed=2, max_rounds=20,
                         target_coverage=1.0, engine="xla")
    jf, tf = fault_pair(**FULL)
    ref = jrun("jax-tpu", jp, jt, jr, jf, want_curve=curve, txn_cfg=jc)
    rep = run_simulation(tp, tt, tr, tf, want_curve=curve, device="cpu",
                         txn_cfg=tc)
    assert (rep.mode, rep.rounds, rep.coverage, rep.msgs, rep.curve) == \
        (ref.mode, ref.rounds, ref.coverage, ref.msgs, ref.curve)
    assert rep.meta["truth"] == ref.meta["truth"]
    assert rep.meta["engine"] == ref.meta["engine"] == "txn-xla"


def test_run_simulation_txn_refusals_match_reference():
    from gossip_tpu.backend import run_simulation as jrun
    from gossip_tpu_torch.backend import run_simulation
    jt, tt = config_pair("TopologyConfig", n=16)
    jc, tc = config_pair("TxnConfig")
    for proto, run, extra in (
            (dict(mode="push"), dict(engine="xla"), {}),
            (dict(mode="pull"), dict(engine="fused"), {}),
            (dict(mode="pull"), dict(engine="auto"), dict(mesh_cfg=1)),
            (dict(mode="pull"), dict(engine="xla"), dict(log_cfg=1))):
        jp, tp = config_pair("ProtocolConfig", **proto)
        jr, tr = config_pair("RunConfig", **run)
        jx, tx = {}, {}
        if "mesh_cfg" in extra:
            jx["mesh_cfg"], tx["mesh_cfg"] = config_pair("MeshConfig")
        if "log_cfg" in extra:
            jx["log_cfg"], tx["log_cfg"] = config_pair("LogConfig")
        with pytest.raises(ValueError) as ref:
            jrun("jax-tpu", jp, jt, jr, txn_cfg=jc, **jx)
        with pytest.raises(ValueError) as mine:
            run_simulation(tp, tt, tr, device="cpu", txn_cfg=tc, **tx)
        assert str(mine.value) == str(ref.value)


# -- the command line --------------------------------------------------

SAME = ("mode", "n", "keys", "rounds", "txn_conv", "converged", "truth",
        "msgs", "devices", "engine", "zipf_alpha", "hot_key", "load",
        "fault_program", "byz_program", "defended", "curve")
_BYZ16 = ["txn", "--n", "16", "--keys", "6", "--fanout", "3",
          "--max-rounds", "100"]
T6 = {"values": [71, 62, 58, 12, 0, 76], "ts_round": [7, 5, 3, 7, -1, 2],
      "ts_owner": [0, 5, 10, 15, -1, 9], "written_keys": 5}
T8 = {"values": [71, 62, 68, 12, 0, 0, 0, 1],
      "ts_round": [7, 5, 4, 7, -1, -1, -1, 2],
      "ts_owner": [0, 5, 10, 15, -1, -1, -1, 35], "written_keys": 5}


def _both_cli(capsys, args):
    from gossip_tpu import cli as jcli
    capsys.readouterr()
    assert jcli.main(args + ["--no-compile-cache"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: out.get(k) for k in SAME} == {k: ref.get(k) for k in SAME}
    assert list(out)[:len(ref)] == list(ref)
    assert out["backend"] == "torch-cpu" and out["compile_cache"] is None
    return out


@pytest.mark.parametrize("name,args,want", [
    ("TX2", ["txn", "--n", "4096", "--keys", "8", "--partition", "0:8:2048",
             "--churn-event", "3:2:5", "--drop-ramp", "1:4:0.0:0.3"],
     (23, 1.0, T8, 225172.0)),
    ("TX3", ["txn", "--n", "1024", "--zipf-alpha", "1.4", "--hot-key", "0.5",
             "--load", "diurnal", "--curve"],
     (16, 1.0, {"values": [71, 62, 1, 0, 0, 0, 87, 0],
                "ts_round": [6, 5, 7, -1, -1, -1, 2, -1],
                "ts_owner": [1, 5, 10, -1, -1, -1, 30, -1],
                "written_keys": 4}, 262144.0)),
    ("TX4", ["txn", "--n", "16", "--keys", "2", "--write", "3:0:1:9",
             "--write", "5:0:1:7"],
     (4, 1.0, {"values": [7, 0], "ts_round": [1, -1], "ts_owner": [5, -1],
               "written_keys": 1}, 256.0)),
    ("TXB1d", [*_BYZ16, "--byz", "11:0:corrupt:1048576", "--defend"],
     (32, 1.0, T6, 3072.0)),
    ("TXB1u", [*_BYZ16, "--byz", "11:0:corrupt:1048576"],
     (100, 0.0, T6, 9600.0)),
    ("TXB2d", [*_BYZ16, "--churn-event", "4:6:12", "--byz", "3:2:inflate:5",
               "--byz", "11:0:corrupt:1048576", "--defend"],
     (32, 1.0, T6, 3036.0)),
    ("TXB3u", [*_BYZ16, "--churn-event", "4:6:12", "--byz",
               "3:2:inflate:200000000", "--byz", "7:1:equivocate", "--byz",
               "9:0:replay"], (100, 0.0, T6, 9564.0)),
    ("scripted-curve", ["txn", "--n", "16", "--keys", "2", "--write",
                        "3:0:1:9", "--write", "5:0:1:7", "--write",
                        "1:1:0:4", "--curve", "--max-rounds", "12"], None),
])
def test_cli_txn_matches_reference(capsys, name, args, want):
    out = _both_cli(capsys, args)
    if want is not None:
        assert (out["rounds"], out["txn_conv"], out["truth"],
                out["msgs"]) == want
    if name == "TX3":
        assert out["curve"] == [0.0] * 10 + [
            0.0009765625, 0.0146484375, 0.1201171875, 0.541015625,
            0.935546875] + [1.0] * 49


def test_cli_txn_run_and_save_curve(capsys, tmp_path):
    """The reference's own CLI run (a program under the nemesis, the
    skew flags) and ``--save-curve``'s JSONL, row for row."""
    from gossip_tpu import cli as jcli
    args = ["txn", "--n", "32", "--max-rounds", "24", "--partition",
            "0:4:16", "--churn-event", "3:2:5", "--drop-ramp", "1:3:0.0:0.2",
            "--zipf-alpha", "1.3", "--hot-key", "0.4"]
    out = _both_cli(capsys, args)
    assert out["converged"] is True and out["txn_conv"] == 1.0
    assert out["truth"]["written_keys"] > 0 and out["fault_program"] is True
    paths = [tmp_path / "ref.jsonl", tmp_path / "port.jsonl"]
    jcli.main(args + ["--no-compile-cache", "--save-curve", str(paths[0])])
    cli.main(args + ["--device", "cpu", "--save-curve", str(paths[1])])
    ref_rows, rows = ([json.loads(x) for x in p.read_text().splitlines()]
                      for p in paths)
    assert rows[1:] == ref_rows[1:] and len(rows) > 1
    assert {k: rows[0]["meta"].get(k) for k in SAME} == \
        {k: ref_rows[0]["meta"].get(k) for k in SAME}


def test_cli_txn_error_paths(capsys):
    assert cli.main(["txn", "--write", "0:0:0:0", "--device", "cpu"]) == 2
    assert "values must be >= 1" in capsys.readouterr().err
    assert cli.main(["txn", "--write", "0:0:0", "--device", "cpu"]) == 2
    assert "4 colon-separated" in capsys.readouterr().err
    capsys.readouterr()
    assert cli.main(["txn", "--n", "64", "--devices", "4", "--device",
                     "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["engine"] == "txn-sharded"
    assert cli.main(["txn", "--defend", "--device", "cpu"]) == 2
    assert "without a byzantine program" in capsys.readouterr().err
    assert cli.main(["txn", "--n", "4", "--keys", "1", "--txns", "32",
                     "--spread", "1", "--device", "cpu"]) == 2
    assert "lower --txns" in capsys.readouterr().err
    assert cli.main(["txn", "--write", "99:0:0:1", "--n", "8", "--device",
                     "cpu"]) == 2
    assert "node ids >= n=8" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["txn", "--load", "lunar", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="not a payload command"):
        cli.run_payload(["run", "--device", "cpu"])


def test_shared_predicates_are_the_crdt_payloads():
    """The registers' padding, no-injection round and liveness
    predicates are the CRDT payloads' own, as in the reference."""
    assert RG.NO_ROUND == CR.NO_ROUND == JRG.NO_ROUND
    assert RG.alive_at_fn is CR.alive_at_fn
    assert RG.converged_count is CR.converged_count
    assert RG.state_width(TC.TxnConfig(keys=5)) == 10
