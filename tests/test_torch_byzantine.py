"""The port's byzantine liar program (gossip_tpu_torch/ops/nemesis.py's
byzantine half, the CRDT exchange's liar transforms and defended
admission in gossip_tpu_torch/ops/crdt.py) against the JAX package's,
bitwise (tolerance 0).

The liar tables, each transform on adversarial rows (the int32 wrap of
inflate and of the equivocation add, xor with the top bit, the uint32
wrap of the set equivocation pattern at large receiver ids), the quorum
dedupe and the whole exchange for both arms, every quorum and both
payload families must equal the reference's; so must every state field
after every round of a liar run under churn, with the exchange's blocks
forced small, and the ``crdt --byz`` command lines (BZ1d and its
undefended control BZ1u at their own size).  The reference's own cases
(config validation, defended exact where the undefended control
diverges, an empty or dormant liar table leaving the trajectory bitwise
unchanged, the engines without liar transforms refusing a liar program)
run on the port too.  The reference runs live, its executable store off.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (config_pair, fault_pair, forced_blocks,
                              payload_state_equal)
from gossip_tpu import config as JC
from gossip_tpu.ops import crdt as JCR
from gossip_tpu.ops import nemesis as JNE
from gossip_tpu_torch import cli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import crdt as M
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
N = 16
LIARS = ((3, 2, "inflate", 5), (11, 0, "corrupt", 1 << 20))
BFAULT = dict(churn=dict(events=((4, 6, 12),)),
              byz=dict(liars=LIARS, quorum=2))


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


# -- config validation -------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(liars=((0, 0, "lie", 1),)), "unknown byz kind"),
    (dict(liars=((0, 0, "inflate", 1), (0, 2, "corrupt", 2))),
     "at most once"),
    (dict(liars=((0, 0, "inflate", 1),), quorum=0), "quorum=0"),
    (dict(liars=((0, 0, "inflate", 1),), quorum=9), "carry-save chain"),
    (dict(liars=((-1, 0, "inflate", 1),)), ">= 0"),
    (dict(liars=((1, 10 ** 6, "inflate", 1),)), "horizon cap"),
    (dict(liars=((1, 0, "inflate", -3),)), "arg must be"),
])
def test_byz_config_refusals_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        TC.ByzConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JC.ByzConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_byz_config_validation():
    TC.ByzConfig(liars=((0, 0, "inflate", 1), (5, 3, "corrupt", 7)))
    TC.ByzConfig(liars=(), quorum=3)
    assert TC.ByzConfig(liars=((2, 1, "replay"),)).liars == \
        ((2, 1, "replay", 0),)
    f = TC.FaultConfig(byz=TC.ByzConfig(liars=LIARS))
    assert f.byz.liars == LIARS
    assert TC.FaultConfig(byz=TC.ByzConfig()).byz is None
    assert TC.FaultConfig(byz=dict(liars=LIARS, quorum=3)).byz.quorum == 3


def test_liar_tables_match_reference():
    jf, tf = fault_pair(byz=dict(liars=((3, 2, "inflate", 5),
                                        (11, 0, "corrupt", 1 << 20),
                                        (7, 4, "equivocate", 9),
                                        (0, 1, "replay", 0)), quorum=3))
    jb, tb = JNE.build_byz(jf, 20), NE.build_byz(tf, 20, device=CPU)
    for f in ("kind", "start", "arg"):
        assert np.array_equal(getattr(tb, f).numpy(),
                              np.asarray(getattr(jb, f)))
    assert tb.quorum == int(jb.quorum) == 3
    assert np.array_equal(NE.honest_mask(tf, 20, CPU).numpy(),
                          np.asarray(JNE.honest_mask(jf, 20)))
    ids = torch.arange(20)
    for r in range(6):
        assert np.array_equal(
            NE.byz_active(tb, ids, r).numpy(),
            np.asarray(JNE.byz_active(jb, jnp.arange(20), r)))
    with pytest.raises(ValueError, match="node ids >= n=10") as mine:
        NE.build_byz(tf, 10, device=CPU)
    with pytest.raises(ValueError) as ref:
        JNE.build_byz(jf, 10)
    assert str(mine.value) == str(ref.value)


# -- the transforms on adversarial rows --------------------------------

def _adversarial(n, nl, k, s, rng, dtype):
    """(got, safe, active, gids): rows with int32 extremes, partners
    that are mostly liars, receivers with large ids."""
    if dtype == np.uint32:
        got = rng.integers(0, 2 ** 32, size=(nl, k, s), dtype=np.uint32)
        got[0, 0, :] = 0xFFFFFFFF
    else:
        got = rng.integers(-2 ** 31, 2 ** 31, size=(nl, k, s),
                           dtype=np.int64).astype(np.int32)
        got[0, :, :] = 2 ** 31 - 1
        got[1, :, :] = -2 ** 31
    liar_ids = np.array([3, 11, 7, 0, 20, 5])
    safe = rng.choice(np.concatenate([liar_ids, rng.integers(0, n, 4)]),
                      size=(nl, k)).astype(np.int32)
    active = rng.random((nl, k)) < 0.8
    gids = rng.integers(n - 5000, n, size=nl).astype(np.int32)
    return got, safe, active, gids


LIAR_ARGS = ((3, 0, "inflate", 2 ** 31 - 1), (11, 0, "corrupt", 2 ** 31 - 1),
             (7, 0, "equivocate", 2 ** 31 - 1), (0, 0, "replay", 0),
             (20, 0, "equivocate", 977), (5, 0, "inflate", 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_transforms_match_reference(seed):
    n = 70_000
    rng = np.random.default_rng(seed)
    got, safe, active, gids = _adversarial(n, 12, 3, 40, rng, np.int32)
    jf, tf = fault_pair(byz=dict(liars=LIAR_ARGS))
    want = np.asarray(JCR._byz_serve_counter(
        jnp.asarray(got), jnp.asarray(safe), jnp.asarray(active),
        jnp.asarray(gids), JNE.build_byz(jf, n), n))
    mine = CR._byz_serve_counter(
        torch.from_numpy(got), torch.from_numpy(safe).long(),
        torch.from_numpy(active), torch.from_numpy(gids),
        NE.build_byz(tf, n, device=CPU), n)
    assert np.array_equal(mine.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_transforms_match_reference(seed):
    n, elements = 70_000, 70
    rng = np.random.default_rng(seed)
    w2 = 2 * ((elements + 31) // 32)
    got, safe, active, gids = _adversarial(n, 12, 3, w2, rng, np.uint32)
    jf, tf = fault_pair(byz=dict(liars=LIAR_ARGS))
    jown = JCR.set_owner_words(elements, n, 9)
    town = CR.set_owner_words(elements, n, 9, CPU)
    assert np.array_equal(town.numpy().view(np.uint32), np.asarray(jown))
    juni = JCR._set_universe(elements, w2)
    tuni = CR._set_universe(elements, w2, CPU)
    assert np.array_equal(tuni.numpy().view(np.uint32), np.asarray(juni))
    want = np.asarray(JCR._byz_serve_set(
        jnp.asarray(got), jnp.asarray(safe), jnp.asarray(active),
        jnp.asarray(gids), JNE.build_byz(jf, n), jown, juni))
    mine = CR._byz_serve_set(
        torch.from_numpy(got.view(np.int32)), torch.from_numpy(safe).long(),
        torch.from_numpy(active), torch.from_numpy(gids),
        NE.build_byz(tf, n, device=CPU), town, tuni)
    assert np.array_equal(mine.numpy().view(np.uint32), want)


def test_unique_valid_matches_reference():
    rng = np.random.default_rng(4)
    for k in (1, 2, 3, 5):
        safe = rng.integers(0, 4, size=(50, k)).astype(np.int32)
        valid = rng.random((50, k)) < 0.7
        want = np.asarray(JCR._unique_valid(jnp.asarray(safe),
                                            jnp.asarray(valid)))
        mine = CR._unique_valid(torch.from_numpy(safe).long(),
                                torch.from_numpy(valid))
        assert np.array_equal(mine.numpy(), want)


EXCHANGE_CASES = [(kind, defend, q) for kind in ("gcounter", "pncounter",
                                                 "gset", "orset")
                  for defend in (False, True) for q in (1, 2, 3)]


@pytest.mark.parametrize("kind,defend,quorum", EXCHANGE_CASES)
def test_exchange_matches_reference(kind, defend, quorum):
    """pull_merge_crdt_byz on random rows and partners (sentinels among
    them), liars down at the round included, every liar kind."""
    n, k, r, origin = 24, 3, 3, 2
    jc, tc = config_pair("CrdtConfig", kind=kind, elements=70)
    jf, tf = fault_pair(
        churn=dict(events=((7, 2, 6),)),
        byz=dict(liars=((3, 0, "inflate", 5), (11, 1, "corrupt", 1 << 31 - 1),
                        (7, 0, "equivocate", 12345), (9, 0, "replay", 0),
                        (14, 9, "inflate", 3)), quorum=quorum))
    rng = np.random.default_rng(quorum)
    s = CR.state_width(tc, n)
    if kind in TC.CRDT_SET_KINDS:
        rows = rng.integers(0, 2 ** 32, size=(n, s), dtype=np.uint32)
        trows = torch.from_numpy(rows.view(np.int32).copy())
    else:
        rows = rng.integers(0, 1000, size=(n, s), dtype=np.int32)
        trows = torch.from_numpy(rows.copy())
    partners = rng.choice([3, 11, 7, 9, 14, 0, 1, 5, n], size=(n, k))
    jfn = JCR.alive_at_fn(jf, n, origin)
    tfn = CR.alive_at_fn(tf, n, origin, CPU)
    want = np.asarray(JCR.pull_merge_crdt_byz(
        jc, jnp.asarray(rows), jnp.asarray(partners.astype(np.int32)), n,
        byz=JNE.build_byz(jf, n), round_=r,
        gids=jnp.arange(n, dtype=jnp.int32), n=n, origin=origin,
        alive_fn=jfn, defend=defend))
    mine = CR.pull_merge_crdt_byz(
        tc, trows, torch.from_numpy(partners), n,
        byz=NE.build_byz(tf, n, device=CPU), round_=r, gids=torch.arange(n),
        n=n, origin=origin, alive_fn=tfn, defend=defend)
    got = mine.numpy()
    assert np.array_equal(got.view(np.uint32) if want.dtype == np.uint32
                          else got, want)


# -- the round under a liar program ------------------------------------

def _steps(kind, defend, quorum, block_rows, rounds=14, n=N):
    import jax
    from gossip_tpu.models import crdt as JM
    from gossip_tpu.topology import generators as JG
    jc, tc = config_pair("CrdtConfig", kind=kind, elements=48,
                         **({"set_removes": ((5, 3),)} if kind == "orset"
                            else {}))
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=3)
    jf, tf = fault_pair(drop_prob=0.05, seed=1, **{
        **BFAULT, "byz": dict(liars=LIARS + ((9, 1, "equivocate", 77),
                                             (6, 3, "replay", 0)),
                              quorum=quorum)})
    run = dict(seed=7, max_rounds=100)
    jstep = jax.jit(JM.make_crdt_round(jc, jp, JG.complete(n), jf, 1,
                                       defend=defend))
    with forced_blocks(block_rows):
        tstep = M.make_crdt_round(tc, tp, G.complete(n), tf, 1,
                                  defend=defend, device=CPU)
    js = JM.init_crdt_state(JC.RunConfig(**run), jc, n)
    ts = M.init_crdt_state(TC.RunConfig(**run), tc, n, CPU)
    for r in range(rounds):
        (js, jl), (ts, tl) = jstep(js), tstep(ts)
        assert payload_state_equal(js, ts), f"round {r}"
        assert np.float32(jl) == np.float32(tl.item())


@pytest.mark.parametrize("kind,defend,quorum,block_rows", [
    ("gcounter", False, 2, 5), ("gcounter", True, 2, 3),
    ("pncounter", True, 1, 16), ("orset", False, 2, 4),
    ("orset", True, 2, 1), ("gset", True, 3, 7)])
def test_byz_round_matches_reference(kind, defend, quorum, block_rows):
    _steps(kind, defend, quorum, block_rows)


def _curve(fault, defend, n=N, max_rounds=100, seed=7):
    cfg = TC.CrdtConfig(kind="gcounter")
    return M.simulate_curve_crdt(
        cfg, TC.ProtocolConfig(mode="pull", fanout=3), G.complete(n),
        TC.RunConfig(seed=seed, max_rounds=max_rounds, target_coverage=1.0),
        fault, defend=defend, device=CPU)


def test_defended_exact_where_undefended_control_diverges():
    from gossip_tpu.models import crdt as JM
    from gossip_tpu.topology import generators as JG
    jf, tf = fault_pair(**BFAULT)
    cfg = TC.CrdtConfig(kind="gcounter")
    _, _, fin_u, _ = _curve(tf, False)
    conv_d, _, fin_d, _ = _curve(tf, True)
    truth = CR.ground_truth(cfg, CR.inject_args(cfg, N, CPU), tf, N, 0, CPU)
    honest = NE.honest_mask(tf, N, CPU)
    alive_h = CR.eventual_alive_crdt(tf, N, 0, CPU) & honest
    comp = CR.honest_component_mask(cfg, N, 0, honest)
    denom = int(alive_h.sum())
    assert denom == N - len(LIARS)
    cnt_d = CR.byz_converged_count(cfg, fin_d.val, truth, alive_h, comp)
    cnt_u = CR.byz_converged_count(cfg, fin_u.val, truth, alive_h, comp)
    assert cnt_d == denom and cnt_u < denom and conv_d[-1] == 1.0
    assert not bool(alive_h[3]) and not bool(alive_h[11])
    # the same counts and final state as the reference's
    jc = JC.CrdtConfig(kind="gcounter")
    jp = JC.ProtocolConfig(mode="pull", fanout=3)
    jr = JC.RunConfig(seed=7, max_rounds=100, target_coverage=1.0)
    for defend, fin, cnt in ((False, fin_u, cnt_u), (True, fin_d, cnt_d)):
        j = JM.simulate_curve_crdt(jc, jp, JG.complete(N), jr, jf,
                                   defend=defend)
        assert payload_state_equal(j[2], fin)
        jh = JNE.honest_mask(jf, N)
        assert cnt == int(JCR.byz_converged_count(
            jc, j[2].val, JCR.ground_truth(jc, JCR.inject_args(jc, N), jf,
                                           N, 0),
            JCR.eventual_alive_crdt(jf, N, 0) & jh,
            JCR.honest_component_mask(jc, N, 0, jh)))


@pytest.mark.parametrize("kind", ["gcounter", "orset"])
def test_honest_component_mask_matches_reference(kind):
    n = 40
    jc, tc = config_pair("CrdtConfig", kind=kind, elements=70)
    jf, tf = fault_pair(byz=dict(liars=LIAR_ARGS[:3]))
    want = np.asarray(JCR.honest_component_mask(jc, n, 5,
                                                JNE.honest_mask(jf, n)))
    mine = CR.honest_component_mask(tc, n, 5, NE.honest_mask(tf, n, CPU))
    got = mine.numpy()
    assert np.array_equal(got.view(np.uint32) if want.dtype == np.uint32
                          else got, want)


def test_inactive_liar_table_leaves_trajectory_bitwise_unchanged():
    churn = dict(events=((3, 2, 5),))
    _, plain = fault_pair(drop_prob=0.05, seed=1, churn=churn)
    _, empty = fault_pair(drop_prob=0.05, seed=1, churn=churn,
                          byz=dict(liars=(), quorum=2))
    _, dormant = fault_pair(drop_prob=0.05, seed=1, churn=churn,
                            byz=dict(liars=((3, 900, "inflate", 5),
                                            (7, 900, "corrupt", 1)),
                                     quorum=2))
    c0, m0, f0, t0 = _curve(plain, False, max_rounds=16, seed=3)
    for fault in (empty, dormant):
        c1, m1, f1, t1 = _curve(fault, False, max_rounds=16, seed=3)
        assert np.array_equal(c0, c1) and np.array_equal(m0, m1)
        assert torch.equal(f0.val, f1.val) and t0 == t1


# -- refusals ----------------------------------------------------------

def _byz_only():
    return TC.FaultConfig(byz=TC.ByzConfig(liars=LIARS, quorum=2))


def _refusal_calls():
    from gossip_tpu_torch.backend import run_simulation
    from gossip_tpu_torch.models import log as LM
    from gossip_tpu_torch.models import rumor as RM
    from gossip_tpu_torch.models import si, si_packed, swim
    from gossip_tpu_torch.ops import fused_mr_round as MR
    from gossip_tpu_torch.ops import fused_round as FR
    f, topo = _byz_only(), G.complete(N)

    def proto(mode, **kw):
        return TC.ProtocolConfig(mode=mode, **kw)

    def run(engine, mode="pull"):
        return lambda: run_simulation(
            proto(mode), TC.TopologyConfig(n=N), TC.RunConfig(engine=engine),
            f, device="cpu")

    return {
        "si-xla": lambda: si.make_si_round(proto("push"), topo, f,
                                           device=CPU),
        "si-packed": lambda: si_packed.make_packed_round(
            proto("pull"), topo, f, device=CPU),
        "fused": lambda: FR.until_fused(N, 0, fault=f, device=CPU),
        "fused-mr": lambda: MR.until_fused_multirumor(N, 4, 0,
                                                      fault=f, device=CPU),
        "swim": lambda: swim.make_swim_round(proto("swim"), N, (1,), 2, f,
                                             device=CPU),
        "rumor": lambda: RM.make_rumor_round(proto("rumor"), topo, f,
                                             device=CPU),
        "log-pull": lambda: LM.simulate_curve_log(
            TC.LogConfig(), proto("pull"), topo,
            TC.RunConfig(max_rounds=8), f, device=CPU),
        "run-fused": run("fused"), "run-auto": run("auto"),
        "run-xla-push": run("xla", "push"),
    }


@pytest.mark.parametrize("engine", list(_refusal_calls()))
def test_engines_without_liar_transforms_reject_byz_loudly(engine):
    """Every engine but the CRDT and register exchanges refuses a liar
    program, even without a churn schedule, in the reference's words."""
    with pytest.raises(ValueError, match="byzantine liar program") as mine:
        _refusal_calls()[engine]()
    with pytest.raises(ValueError) as ref:
        JNE.check_supported(JC.FaultConfig(byz=JC.ByzConfig(liars=LIARS)),
                            engine="swim-probe")
    assert str(mine.value).split(" engine ", 1)[1] == \
        str(ref.value).split(" engine ", 1)[1]


def test_defend_refusals_match_reference():
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=1)
    from gossip_tpu.models import crdt as JM
    from gossip_tpu.topology import generators as JG
    for kind, fault in (("gcounter", {}), ("orset", BFAULT)):
        jc, tc = config_pair("CrdtConfig", kind=kind)
        jf, tf = fault_pair(**fault)
        with pytest.raises(ValueError) as mine:
            M.make_crdt_round(tc, tp, G.complete(N), tf, defend=True,
                              device=CPU)
        with pytest.raises(ValueError) as ref:
            JM.make_crdt_round(jc, jp, JG.complete(N), jf, defend=True)
        assert str(mine.value) == str(ref.value)


# -- the command line --------------------------------------------------

BZ1 = ["crdt", "--type", "gcounter", "--n", "16", "--fanout", "3",
       "--max-rounds", "100", "--churn-event", "4:6:12", "--byz",
       "3:2:inflate:5", "--byz", "11:0:corrupt:1048576"]


@pytest.mark.parametrize("name,extra,want", [
    ("BZ1d", ["--defend"], (26, 1.0, 59, 2460.0)),
    ("BZ1u", [], (100, 0.0, 59, 9564.0)),
    ("BZ1d-q3-curve", ["--defend", "--byz-quorum", "3", "--curve"], None),
])
def test_bz1_command_lines_match_reference(capsys, name, extra, want):
    from gossip_tpu import cli as jcli
    capsys.readouterr()
    assert jcli.main(BZ1 + extra + ["--no-compile-cache"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(BZ1 + extra + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ("rounds", "value_conv", "truth_value", "msgs", "converged",
            "byz_program", "defended", "fault_program", "curve")
    assert {k: out.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    if want is not None:
        assert (out["rounds"], out["value_conv"], out["truth_value"],
                out["msgs"]) == want


def test_cli_byz_parse_errors(capsys):
    assert cli.main(["crdt", "--byz", "3:2", "--device", "cpu"]) == 2
    assert "NODE:ROUND:KIND" in capsys.readouterr().err
    assert cli.main(["crdt", "--defend", "--device", "cpu"]) == 2
    assert "without a byzantine program" in capsys.readouterr().err
