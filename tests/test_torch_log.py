"""The port's replicated logs (gossip_tpu_torch/ops/logs.py,
gossip_tpu_torch/models/log.py, the ``log`` command and the backend's
log workload) against the JAX package's, bitwise (tolerance 0).

Both packages run the same configuration from the same seed, the port on
the CPU and the reference under ``jax.jit``: every state field after
every round (and ``lost`` under a fault program) must be equal, without
faults, under static deaths and drops and under the full fault program,
with the exchange's blocks forced small; so must the send and commit
lowering, the dense injection rows and the in-place injection, the
ground truth, the readouts, the loops' per-round converged counts and
msgs, the until loop, ``run_simulation``'s log workload and the command
line (LG2 and LG3 at their own size).  The reference's own
single-device cases (config validation, the acked-appends truth, the
partition stall and exact heal, the refusals, the CLI's run and error
paths) run on the port too.  The reference runs live, its executable
store off.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (config_pair, fault_pair, forced_blocks,
                              payload_state_equal)
from gossip_tpu import config as JC
from gossip_tpu.models import log as JM
from gossip_tpu.ops import crdt as JCR
from gossip_tpu.ops import logs as JLG
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import cli
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import log as M
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import logs as LG
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
FULL = dict(drop_prob=0.05, seed=1, churn=dict(
    events=((3, 2, 5), (7, 1, -1)), partitions=((0, 6, 16),),
    ramp=(1, 4, 0.0, 0.3)))
STATIC = dict(node_death_rate=0.15, drop_prob=0.1, seed=2)
SCRIPT = dict(keys=2, capacity=8,
              sends=((0, 0, 0, 10), (7, 0, 1, 20), (1, 0, 2, 30),
                     (2, 0, 5, 40), (4, 1, 1, 3), (4, 1, 1, 9)),
              commits=((4, 0, 6, 3), (5, 1, 6, 1), (6, 1, 2, 5)))


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


# -- config validation -------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(keys=0), "keys must be"),
    (dict(capacity=0), "capacity must be"),
    (dict(sends=((0, 0, 0, 0),)), "values must be >= 1"),
    (dict(keys=2, sends=((0, 5, 0, 1),)), "outside"),
    (dict(sends=((0, 0, 10 ** 9, 1),)), "horizon cap"),
    (dict(keys=1, capacity=2,
          sends=((0, 0, 0, 1), (1, 0, 1, 2), (2, 0, 2, 3))), "wrap"),
    (dict(sends=((0, 0, 5, 1), (1, 0, 2, 2))), "nondecreasing"),
    (dict(commits=((0, 0, 2, 0),)), "upto must be"),
    (dict(keys=4, capacity=2), "default send program"),
    (dict(sends=((-1, 0, 0, 1),)), "send node"),
])
def test_log_config_refusals_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        TC.LogConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JC.LogConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_log_config_validation():
    TC.LogConfig(keys=2, capacity=4,
                 sends=((0, 0, 0, 5), (1, 0, 2, 7), (2, 1, 0, 1)),
                 commits=((0, 0, 3, 2),))
    TC.LogConfig(keys=4, capacity=2, sends=((0, 0, 0, 1), (1, 1, 0, 1)))
    assert TC.LogConfig(sends=((0, 0, 7, 1),)).horizon() == 8
    assert TC.LogConfig().horizon() == 5


# -- injections and ground truth ---------------------------------------

def test_ground_truth_acked_append_semantics():
    n = 8
    cfg = TC.LogConfig(keys=2, capacity=8,
                       sends=((0, 0, 0, 10), (7, 0, 1, 20), (1, 0, 2, 30),
                              (2, 0, 5, 40)),
                       commits=((4, 0, 6, 3), (5, 1, 6, 1)))
    _, f = fault_pair(churn=dict(events=((7, 1, -1), (1, 1, 4))))
    inj = LG.inject_args(cfg, n, CPU)
    truth = LG.ground_truth(cfg, inj, f, n, 0)
    assert truth[:8].tolist() == [10, 40, 0, 0, 0, 0, 0, 0]
    assert truth[8:16].tolist() == [0] * 8
    assert truth[16:].tolist() == [2, 0]
    truth0 = LG.ground_truth(cfg, inj, None, n, 0)
    assert truth0[:8].tolist() == [10, 20, 30, 40, 0, 0, 0, 0]
    assert truth0[16:].tolist() == [3, 0]
    with pytest.raises(ValueError, match="node ids"):
        LG.inject_args(TC.LogConfig(sends=((99, 0, 0, 1),)), n, CPU)
    assert LG.log_len(cfg, truth[None, :])[0].tolist() == [2, 0]


@pytest.mark.parametrize("kw", [{}, SCRIPT, dict(keys=3, capacity=4)])
def test_injection_lowering_matches_reference(kw):
    """inject_args, send_offsets, the in-place injection of every round
    (the reference's dense rows max-merged into a state) and the truth
    under a program that downs appenders at their rounds."""
    n, origin = 10, 2
    jc, tc = config_pair("LogConfig", **kw)
    jf, tf = fault_pair(churn=dict(events=((7, 1, -1), (1, 1, 4),
                                           (6, 2, 3))))
    jinj, tinj = JLG.inject_args(jc, n), LG.inject_args(tc, n, CPU)
    assert [np.asarray(x).tolist() for x in jinj] == \
        [x.tolist() for x in tinj]
    ids = jnp.arange(n, dtype=jnp.int32)
    rng = np.random.default_rng(1)
    val = rng.integers(0, 50, size=(n, LG.state_width(tc)), dtype=np.int32)
    for r in range(8):
        want = np.asarray(JLG.inject_rows(jc, jinj, ids, r, n, origin, jf))
        applied = LG.apply_injections(tc, torch.from_numpy(val.copy()), tinj,
                                      r, n, origin, tf)
        assert np.array_equal(applied.numpy(), np.maximum(val, want)), r
    want_t = np.asarray(JLG.ground_truth(jc, jinj, jf, n, origin))
    got_t = LG.ground_truth(tc, tinj, tf, n, origin)
    assert np.array_equal(got_t.numpy(), want_t)
    assert LG.truth_summary(tc, got_t) == JLG.truth_summary(jc, want_t)
    applied = jnp.asarray(rng.random(tinj[0].shape[0]) < 0.6)
    assert np.array_equal(
        LG.send_offsets(tinj[1], torch.from_numpy(np.array(applied)))
        .numpy(), np.asarray(JLG.send_offsets(jinj[1], applied)))


def test_readouts_match_reference():
    n = 20
    jc, tc = config_pair("LogConfig", keys=3, capacity=5)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 3, size=(n, LG.state_width(tc)), dtype=np.int32)
    alive = rng.random(n) < 0.7
    assert np.array_equal(LG.log_len(tc, torch.from_numpy(rows)).numpy(),
                          np.asarray(JLG.log_len(jc, jnp.asarray(rows))))
    assert np.array_equal(
        LG.committed_of(tc, torch.from_numpy(rows)).numpy(),
        np.asarray(JLG.committed_of(jc, jnp.asarray(rows))))
    assert float(LG.payload_count(tc, torch.from_numpy(rows),
                                  torch.from_numpy(alive))) == \
        float(JLG.payload_count(jc, jnp.asarray(rows), jnp.asarray(alive)))
    partners = rng.integers(0, n + 1, size=(n, 3))
    serve = rng.random(n) < 0.8
    want = np.asarray(JLG.pull_merge_log(
        jnp.where(jnp.asarray(serve)[:, None], jnp.asarray(rows), 0),
        jnp.asarray(partners.astype(np.int32)), n))
    got = LG.pull_merge_log(torch.from_numpy(rows),
                            torch.from_numpy(partners), n,
                            serve=torch.from_numpy(serve))
    assert np.array_equal(got.numpy(), want)


# -- the round, every field, every round -------------------------------

@pytest.mark.parametrize("kw,fault,block_rows", [
    ({}, None, 3), (SCRIPT, STATIC, 5), ({}, FULL, 1),
    (dict(keys=3, capacity=6), FULL, 4), (SCRIPT, FULL, 1 << 20)])
def test_round_matches_reference(kw, fault, block_rows):
    n = 32
    jc, tc = config_pair("LogConfig", **kw)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jf, tf = fault_pair(**(fault or {}))
    run = dict(seed=4, origin=3, max_rounds=40)
    jstep = jax.jit(JM.make_log_round(jc, jp, JG.complete(n), jf, 3))
    with forced_blocks(block_rows):
        tstep = M.make_log_round(tc, tp, G.complete(n), tf, 3, device=CPU)
    js = JM.init_log_state(JC.RunConfig(**run), jc, n)
    ts = M.init_log_state(TC.RunConfig(**run), tc, n, CPU)
    churn = tf is not None and tf.churn is not None
    for r in range(12):
        jo, to = jstep(js), tstep(ts)
        if churn:
            (js, jl), (ts, tl) = jo, to
            assert np.float32(jl) == np.float32(tl.item())
        else:
            js, ts = jo, to
        assert payload_state_equal(js, ts), f"round {r}"


def _both_curve(cfg_kw, n, fault, max_rounds=24):
    jc, tc = config_pair("LogConfig", **cfg_kw)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jr, tr = config_pair("RunConfig", seed=0, max_rounds=max_rounds,
                         target_coverage=1.0)
    jf, tf = fault
    j = JM.simulate_curve_log(jc, jp, JG.complete(n), jr, jf)
    with forced_blocks(6):
        t = M.simulate_curve_log(tc, tp, G.complete(n), tr, tf, device=CPU)
    assert np.array_equal(t[0], np.asarray(j[0]))
    assert np.array_equal(t[1], np.asarray(j[1]))
    assert payload_state_equal(j[2], t[2])
    assert t[3] == j[3]
    return t


def test_partition_stall_and_exact_heal():
    n = 32
    cfg = dict(keys=4, capacity=8)
    conv, _, final, truth = _both_curve(cfg, n, fault_pair(**FULL))
    assert all(c < 1.0 for c in conv[:6]) and conv[-1] == 1.0
    tc = TC.LogConfig(**cfg)
    _, tf = fault_pair(**FULL)
    truth_row = LG.ground_truth(tc, LG.inject_args(tc, n, CPU), tf, n, 0)
    eventual = LG.eventual_alive_crdt(tf, n, 0, CPU)
    assert (final.val[eventual] == truth_row[None, :]).all()
    assert truth["total_entries"] < 16


@pytest.mark.parametrize("fault", [FULL, STATIC])
def test_until_driver_integer_target(fault):
    jc, tc = config_pair("LogConfig", keys=4, capacity=8)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jr, tr = config_pair("RunConfig", seed=0, max_rounds=24,
                         target_coverage=1.0)
    jf, tf = fault_pair(**fault)
    j = JM.simulate_until_log(jc, jp, JG.complete(32), jr, jf)
    t = M.simulate_until_log(tc, tp, G.complete(32), tr, tf, device=CPU)
    assert t[:3] == j[:3] and t[4] == j[4]
    assert payload_state_equal(j[3], t[3])


def test_log_rejections_are_loud():
    pull = TC.ProtocolConfig(mode="pull", fanout=2)
    with pytest.raises(ValueError, match="pull exchange only"):
        M.make_log_round(TC.LogConfig(), TC.ProtocolConfig(mode="push"),
                         G.complete(8), device=CPU)
    with pytest.raises(ValueError, match="can never fire"):
        M.simulate_until_log(TC.LogConfig(sends=((0, 0, 100, 1),)), pull,
                             G.complete(8), TC.RunConfig(seed=0, max_rounds=8),
                             device=CPU)
    with pytest.raises(ValueError, match="byzantine liar program"):
        M.make_log_round(TC.LogConfig(), pull, G.complete(16),
                         TC.FaultConfig(byz=TC.ByzConfig(
                             liars=((3, 0, "inflate", 1),))), device=CPU)


# -- run_simulation's log workload -------------------------------------

@pytest.mark.parametrize("curve", [False, True])
def test_run_simulation_log_matches_reference(curve):
    from gossip_tpu.backend import run_simulation as jrun
    from gossip_tpu_torch.backend import run_simulation
    jc, tc = config_pair("LogConfig", keys=3, capacity=6)
    jp, tp = config_pair("ProtocolConfig", mode="pull", fanout=2)
    jt, tt = config_pair("TopologyConfig", n=48)
    jr, tr = config_pair("RunConfig", seed=2, max_rounds=20,
                         target_coverage=1.0, engine="xla")
    jf, tf = fault_pair(**FULL)
    ref = jrun("jax-tpu", jp, jt, jr, jf, want_curve=curve, log_cfg=jc)
    rep = run_simulation(tp, tt, tr, tf, want_curve=curve, device="cpu",
                         log_cfg=tc)
    assert (rep.mode, rep.rounds, rep.coverage, rep.msgs, rep.curve) == \
        (ref.mode, ref.rounds, ref.coverage, ref.msgs, ref.curve)
    assert rep.meta["truth"] == ref.meta["truth"]
    assert rep.meta["engine"] == "log-xla"
    with pytest.raises(ValueError, match="XLA pull kernels only"):
        run_simulation(tp, tt, TC.RunConfig(engine="fused"), tf,
                       device="cpu", log_cfg=tc)


# -- the command line --------------------------------------------------

SAME = ("mode", "n", "keys", "capacity", "rounds", "log_conv", "converged",
        "truth", "msgs", "devices", "fault_program", "curve")


def _both_cli(capsys, args):
    from gossip_tpu import cli as jcli
    capsys.readouterr()
    assert jcli.main(args + ["--no-compile-cache"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: out.get(k) for k in SAME} == {k: ref.get(k) for k in SAME}
    assert list(out)[:len(ref)] == list(ref)
    return out


@pytest.mark.parametrize("name,args,want", [
    ("run", ["log", "--n", "32", "--max-rounds", "24", "--partition",
             "0:4:16", "--churn-event", "3:2:5", "--drop-ramp",
             "1:3:0.0:0.2"], None),
    ("scripted-curve", ["log", "--n", "16", "--keys", "2", "--send",
                        "0:0:0:9", "--send", "1:0:1:4", "--commit",
                        "2:0:3:1", "--curve", "--max-rounds", "12"], None),
    ("LG3", ["log", "--n", "64", "--keys", "2", "--send", "0:0:0:9",
             "--send", "1:0:1:4", "--commit", "2:0:3:1"],
     (8, 1.0, {"lens": [2, 0], "committed": [1, 0], "total_entries": 2},
      2048.0)),
    ("LG2", ["log", "--n", "4096", "--keys", "4", "--capacity", "16",
             "--partition", "0:8:2048", "--churn-event", "3:2:5",
             "--drop-ramp", "1:4:0.0:0.3"],
     (24, 1.0, {"lens": [4, 4, 4, 4], "committed": [2, 2, 0, 2],
                "total_entries": 16}, 236676.0)),
])
def test_cli_log_matches_reference(capsys, name, args, want):
    out = _both_cli(capsys, args)
    assert out["log_conv"] == 1.0 and out["converged"] is True
    if want is not None:
        assert (out["rounds"], out["log_conv"], out["truth"],
                out["msgs"]) == want


def test_cli_log_error_paths(capsys):
    assert cli.main(["log", "--send", "0:0:0:0", "--device", "cpu"]) == 2
    assert "values must be >= 1" in capsys.readouterr().err
    assert cli.main(["log", "--send", "0:0:0", "--device", "cpu"]) == 2
    assert "4 colon-separated" in capsys.readouterr().err
    capsys.readouterr()
    assert cli.main(["log", "--n", "64", "--devices", "4", "--device",
                     "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["engine"] == "log-sharded"


def test_shared_predicates_are_the_crdt_payloads():
    """The log's padding, no-injection round and liveness predicates are
    the CRDT payloads' own (one definition each), as in the reference."""
    assert LG.NO_ROUND == CR.NO_ROUND == JCR.NO_ROUND
    assert LG.alive_at_fn is CR.alive_at_fn
    assert LG.converged_count is CR.converged_count
