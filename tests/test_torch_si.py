"""The port's bool SI rounds (gossip_tpu_torch/models/si.py) and loops
(runtime/simulator.py) against the JAX package's, bitwise (tolerance 0).

Both packages run the same configuration from the same state, the port on
the CPU: ``seen``, ``round`` and ``msgs`` must be equal after every round,
for push, pull, push-pull, flood and anti-entropy (period 1 and 3), on the
complete graph and a neighbour table, with 1 and 40 rumors, under no
fault, drops, deaths and both.  The reference runs live, its executable
store off.
"""

import jax
import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.models.si import coverage as j_coverage
from gossip_tpu.models.si import make_si_round as j_make_si_round
from gossip_tpu.models.state import alive_mask as j_alive_mask
from gossip_tpu.models.state import init_state as j_init_state
from gossip_tpu.runtime import simulator as JS
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import state as S
from gossip_tpu_torch.models.si import coverage, make_si_round
from gossip_tpu_torch.runtime import simulator as TS
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
N = 240
ROUNDS = 7
FAULTS = {"none": None, "drop": dict(drop_prob=0.05),
          "death": dict(node_death_rate=0.1, seed=4),
          "both": dict(node_death_rate=0.1, drop_prob=0.05, seed=2)}


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _topos(family):
    if family == "complete":
        return JG.complete(N), G.complete(N)
    if family == "ring":
        return JG.ring(N, 4), G.ring(N, 4, CPU)
    j = JG.erdos_renyi(N, 0.03, seed=2)
    return j, G.erdos_renyi(N, 0.03, seed=2, device=CPU)


def _configs(mode, rumors, fault, period=1, fanout=2, seed=5):
    kw = dict(mode=mode, fanout=fanout, rumors=rumors, period=period)
    f = FAULTS[fault]
    return ((JC.ProtocolConfig(**kw), JC.RunConfig(seed=seed),
             None if f is None else JC.FaultConfig(**f)),
            (TC.ProtocolConfig(**kw), TC.RunConfig(seed=seed),
             None if f is None else TC.FaultConfig(**f)))


def _assert_same(jst, tst):
    seen, rnd, key, msgs = S.state_to_numpy(tst)
    np.testing.assert_array_equal(seen, np.asarray(jst.seen))
    assert rnd == int(jst.round)
    np.testing.assert_array_equal(key, np.asarray(
        jax.random.key_data(jst.base_key)))
    assert msgs == np.float32(jst.msgs)


CASES = [(mode, family, rumors, fault, period)
         for mode, period in (("push", 1), ("pull", 1), ("pushpull", 1),
                              ("antientropy", 1), ("antientropy", 3))
         for family, rumors in (("complete", 1), ("erdos_renyi", 40))
         for fault in FAULTS] + \
        [("flood", "ring", rumors, fault, 1)
         for rumors in (1, 40) for fault in FAULTS]


@pytest.mark.parametrize("mode,family,rumors,fault,period", CASES)
def test_round_matches_reference(mode, family, rumors, fault, period):
    jt, tt = _topos(family)
    (jp, jr, jf), (tp, tr, tf) = _configs(mode, rumors, fault, period)
    jstep = jax.jit(j_make_si_round(jp, jt, jf, jr.origin))
    tstep = make_si_round(tp, tt, tf, tr.origin, CPU)
    jst, tst = j_init_state(jr, jp, N), S.init_state(tr, tp, N, CPU)
    _assert_same(jst, tst)
    for _ in range(ROUNDS):
        jst, tst = jstep(jst), tstep(tst)
        _assert_same(jst, tst)
    assert np.asarray(jst.seen).sum() > rumors      # the rumor spread
    ja = j_alive_mask(jf, N, jr.origin)
    ta = S.alive_mask(tf, N, tr.origin, CPU)
    assert coverage(tst.seen, ta) == float(j_coverage(jst.seen, ja))


def test_mid_run_state_carries_across():
    jt, tt = _topos("erdos_renyi")
    (jp, jr, jf), (tp, tr, tf) = _configs("pushpull", 3, "both")
    jstep = jax.jit(j_make_si_round(jp, jt, jf, jr.origin))
    jst = j_init_state(jr, jp, N)
    for _ in range(3):
        jst = jstep(jst)
    tst = S.state_from_numpy(np.asarray(jst.seen), int(jst.round),
                             np.asarray(jax.random.key_data(jst.base_key)),
                             np.float32(jst.msgs), CPU)
    tt2 = G.topology_from_numpy(np.asarray(jt.nbrs), np.asarray(jt.deg),
                                N, jt.family, CPU)
    tstep = make_si_round(tp, tt2, tf, tr.origin, CPU)
    for _ in range(4):
        jst, tst = jstep(jst), tstep(tst)
        _assert_same(jst, tst)


def test_alive_mask_matches_reference():
    for rate, seed in ((0.1, 0), (0.5, 7), (0.02, -3)):
        jf = JC.FaultConfig(node_death_rate=rate, seed=seed)
        tf = TC.FaultConfig(node_death_rate=rate, seed=seed)
        np.testing.assert_array_equal(
            S.alive_mask(tf, 5000, 17, CPU).numpy(),
            np.asarray(j_alive_mask(jf, 5000, 17)))
    assert S.alive_mask(None, 10, 0, CPU) is None


@pytest.mark.parametrize("mode,family,fault", [
    ("push", "complete", "none"), ("pushpull", "erdos_renyi", "both"),
    ("flood", "ring", "drop"), ("antientropy", "complete", "death")])
def test_loops_match_reference(mode, family, fault):
    jt, tt = _topos(family)
    (jp, _, jf), (tp, _, tf) = _configs(mode, 2, fault, fanout=1)
    jr = JC.RunConfig(seed=3, max_rounds=30, target_coverage=0.9)
    tr = TC.RunConfig(seed=3, max_rounds=30, target_coverage=0.9)
    ju = JS.simulate_until(jp, jt, jr, jf)
    tu = TS.simulate_until(tp, tt, tr, tf, CPU)
    assert (tu.rounds, tu.coverage, tu.msgs) == (ju.rounds, ju.coverage,
                                                 ju.msgs)
    _assert_same(ju.state, tu.state)
    jc = JS.simulate_curve(jp, jt, jr, jf)
    tc = TS.simulate_curve(tp, tt, tr, tf, CPU)
    np.testing.assert_array_equal(tc.coverage, jc.coverage)
    np.testing.assert_array_equal(tc.msgs, jc.msgs)
    assert tc.rounds_to_target == jc.rounds_to_target
    assert tc.final_coverage == jc.final_coverage
    _assert_same(jc.state, tc.state)


def test_refusals():
    _, tt = _topos("complete")
    for mode in ("swim", "rumor"):
        with pytest.raises(ValueError, match=f"models/{mode}.py"):
            make_si_round(TC.ProtocolConfig(mode=mode), tt, device=CPU)
    with pytest.raises(ValueError, match="neighbor table"):
        make_si_round(TC.ProtocolConfig(mode="flood"), tt, device=CPU)
    with pytest.raises(ValueError, match="node ids"):
        make_si_round(TC.ProtocolConfig(mode="pull"), tt,
                      TC.FaultConfig(churn=TC.ChurnConfig(
                          events=((N, 1, 4),))), device=CPU)
