"""The port's bit-packed rounds (gossip_tpu_torch/models/si_packed.py)
against the JAX package's, bitwise (tolerance 0).

Pull and anti-entropy, on the implicit complete graph and a neighbour
table, under no fault, drops, deaths and both, with R = 1, 33 and 64
rumors: the packed round's ``seen`` (uint32 words), ``round`` and
``msgs`` after every round, and ``simulate_until_packed``'s rounds,
coverage, msgs and final state.  Also the port's packed round against its
own bool round (the reference's packed == unpacked anchor), the packing
helpers, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu import config as JC
from gossip_tpu.models import si_packed as JP
from gossip_tpu.ops import bitpack as JB
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch import config as TC
from gossip_tpu_torch.models import si_packed as P
from gossip_tpu_torch.models import state as S
from gossip_tpu_torch.models.si import make_si_round
from gossip_tpu_torch.ops import bitpack as B
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")
N = 200
FAULTS = {"none": None, "drop": dict(drop_prob=0.05),
          "death": dict(node_death_rate=0.1, seed=6),
          "both": dict(node_death_rate=0.1, drop_prob=0.05, seed=1)}


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _topos(family):
    if family == "complete":
        return JG.complete(N), G.complete(N)
    return (JG.watts_strogatz(N, 4, 0.2, seed=1),
            G.watts_strogatz(N, 4, 0.2, seed=1, device=CPU))


def _configs(mode, rumors, fault, seed=11, **run):
    kw = dict(mode=mode, fanout=2, rumors=rumors,
              period=3 if mode == "antientropy" else 1)
    f = FAULTS[fault]
    return ((JC.ProtocolConfig(**kw), JC.RunConfig(seed=seed, **run),
             None if f is None else JC.FaultConfig(**f)),
            (TC.ProtocolConfig(**kw), TC.RunConfig(seed=seed, **run),
             None if f is None else TC.FaultConfig(**f)))


def _assert_same(jst, tst):
    seen, rnd, key, msgs = S.state_to_numpy(tst)
    np.testing.assert_array_equal(seen, np.asarray(jst.seen))
    assert rnd == int(jst.round)
    np.testing.assert_array_equal(key, np.asarray(
        jax.random.key_data(jst.base_key)))
    assert msgs == np.float32(jst.msgs)


CASES = [(mode, family, fault, rumors)
         for mode in ("pull", "antientropy")
         for family in ("complete", "watts_strogatz")
         for fault, rumors in zip(FAULTS, (1, 33, 64, 1))]


@pytest.mark.parametrize("mode,family,fault,rumors", CASES)
def test_packed_round_matches_reference(mode, family, fault, rumors):
    jt, tt = _topos(family)
    (jp, jr, jf), (tp, tr, tf) = _configs(mode, rumors, fault)
    jstep = jax.jit(JP.make_packed_round(jp, jt, jf, jr.origin))
    tstep = P.make_packed_round(tp, tt, tf, tr.origin, device=CPU)
    jst = JP.init_packed_state(jr, jp, N)
    tst = P.init_packed_state(tr, tp, N, CPU)
    _assert_same(jst, tst)
    for _ in range(7):
        jst, tst = jstep(jst), tstep(tst)
        _assert_same(jst, tst)


@pytest.mark.parametrize("mode,family,fault,rumors", [
    ("pull", "complete", "none", 1), ("pull", "watts_strogatz", "both", 33),
    ("antientropy", "complete", "death", 64),
    ("antientropy", "watts_strogatz", "drop", 1)])
def test_until_packed_matches_reference(mode, family, fault, rumors):
    jt, tt = _topos(family)
    (jp, jr, jf), (tp, tr, tf) = _configs(mode, rumors, fault,
                                          max_rounds=40,
                                          target_coverage=0.95)
    jr_, jc, jm, jfinal = JP.simulate_until_packed(jp, jt, jr, jf)
    tr_, tc, tm, tfinal = P.simulate_until_packed(tp, tt, tr, tf, CPU)
    assert (tr_, tc, tm) == (jr_, jc, jm)
    _assert_same(jfinal, tfinal)


@pytest.mark.parametrize("mode,family,fault,rumors", [
    ("pull", "complete", "none", 40), ("pull", "watts_strogatz", "both", 5),
    ("antientropy", "complete", "drop", 2)])
def test_packed_equals_own_bool_round(mode, family, fault, rumors):
    _, tt = _topos(family)
    _, (tp, tr, tf) = _configs(mode, rumors, fault)
    pstep = P.make_packed_round(tp, tt, tf, tr.origin, device=CPU)
    ustep = make_si_round(tp, tt, tf, tr.origin, CPU)
    pst = P.init_packed_state(tr, tp, N, CPU)
    ust = S.init_state(tr, tp, N, CPU)
    for _ in range(6):
        pst, ust = pstep(pst), ustep(ust)
    assert torch.equal(B.unpack(pst.seen, rumors), ust.seen)
    assert pst.msgs.item() == ust.msgs.item()


@pytest.mark.parametrize("r", [1, 3, 32, 33, 100])
def test_pack_unpack_and_coverage_match_reference(r):
    rng = np.random.default_rng(r)
    seen = rng.random((57, r)) < 0.3
    alive = rng.random(57) < 0.8
    jpacked = np.asarray(JB.pack(jnp.asarray(seen)))
    tpacked = B.pack(torch.from_numpy(seen))
    np.testing.assert_array_equal(tpacked.numpy().view(np.uint32), jpacked)
    np.testing.assert_array_equal(B.unpack(tpacked, r).numpy(), seen)
    for a in (None, alive):
        want = float(JB.coverage_packed(
            jnp.asarray(jpacked), r, None if a is None else jnp.asarray(a)))
        got = B.coverage_packed(tpacked, r,
                                None if a is None else torch.from_numpy(a))
        assert got == want
    assert B.n_words(r) == JB.n_words(r)


def test_refuses_push_modes_and_table_kernel_sampler():
    _, tt = _topos("complete")
    for mode in ("push", "pushpull", "flood"):
        with pytest.raises(ValueError, match="pull/antientropy"):
            P.make_packed_round(TC.ProtocolConfig(mode=mode), tt,
                                device=CPU)
    _, tw = _topos("watts_strogatz")
    with pytest.raises(ValueError, match="implicit complete"):
        P.make_packed_round(TC.ProtocolConfig(mode="pull"), tw,
                            sampler="kernel", device=CPU)
    with pytest.raises(ValueError, match="unknown sampler"):
        P.make_packed_round(TC.ProtocolConfig(mode="pull"), tt,
                            sampler="pallas", device=CPU)
