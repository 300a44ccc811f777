"""The port's fused multi-rumor round against the JAX package, on the CPU.

Both routes of the port's round (gossip_tpu_torch/ops/fused_mr_round.py)
run their plain versions on a CPU tensor.  They are held bitwise
(np.array_equal on the uint32 view, tolerance 0) against the JAX
package on the same numpy-made inputs: the value route against
``fused_multirumor_pull_round(interpret=True, inject_bits=...)``, which
runs the kernel's pure-JAX twin ``_fused_mr_round_ref``, over the grid of
tests/test_pallas_round.py and the fault operands; the staged route
against ``_fused_mr_round_big`` in its reference lowering; the two
routes against each other on the port's own Philox stream; the layout
helpers and the state; and the whole loop replayed round by round.  The
reference runs with its executable store off (GOSSIP_COMPILE_CACHE="").
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu.ops import pallas_round as J
from gossip_tpu_torch.config import FaultConfig
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops.fused_round import drop_threshold_for
from _torch_reference import CPU, as_port, as_u32, jax_mr_replay


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _bits(rng, rows, fanout):
    sbits = rng.integers(0, 2**32, size=(fanout, 8, MR.LANES),
                         dtype=np.uint32)
    rbits = rng.integers(0, 2**32, size=(fanout, rows, MR.LANES),
                         dtype=np.uint32)
    return sbits, rbits


def _table(rng, n, rumors, p=0.05):
    return np.asarray(J.word_pack(jnp.asarray(rng.random((n, rumors)) < p)))


def _faults(rng, n, faults):
    """(drop threshold, alive words, cut words) as uint32 numpy."""
    thr = (J.drop_threshold_for(FaultConfig(drop_prob=0.3))
           if faults in ("drop", "all") else 0)
    alive = (np.asarray(J.render_alive_words(
        jnp.asarray(rng.random(n) < 0.8), n))
        if faults in ("alive", "all") else None)
    cut = (np.asarray(J.render_cut_words(n // 3, n))
           if faults in ("cut", "all") else None)
    return thr, alive, cut


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("rumors", [1, 5, 32])
@pytest.mark.parametrize("n", [200, 128 * 16 + 1, 5000])
def test_layout_helpers_match_reference(n, rumors):
    rng = np.random.default_rng(n + rumors)
    seen = rng.random((n, rumors)) < 0.3
    want = np.asarray(J.word_pack(jnp.asarray(seen)))
    got = MR.word_pack(torch.from_numpy(seen))
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(MR.word_unpack(got, n, rumors).numpy(),
                                  np.asarray(J.word_unpack(
                                      jnp.asarray(want), n, rumors)))
    assert MR.coverage_words(got, n, rumors) == \
        float(J.coverage_words(jnp.asarray(want), n, rumors))
    np.testing.assert_array_equal(MR.rumor_counts(got, rumors).numpy(),
                                  seen.sum(axis=0))
    alive = rng.random(n) < 0.7
    alive_w = np.asarray(J.render_alive_words(jnp.asarray(alive), n))
    np.testing.assert_array_equal(
        as_u32(MR.render_alive_words(torch.from_numpy(alive), n)), alive_w)
    assert MR.coverage_words_alive(got, as_port(alive_w), rumors) == \
        float(J.coverage_words_alive(jnp.asarray(want),
                                     jnp.asarray(alive_w), rumors))
    for cut in (0, 1, n // 3, n - 1, n):
        np.testing.assert_array_equal(
            as_u32(MR.render_cut_words(cut, n, CPU)),
            np.asarray(J.render_cut_words(cut, n)))
    for origin in (0, n - 3):
        ref = J.init_multirumor_state(n, rumors, origin)
        st = MR.init_multirumor_state(n, rumors, origin, CPU)
        np.testing.assert_array_equal(as_u32(st.table),
                                      np.asarray(ref.table))
        assert st.round == int(ref.round) and st.msgs == float(ref.msgs)
    assert MR.fused_table_bytes(n, rumors) == J.fused_table_bytes(n, rumors)
    assert MR.check_fused_fits(n, rumors, CPU) == \
        J.fused_table_bytes(n, rumors)


def test_more_than_32_rumors_refused():
    with pytest.raises(ValueError, match="32 rumors"):
        MR.word_pack(torch.zeros(64, 33, dtype=torch.bool))
    with pytest.raises(ValueError, match="32 rumors"):
        MR.init_multirumor_state(64, 33, 0, CPU)


@pytest.mark.parametrize("n,r,fanout", [(128 * 16, 8, 1),
                                        (128 * 16 - 29, 32, 1),
                                        (128 * 24, 3, 2)])
def test_value_route_matches_reference(n, r, fanout):
    rng = np.random.default_rng(5 + n + r)
    table = _table(rng, n, r)
    bits = _bits(rng, J.mr_rows(n), fanout)
    want = np.asarray(J.fused_multirumor_pull_round(
        jnp.asarray(table), 0, 0, n, fanout, interpret=True,
        inject_bits=bits))
    pop = torch.zeros(32, dtype=torch.int32)
    got = MR.fused_multirumor_pull_round(as_port(table), 0, 0, n, fanout,
                                         inject_bits=bits, rumors=r,
                                         pop=pop)
    assert not np.array_equal(want, table)
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(
        pop.numpy()[:r], np.asarray(J.word_unpack(jnp.asarray(want), n, r))
        .sum(axis=0))
    assert not pop[r:].any()


# every operand set at fanout 1 and 2, then all of them at fanout 3 and 4
# (the kernel's one-Philox-call class) and 5 (a second call a word)
@pytest.mark.parametrize("faults,fanout", [
    *((f, fo) for fo in (1, 2) for f in ("drop", "alive", "cut", "all")),
    ("all", 3), ("all", 4), ("all", 5)])
def test_value_route_fault_operands_match_reference(faults, fanout):
    n = 128 * 16 - 29
    rng = np.random.default_rng(7 + fanout)
    table = _table(rng, n, 32, 0.2)
    bits = _bits(rng, J.mr_rows(n), fanout)
    thr, alive, cut = _faults(rng, n, faults)
    want = np.asarray(J.fused_multirumor_pull_round(
        jnp.asarray(table), 0, 0, n, fanout, interpret=True,
        inject_bits=bits, drop_threshold=thr,
        alive_words=_opt(alive, jnp.asarray),
        cut_words=_opt(cut, jnp.asarray)))
    got = MR.fused_multirumor_pull_round(
        as_port(table), 0, 0, n, fanout, inject_bits=bits,
        drop_threshold=thr, alive_words=_opt(alive, as_port),
        cut_words=_opt(cut, as_port))
    np.testing.assert_array_equal(as_u32(got), want)


def test_drop_coin_boundary_matches_reference():
    """Draws whose coin field sits exactly at the threshold or one below
    it: a pull is kept iff ``rb >> 12 >= thr``."""
    n = 128 * 16
    rng = np.random.default_rng(9)
    table = _table(rng, n, 32, 0.5)
    sbits, rbits = _bits(rng, J.mr_rows(n), 1)
    thr = J.drop_threshold_for(FaultConfig(drop_prob=0.3))
    coin = np.where(rng.random(rbits.shape) < 0.5, thr, thr - 1)
    rbits = (coin.astype(np.uint32) << np.uint32(12)) | (rbits & 0xFFF)
    want = np.asarray(J.fused_multirumor_pull_round(
        jnp.asarray(table), 0, 0, n, 1, interpret=True,
        inject_bits=(sbits, rbits), drop_threshold=thr))
    for route in (MR.fused_multirumor_pull_round, MR.fused_mr_round_big):
        got = route(as_port(table), 0, 0, n, 1, inject_bits=(sbits, rbits),
                    drop_threshold=thr)
        assert not np.array_equal(want, table)
        np.testing.assert_array_equal(as_u32(got), want)


@pytest.mark.parametrize("faults", ["none", "all"])
@pytest.mark.parametrize("fanout", [1, 2])
@pytest.mark.parametrize("n", [128 * 16, 128 * 24 - 37])
def test_staged_route_matches_reference(n, fanout, faults):
    rng = np.random.default_rng(11 + n + fanout)
    table = _table(rng, n, 32, 0.03)
    bits = _bits(rng, J.mr_rows(n), fanout)
    thr, alive, cut = _faults(rng, n, faults)
    want = np.asarray(J._fused_mr_round_big(
        jnp.asarray(table), 0, 0, n, True, bits, fanout=fanout,
        drop_threshold=thr, alive_words=_opt(alive, jnp.asarray),
        cut_words=_opt(cut, jnp.asarray)))
    pop = torch.zeros(32, dtype=torch.int32)
    got = MR.fused_mr_round_big(
        as_port(table), 0, 0, n, fanout, bits, thr, _opt(alive, as_port),
        _opt(cut, as_port), pop=pop)
    assert not np.array_equal(want, table)
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(pop.numpy(),
                                  MR.rumor_counts(got, 32).numpy())


def test_gather_pass_matches_reference_rotation():
    """One staged pass by hand: the port's rotation equals the
    reference's ``_rotate_rows_xla``, and the plain gather on it equals
    the reference's one-draw staged round."""
    n = 128 * 24 - 37
    rng = np.random.default_rng(13)
    table = _table(rng, n, 32, 0.1)
    sbits, rbits = _bits(rng, J.mr_rows(n), 1)
    rot = MR.rotate_rows(as_port(table), torch.from_numpy(
        sbits[0, 0].view(np.int32)))
    np.testing.assert_array_equal(
        as_u32(rot), np.asarray(J._rotate_rows_xla(
            jnp.asarray(table), jnp.asarray(sbits[0]), J.mr_rows(n))))
    got = MR.mr_gather_plain(as_port(table), rot, as_port(rbits[0]), n)
    want = np.asarray(J._fused_mr_round_big(
        jnp.asarray(table), 0, 0, n, True, (sbits, rbits)))
    np.testing.assert_array_equal(as_u32(got), want)


@pytest.mark.parametrize("fanout,faults", [(1, "none"), (2, "all"),
                                           (5, "drop")])
def test_routes_equal_on_the_philox_stream(fanout, faults):
    n = 128 * 24 - 37
    rng = np.random.default_rng(17 + fanout)
    table = as_port(_table(rng, n, 32, 0.05))
    thr, alive, cut = _faults(rng, n, faults)
    kw = dict(drop_threshold=thr, alive_words=_opt(alive, as_port),
              cut_words=_opt(cut, as_port), rumors=32)
    routes = (MR.fused_multirumor_pull_round, MR.fused_mr_round_big)
    pops = [torch.zeros(32, dtype=torch.int32) for _ in routes]
    value, staged = (route(table, 3, 4, n, fanout, pop=p, **kw)
                     for p, route in zip(pops, routes))
    assert not torch.equal(value, table)
    assert torch.equal(value, staged) and torch.equal(*pops)
    # the stream is the one the plain value round draws
    assert torch.equal(value, MR.fused_mr_round_plain(
        table, 3, 4, n, fanout, None, thr, kw["alive_words"],
        kw["cut_words"]))


def test_round_argument_refusals():
    n = 128 * 16
    t = MR.init_multirumor_state(n, 8, 0, CPU).table
    for route in (MR.fused_multirumor_pull_round, MR.fused_mr_round_big):
        with pytest.raises(ValueError, match="out must not be"):
            route(t, 0, 0, n, out=t)
        with pytest.raises(ValueError, match="does not fit"):
            route(t, 0, 0, n + 1)
        with pytest.raises(ValueError, match="fanout"):
            route(t, 0, 0, n, fanout=0)
    with pytest.raises(ValueError, match="32 rumors"):
        MR.fused_multirumor_pull_round(t, 0, 0, n, rumors=33)
    with pytest.raises(ValueError, match="int32"):
        MR.fused_multirumor_pull_round(t.to(torch.int64), 0, 0, n)


@pytest.mark.parametrize("fanout,drop_prob", [(1, 0.0), (2, 0.05)])
def test_whole_loop_matches_reference_replay(fanout, drop_prob):
    n, rumors, seed, target = 128 * 24 - 37, 8, 3, 0.99
    fault = FaultConfig(drop_prob=drop_prob) if drop_prob else None
    tables, rounds, msgs, cov = jax_mr_replay(n, rumors, seed, fanout,
                                              target, 128, drop_prob)
    final, got_cov = MR.until_fused_multirumor(n, rumors, seed, fanout,
                                               target, 128, fault=fault,
                                               device=CPU)
    assert final.round == rounds > 5
    assert final.msgs == msgs and got_cov == cov
    np.testing.assert_array_equal(as_u32(final.table), tables[-1])
    # the same loop stepped one round at a time: equal after every round
    st = MR.init_multirumor_state(n, rumors, 0, CPU)
    for r, want in enumerate(tables):
        st, _ = MR.until_fused_multirumor(n, rumors, seed, fanout, target,
                                          r + 1, fault=fault, device=CPU,
                                          state=st)
        assert st.round == r + 1
        np.testing.assert_array_equal(as_u32(st.table), want)
    # the curve loop runs the same rounds
    st, covs = MR.curve_fused_multirumor(n, rumors, seed, fanout, rounds,
                                         fault=fault, device=CPU)
    np.testing.assert_array_equal(as_u32(st.table), tables[-1])
    assert covs[-1] == cov and st.msgs == msgs
    cov_jit = jax.jit(J.coverage_words, static_argnums=(1, 2))
    assert covs == [float(cov_jit(jnp.asarray(t), n, rumors))
                    for t in tables]
    # the staged round, stepped by hand, runs the same rounds
    table = MR.init_multirumor_state(n, rumors, 0, CPU).table
    for r, want in enumerate(tables):
        table = MR.fused_mr_round_big(table, seed, r, n, fanout,
                                      drop_threshold=drop_threshold_for(fault),
                                      rumors=rumors)
        np.testing.assert_array_equal(as_u32(table), want)


def _first_nodes_words(n, count, rumors):
    """uint32[mr_rows(n), 128]: every rumor held by nodes 0..count-1."""
    flat = np.zeros(J.mr_rows(n) * MR.LANES, np.uint32)
    flat[:count] = (1 << rumors) - 1
    return flat.reshape(-1, MR.LANES)


def test_stop_test_is_the_compiled_product():
    """At n = 1600 with 1584 nodes holding every rumor the reference's
    compiled condition reads 0.98999995 < 0.99 and runs another round
    where the quotient reads 0.99: the port's loop runs on too."""
    n, count, rumors = 1600, 1584, 4
    table = _first_nodes_words(n, count, rumors)
    cond_cov = jax.jit(J.fused_mr_cov_fn(n, rumors, None))(jnp.asarray(table))
    assert bool(cond_cov < jnp.float32(0.99))
    assert MR.coverage_words(as_port(table), n, rumors) == \
        float(np.float32(0.99))
    st = MR.FusedState(as_port(table), 5, np.float32(0.0))
    final, cov = MR.until_fused_multirumor(n, rumors, 0, max_rounds=64,
                                           device=CPU, state=st)
    assert final.round > 5 and cov >= np.float32(0.99)
    final, cov = MR.until_fused_multirumor(n, rumors, 0, max_rounds=5,
                                           device=CPU, state=st)
    assert final.round == 5 and cov == float(cond_cov)


def test_curve_values_are_the_jitted_coverage():
    """For every count at n = 1000 the loops' coverage equals
    ``jax.jit(coverage_words)``; the eager quotient differs by an ulp at
    some counts."""
    n, rumors = 1000, 3
    jitted = jax.jit(J.coverage_words, static_argnums=(1, 2))
    cov_of = MR.loop_coverage_words(n, rumors, None, None)
    differs = 0
    for count in range(n + 1):
        want = float(jitted(jnp.asarray(_first_nodes_words(n, count, rumors)),
                            n, rumors))
        assert cov_of([count, count + 1, count]) == want, count
        differs += want != MR.f32_fraction(count, n)
    assert differs > 0


@pytest.mark.parametrize("n,fanout,faults", [
    *((n, fo, f) for f in ("none", "drop", "alive", "cut", "all")
      for fo in (1, 2) for n in (128 * 24, 128 * 16 - 29)),
    *((n, fo, "all") for fo in (3, 4, 5) for n in (128 * 24, 128 * 16 - 29))])
def test_lanes_plain_matches_reference(n, fanout, faults):
    """The lane-major plain round equals the reference's
    ``_fused_mr_round_ref`` under injected bits, with the table, the
    operands and each draw's bits transposed at the test boundary."""
    rng = np.random.default_rng(23 + n + fanout)
    table = _table(rng, n, 32, 0.1)
    sbits, rbits = _bits(rng, J.mr_rows(n), fanout)
    thr, alive, cut = _faults(rng, n, faults)
    want = np.asarray(J._fused_mr_round_ref(
        jnp.asarray(table), n, fanout, (sbits, rbits), thr,
        _opt(alive, jnp.asarray), _opt(cut, jnp.asarray)))

    def lanes(a):
        return as_port(a.T)
    got = MR.fused_mr_round_lanes_plain(
        lanes(table), 0, 0, n, fanout,
        (as_port(sbits), as_port(rbits.transpose(0, 2, 1))), thr,
        _opt(alive, lanes), _opt(cut, lanes))
    assert not np.array_equal(want, table)
    np.testing.assert_array_equal(as_u32(got).T, want)
    # the loops' dispatch runs it on the CPU, counts and all
    pop = torch.zeros(32, dtype=torch.int32)
    again = MR.fused_mr_round_lanes(
        lanes(table), 0, 0, n, fanout,
        MR.lanes_bits((sbits, rbits), CPU), thr, _opt(alive, lanes),
        _opt(cut, lanes), pop=pop)
    assert torch.equal(again, got)
    np.testing.assert_array_equal(pop.numpy(), MR.rumor_counts(got, 32))


@pytest.mark.parametrize("deaths", [0.0, 0.1])
@pytest.mark.parametrize("fanout", [1, 2])
def test_lane_major_loops_end_in_the_row_major_table(fanout, deaths):
    """The loops' lane-major buffers (entry and exit transposes, a state
    carried over, deaths) end in the table, round and msgs that the
    row-major round stepped by hand reaches, and the curve loop in the
    same table."""
    n, rumors, seed, rounds = 128 * 24 - 37, 8, 6, 7
    fault = FaultConfig(node_death_rate=deaths, drop_prob=0.05)
    alive, thr = MR.fault_masks_word(fault, n, device=CPU)
    rng = np.random.default_rng(31 + fanout)
    start = MR.word_pack(torch.from_numpy(rng.random((n, rumors)) < 0.01))
    table, msgs = start, np.float32(1.0)
    for r in range(2, 2 + rounds):
        table = MR.fused_mr_round_plain(table, seed, r, n, fanout, None, thr,
                                        alive)
        msgs = np.float32(msgs + np.float32(2.0 * fanout * n))
    final, _ = MR.until_fused_multirumor(
        n, rumors, seed, fanout, target_coverage=1.0,
        max_rounds=2 + rounds, fault=fault, device=CPU,
        state=MR.FusedState(start, 2, np.float32(1.0)))
    assert (final.round, final.msgs) == (2 + rounds, msgs)
    assert final.table.shape == start.shape and final.table.is_contiguous()
    assert torch.equal(final.table, table)
    curve, _ = MR.curve_fused_multirumor(n, rumors, seed, fanout, rounds,
                                         fault=fault, device=CPU)
    table = MR.init_multirumor_state(n, rumors, 0, CPU).table
    for r in range(rounds):
        table = MR.fused_mr_round_plain(table, seed, r, n, fanout, None, thr,
                                        alive)
    assert torch.equal(curve.table, table)


@pytest.mark.parametrize("origin", [0, 5])
def test_fresh_state_coverage_is_one_node_per_rumor(origin):
    """The loop's first stop test on a fresh state: 1/n for every rumor
    count, as the reference counts it, so a target at 1/n runs no round
    and one just above it runs the reference's rounds."""
    n, rumors = 1000, 32
    one = float(np.float32(1) / np.float32(n))
    st = MR.init_multirumor_state(n, rumors, origin, CPU)
    assert MR.coverage_words(st.table, n, rumors) == one == float(
        J.coverage_words(J.init_multirumor_state(n, rumors, origin).table,
                         n, rumors))
    final, cov = MR.until_fused_multirumor(n, rumors, 0, target_coverage=1 / n,
                                           origin=origin, device=CPU)
    assert final.round == 0 and cov == one
    if origin == 0:
        _, rounds, _, want = jax_mr_replay(n, rumors, 0, 1, 1.5 / n, 128, 0.0)
        final, cov = MR.until_fused_multirumor(
            n, rumors, 0, target_coverage=1.5 / n, device=CPU)
        assert final.round == rounds >= 1 and cov == want


def test_deaths_run_and_need_alive_words():
    """Deaths run on the fused route, with the alive words that the
    loops render.  Under the seed-0 draw at rate 0.1 node 1 is dead, so
    rumor 1 (started there) never spreads: both loops keep its coverage
    at 0, as the reference does."""
    fault = FaultConfig(node_death_rate=0.1)
    alive, _ = MR.fault_masks_word(fault, 4096, device=CPU)
    assert alive is not None
    assert not int(MR.to_words(alive).reshape(-1)[1]) & 1
    final, cov = MR.until_fused_multirumor(4096, 4, 0, max_rounds=12,
                                           fault=fault, device=CPU)
    assert final.round == 12 and cov == 0.0
    _, covs = MR.curve_fused_multirumor(4096, 4, 0, max_rounds=12,
                                        fault=fault, device=CPU)
    assert covs == [0.0] * 12
    want = J.fused_mr_cov_fn(4096, 4, fault)(jnp.asarray(as_u32(
        final.table)))
    assert float(want) == 0.0


@pytest.mark.parametrize("carried", [False, True])
def test_death_stop_test_reads_the_counters(carried):
    """Under deaths both loops read the alive-weighted coverage from the
    kernel's counters less the bits held at dead nodes; it equals a
    recount of every round's table, from a fresh state (whose rumor 1
    starts at a dead node) and from a carried-over one with bits set at
    dead nodes."""
    n, rumors, target = 3000, 4, 0.9
    fault = FaultConfig(node_death_rate=0.1, drop_prob=0.05)
    alive, thr = MR.fault_masks_word(fault, n, device=CPU)
    if carried:
        rng = np.random.default_rng(7)
        seen = torch.from_numpy(rng.random((n, rumors)) < 0.05)
        st = MR.FusedState(MR.word_pack(seen), 3, np.float32(0.0))
        assert MR.rumor_counts(st.table & ~alive, rumors).min() > 0
    else:
        st = MR.init_multirumor_state(n, rumors, device=CPU)
    covs, tables = [], [st.table]
    for r in range(st.round, st.round + 12):
        tables.append(MR.fused_multirumor_pull_round(
            tables[-1], 0, r, n, drop_threshold=thr, alive_words=alive,
            rumors=rumors))
        # the recount: the eager alive-weighted coverage
        covs.append(MR.coverage_words_alive(tables[-1], alive, rumors))
    stop = next((i for i, c in enumerate(covs) if c >= np.float32(target)),
                len(covs) - 1)
    final, cov = MR.until_fused_multirumor(
        n, rumors, 0, target_coverage=target, max_rounds=st.round + 12,
        fault=fault, device=CPU,
        state=st._replace(table=st.table.clone()) if carried else None)
    assert (final.round, cov) == (st.round + stop + 1, covs[stop])
    assert torch.equal(final.table, tables[stop + 1])
    if not carried:
        _, curve = MR.curve_fused_multirumor(n, rumors, 0, max_rounds=12,
                                             fault=fault, device=CPU)
        assert curve == covs


@pytest.mark.parametrize("seed", [0, 1])
def test_rounds_to_target_in_mean_field_window(seed):
    """Rounds to min-over-rumors 0.99 on the port's stream at n = 2^17
    lie in the window of tests/test_pallas_round.py's hardware-PRNG
    check: the mean-field count (c' = 1-(1-c)^2 from c0 = 1/n) minus
    one to plus four."""
    n, rumors = 1 << 17, 8
    final, cov = MR.until_fused_multirumor(n, rumors, seed, max_rounds=64,
                                           device=CPU)
    c, want = 1.0 / n, 0
    while c < 0.99:
        c = 1 - (1 - c) ** 2
        want += 1
    assert want - 1 <= final.round <= want + 4, (final.round, want)
    assert cov >= np.float32(0.99)


def _warp_bit_matrix(words):
    """uint8[32, 32]: bit c of word r at [r, c]."""
    return ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .astype(np.uint8)


@pytest.mark.parametrize("density", [0.03, 0.5, 0.97])
def test_warp_bit_transpose_model_counts_each_rumor(density):
    """A numpy model of the count epilogue's warp transpose
    (csrc/rumor_counts.cuh): ``transpose_stage`` on 32 lanes, with the
    five stages' shifts and masks read from the header.  Afterwards lane b
    holds bit b of the 32 words, so its popcount is rumor b's count."""
    src = (_kernels.CSRC / "rumor_counts.cuh").read_text()
    stages = re.findall(
        r"transpose_stage\(x, (\d+), (0x[0-9A-Fa-f]+)u, lane\)", src)
    assert [int(s) for s, _ in stages] == [16, 8, 4, 2, 1]
    lane = np.arange(32, dtype=np.uint32)
    rng = np.random.default_rng(int(density * 100))
    words = np.zeros(32, np.uint32)
    for c in range(32):
        words |= (rng.random(32) < density).astype(np.uint32) << np.uint32(c)
    x = words.copy()
    for s, lo in stages:
        s, lo = np.uint32(int(s)), np.uint32(int(lo, 16))
        other = x[lane ^ s]                         # __shfl_xor_sync(x, s)
        x = np.where((lane & s) != 0, (x & ~lo) | ((other >> s) & lo),
                     (x & lo) | ((other << s) & ~lo))
    np.testing.assert_array_equal(_warp_bit_matrix(x),
                                  _warp_bit_matrix(words).T)
    np.testing.assert_array_equal(_warp_bit_matrix(x).sum(axis=1),
                                  _warp_bit_matrix(words).sum(axis=0))


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes renames the build, so a
    stale library is never loaded."""
    for path in _kernels.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    kernels = [_kernels.Kernel(k.name, k.source.name, k.entry, k.argtypes)
               for k in _kernels.KERNELS]
    assert all({p.name for p in k.sources()} >= {k.source.name,
                                                  "philox.cuh"}
               for k in kernels)
    before = [k.library() for k in kernels]
    with open(tmp_path / "philox.cuh", "a") as f:
        f.write("// edited\n")
    assert all(k.library() != b for k, b in zip(kernels, before))
