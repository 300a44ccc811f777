"""The port's fused single-rumor round against the JAX package, on the CPU.

The port's round (gossip_tpu_torch/ops/fused_round.py) runs its plain
version on a CPU tensor.  It is held bitwise (np.array_equal on the
uint32 view, tolerance 0) against the JAX package's
``fused_pull_round(interpret=True, inject_bits=...)``, which runs the
kernel's pure-JAX twin ``_fused_round_ref``, on the same inputs made
with numpy: one round over the grid of tests/test_pallas_round.py and
the fault operands, the packing and coverage helpers, the state, and the
whole loop replayed round by round on the port's own Philox bits.  The
port's stream is also checked for the statistics the TPU stream obeys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu.config import (ProtocolConfig as JProtocolConfig,
                               RunConfig as JRunConfig)
from gossip_tpu.models.si_packed import compiled_until_packed
from gossip_tpu.ops import pallas_round as J
from gossip_tpu.topology import generators as G
from gossip_tpu_torch.config import FaultConfig
from gossip_tpu_torch.ops import fused_round as FR
from _torch_reference import CPU, as_port, as_u32, jax_replay


def _random_bits(rng, rows, fanout, sharing=1):
    sbits = rng.integers(0, 2**32, size=(8, FR.LANES), dtype=np.uint32)
    rbits = rng.integers(0, 2**32, size=(fanout * 32 // sharing, rows,
                                         FR.LANES), dtype=np.uint32)
    return sbits, rbits


def _table(rng, n, p=0.03):
    return np.asarray(J.node_pack(jnp.asarray(rng.random(n) < p)))


@pytest.mark.parametrize("sharing", [1, 2])
@pytest.mark.parametrize("fanout", [1, 2])
@pytest.mark.parametrize("n", [4096 * 8, 4096 * 8 - 37, 4096 * 16])
def test_round_matches_reference_under_injected_bits(n, fanout, sharing):
    rng = np.random.default_rng(42 + n + fanout + sharing)
    table = _table(rng, n)
    bits = _random_bits(rng, J.n_rows(n), fanout, sharing)
    want = np.asarray(J.fused_pull_round(
        jnp.asarray(table), 0, 0, n, fanout, interpret=True,
        inject_bits=bits, plane_sharing=sharing))
    got = FR.fused_pull_round(as_port(table), 0, 0, n, fanout,
                              inject_bits=bits, plane_sharing=sharing)
    assert not np.array_equal(want, table)
    np.testing.assert_array_equal(as_u32(got), want)


@pytest.mark.parametrize("fanout", [1, 2])
@pytest.mark.parametrize("faults", ["drop", "alive", "cut", "all"])
def test_round_fault_operands_match_reference(faults, fanout):
    n = 4096 * 8 - 37
    rng = np.random.default_rng(5 + fanout)
    table = _table(rng, n, 0.1)
    bits = _random_bits(rng, J.n_rows(n), fanout)
    thr = (J.drop_threshold_for(FaultConfig(drop_prob=0.3))
           if faults in ("drop", "all") else 0)
    alive = (np.asarray(J.node_pack(jnp.asarray(rng.random(n) < 0.8)))
             if faults in ("alive", "all") else None)
    cut = (np.asarray(J.render_cut_bits(n // 3, n))
           if faults in ("cut", "all") else None)
    want = np.asarray(J.fused_pull_round(
        jnp.asarray(table), 0, 0, n, fanout, interpret=True,
        inject_bits=bits, drop_threshold=thr,
        alive_table=None if alive is None else jnp.asarray(alive),
        cut_words=None if cut is None else jnp.asarray(cut)))
    got = FR.fused_pull_round(
        as_port(table), 0, 0, n, fanout, inject_bits=bits, drop_threshold=thr,
        alive_table=None if alive is None else as_port(alive),
        cut_words=None if cut is None else as_port(cut))
    np.testing.assert_array_equal(as_u32(got), want)


def test_drop_coin_boundary_matches_reference():
    """Draws whose coin field sits exactly at the threshold or one below
    it: a pull is kept iff ``rb >> 12 >= thr``."""
    n = 4096 * 8
    rng = np.random.default_rng(9)
    table = _table(rng, n, 0.5)
    sbits, rbits = _random_bits(rng, J.n_rows(n), 1)
    thr = J.drop_threshold_for(FaultConfig(drop_prob=0.3))
    coin = np.where(rng.random(rbits.shape) < 0.5, thr, thr - 1)
    rbits = (coin.astype(np.uint32) << np.uint32(12)) | (rbits & 0xFFF)
    want = np.asarray(J.fused_pull_round(
        jnp.asarray(table), 0, 0, n, 1, interpret=True,
        inject_bits=(sbits, rbits), drop_threshold=thr))
    got = FR.fused_pull_round(as_port(table), 0, 0, n, 1,
                              inject_bits=(sbits, rbits), drop_threshold=thr)
    assert not np.array_equal(want, table)
    np.testing.assert_array_equal(as_u32(got), want)


@pytest.mark.parametrize("n", [50, 4096 * 8, 4096 * 8 + 1, 60000])
def test_pack_unpack_cut_bits_match_reference(n):
    rng = np.random.default_rng(n)
    inf = rng.random(n) < 0.3
    want = np.asarray(J.node_pack(jnp.asarray(inf)))
    got = FR.node_pack(torch.from_numpy(inf))
    np.testing.assert_array_equal(as_u32(got), want)
    np.testing.assert_array_equal(FR.node_unpack(got, n).numpy(),
                                  np.asarray(J.node_unpack(
                                      jnp.asarray(want), n)))
    for cut in (0, 1, n // 3, n - 1, n):
        np.testing.assert_array_equal(
            as_u32(FR.render_cut_bits(cut, n, CPU)),
            np.asarray(J.render_cut_bits(cut, n)))


@pytest.mark.parametrize("n", [50, 4096 * 8 - 37, 60000])
def test_coverage_matches_reference(n):
    rng = np.random.default_rng(n + 1)
    table = _table(rng, n, 0.4)
    alive = np.asarray(J.node_pack(jnp.asarray(rng.random(n) < 0.7)))
    assert FR.coverage_node_packed(as_port(table), n) == \
        float(J.coverage_node_packed(jnp.asarray(table), n))
    assert FR.coverage_node_packed_alive(as_port(table), as_port(alive)) == \
        float(J.coverage_node_packed_alive(jnp.asarray(table),
                                           jnp.asarray(alive)))


@pytest.mark.parametrize("n,origin", [(4096 * 8, 0), (4096 * 8, 31),
                                      (4096 * 8, 32), (4096 * 8, 4096),
                                      (4096 * 8 - 37, 4096 * 8 - 38),
                                      (60000, 12345)])
def test_init_state_and_round_trip_match_reference(n, origin):
    ref = J.init_fused_state(n, origin)
    got = FR.init_fused_state(n, origin, CPU)
    np.testing.assert_array_equal(as_u32(got.table), np.asarray(ref.table))
    assert got.round == int(ref.round) and got.msgs == float(ref.msgs)
    st = FR.state_from_numpy(np.asarray(ref.table), np.asarray(ref.round),
                             np.asarray(ref.msgs), CPU)
    table, round_, msgs = FR.state_to_numpy(st)
    assert table.dtype == np.uint32 and round_.dtype == np.int32
    assert msgs.dtype == np.float32
    np.testing.assert_array_equal(table, np.asarray(ref.table))
    assert round_ == ref.round and msgs == ref.msgs
    with pytest.raises(ValueError, match="out of range"):
        FR.init_fused_state(n, n, CPU)


def test_plane_sharing_validation():
    t = FR.init_fused_state(4096 * 8, 0, CPU).table
    with pytest.raises(ValueError, match="plane_sharing"):
        FR.fused_pull_round(t, 0, 0, 4096 * 8, 1, plane_sharing=3)
    with pytest.raises(ValueError, match="drop coin"):
        FR.fused_pull_round(t, 0, 0, 4096 * 8, 1, drop_threshold=1000,
                            plane_sharing=2)
    with pytest.raises(ValueError, match="drop coin"):
        FR.fused_pull_round(t, 0, 0, 4096 * 8, 1,
                            cut_words=FR.render_cut_bits(64, 4096 * 8, CPU),
                            plane_sharing=2)
    # a tensor threshold cannot be proven zero: refused like a traced one
    with pytest.raises(ValueError, match="traced"):
        FR.fused_pull_round(t, 0, 0, 4096 * 8, 1,
                            drop_threshold=torch.tensor(104858),
                            plane_sharing=2)


@pytest.mark.parametrize("drop_prob", [0.0, 0.05])
def test_whole_loop_matches_reference_replay(drop_prob):
    n, seed, fanout, target = 4096 * 8 - 37, 3, 1, 0.99
    fault = FaultConfig(drop_prob=drop_prob) if drop_prob else None
    tables, rounds, msgs, cov = jax_replay(n, seed, fanout, target, 128,
                                            drop_prob)
    final, got_cov = FR.until_fused(n, seed, fanout, target, 128,
                                    fault=fault, device=CPU)
    assert final.round == rounds > 5
    assert final.msgs == msgs and got_cov == cov
    np.testing.assert_array_equal(as_u32(final.table), tables[-1])
    # the same loop stepped one round at a time: equal after every round
    st = FR.init_fused_state(n, 0, CPU)
    for r, want in enumerate(tables):
        st, _ = FR.until_fused(n, seed, fanout, target, r + 1, fault=fault,
                               device=CPU, state=st)
        assert st.round == r + 1
        np.testing.assert_array_equal(as_u32(st.table), want)
    # the curve loop runs the same rounds and reads the same coverage
    st, covs = FR.curve_fused(n, seed, fanout, rounds, fault=fault,
                              device=CPU)
    np.testing.assert_array_equal(as_u32(st.table), tables[-1])
    assert covs[-1] == cov and st.msgs == msgs


def _first_nodes(n, count):
    """uint32[n_rows(n), 128]: the node-packed table of nodes 0..count-1."""
    bits = np.zeros(J.n_rows(n) * J.NODES_PER_ROW, np.uint8)
    bits[:count] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32) \
        .reshape(-1, FR.LANES)


def test_stop_test_is_the_compiled_product():
    """At n = 1600 with 1584 nodes informed the reference's compiled
    condition reads float32(1584) * float32(1/1600) = 0.98999995 < 0.99
    and runs another round, where the quotient reads 0.99 and would stop:
    the port's loop, from that state, runs one more round too."""
    n, count = 1600, 1584
    table = _first_nodes(n, count)
    cond_cov = jax.jit(J.fused_cov_fn(n, None))(jnp.asarray(table))
    assert bool(cond_cov < jnp.float32(0.99))
    assert FR.coverage_node_packed(as_port(table), n) == \
        float(np.float32(0.99))
    st = FR.state_from_numpy(table, 5, 0.0, CPU)
    final, cov = FR.until_fused(n, 0, target_coverage=0.99, max_rounds=64,
                                device=CPU, state=st)
    assert final.round > 5 and cov >= np.float32(0.99)
    # with nothing left to run the loop returns the compiled value
    final, cov = FR.until_fused(n, 0, target_coverage=0.99, max_rounds=5,
                                device=CPU,
                                state=FR.state_from_numpy(table, 5, 0.0, CPU))
    assert final.round == 5 and cov == float(cond_cov)


def test_curve_values_are_the_jitted_coverage():
    """For every count at n = 1000 the loops' coverage equals
    ``jax.jit(coverage_node_packed)``, which multiplies by the float32
    reciprocal; the eager quotient differs by an ulp at some counts."""
    n = 1000
    jitted = jax.jit(J.coverage_node_packed, static_argnums=1)
    cov_of = FR.loop_coverage(n, None, None)
    differs = 0
    for count in range(n + 1):
        want = float(jitted(jnp.asarray(_first_nodes(n, count)), n))
        assert cov_of(count) == want, count
        differs += want != FR.f32_fraction(count, n)
    assert differs > 0


@pytest.mark.parametrize("carried", [False, True])
def test_death_stop_test_reads_the_counter(carried):
    """Under deaths the loop reads the alive-weighted coverage from the
    kernel's counter less the bits held at dead nodes; it stops where a
    recount of every round's table first reaches the target, from a
    fresh state and from a carried-over one with bits set at dead
    nodes."""
    n, target = 4096 * 8 - 37, 0.9
    fault = FaultConfig(node_death_rate=0.1, drop_prob=0.05)
    alive, thr = FR.fault_masks_node_packed(fault, n, device=CPU)
    if carried:
        rng = np.random.default_rng(7)
        table = as_port(_table(rng, n))
        st = FR.FusedState(table, 2, np.float32(0.0))
        assert FR.popcount(table & ~alive) > 0
    else:
        st = FR.init_fused_state(n, 0, CPU)
    covs, tables = [], [st.table]
    for r in range(st.round, st.round + 12):
        tables.append(FR.fused_pull_round(tables[-1], 5, r, n,
                                          drop_threshold=thr,
                                          alive_table=alive))
        # the recount: the eager alive-weighted coverage
        covs.append(FR.coverage_node_packed_alive(tables[-1], alive))
    stop = next((i for i, c in enumerate(covs) if c >= np.float32(target)),
                len(covs) - 1)
    final, cov = FR.until_fused(
        n, 5, target_coverage=target, max_rounds=st.round + 12,
        fault=fault, device=CPU,
        state=st._replace(table=st.table.clone()) if carried else None)
    assert (final.round, cov) == (st.round + stop + 1, covs[stop])
    assert torch.equal(final.table, tables[stop + 1])


def test_philox_stream_tracks_mean_field():
    """One round on the port's own stream: c' = 1-(1-c)^2 within 0.02."""
    n = 4096 * 32
    rng = np.random.default_rng(7)
    inf = rng.random(n) < 0.2
    out = FR.fused_pull_round(FR.node_pack(torch.from_numpy(inf)), 0, 0, n)
    c = inf.mean()
    assert abs(FR.coverage_node_packed(out, n) - (1 - (1 - c) ** 2)) < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounds_to_target_match_threefry_twin(seed):
    """Rounds to 0.99 on the port's stream lie within 2 of the JAX
    package's threefry twin (models/si_packed) at n = 2^17."""
    n = 1 << 17
    proto = JProtocolConfig(mode="pull", fanout=1, rumors=1)
    run = JRunConfig(target_coverage=0.99, max_rounds=128, seed=seed)
    loop, init, tables = compiled_until_packed(proto, G.complete(n), run)
    want = int(loop(init, *tables).round)
    final, cov = FR.until_fused(n, seed, device=CPU)
    assert cov >= np.float32(0.99)
    assert abs(final.round - want) <= 2, (final.round, want)
