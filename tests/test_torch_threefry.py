"""The port's threefry (gossip_tpu_torch/ops/threefry.py) against
``jax.random``, bitwise (tolerance 0).

Every function the XLA engine calls, on jax 0.9.0 as it runs here
(``jax_threefry_partitionable`` on, threefry2x32): ``key`` (negative seeds
and the dead set's ``seed ^ 0x5157`` included), ``fold_in``, ``split``,
``bits``, ``randint`` (static bounds, value-only bounds, and the
self-excluding shift), ``uniform`` and ``bernoulli``, for single keys and
for the per-node key batch the engine vmaps over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gossip_tpu.ops.sampling import shift_excluding_self as j_shift
from gossip_tpu_torch.ops import threefry as T
from gossip_tpu_torch.ops.sampling import shift_excluding_self

SEEDS = [0, 1, 0x5157, 2**31 - 1, -1, -12345]
SHAPES = [(), (1,), (3,), (5, 7)]
BOUNDS = [1, 2, 10, 2**20 + 7, 10**7, 2**31 - 1]
PROBS = [0.0, 1e-7, 0.02, 0.5, 1.0]


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_threefry2x32_known_answer():
    # Random123's kat_vectors for threefry2x32_20: key (0, 0), counter
    # (0, 0) -> (0x6b200159, 0x99ba4efe)
    y0, y1 = T.threefry2x32(0, 0, 0, 0)
    assert (int(y0), int(y1)) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), T.key(seed)
    np.testing.assert_array_equal(_u32(tk), _kd(jk))
    for d in (0, 1, 2**31 - 1):
        np.testing.assert_array_equal(_u32(T.fold_in(tk, d)),
                                      _kd(jax.random.fold_in(jk, d)))
    for num in (2, 3):
        np.testing.assert_array_equal(_u32(T.split(tk, num)),
                                      _kd(jax.random.split(jk, num)))


def test_death_key_salt():
    for seed in (0, 7, -3):
        np.testing.assert_array_equal(
            _u32(T.key(seed ^ 0x5157)), _kd(jax.random.key(seed ^ 0x5157)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform(seed):
    jk, tk = jax.random.key(seed), T.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(_u32(T.random_bits(tk, shape)),
                                      np.asarray(jax.random.bits(jk, shape)))
        np.testing.assert_array_equal(
            T.uniform(tk, shape).numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    jk, tk = jax.random.key(seed), T.key(seed)
    for shape in SHAPES:
        for hi in BOUNDS:
            np.testing.assert_array_equal(
                T.randint(tk, shape, 0, hi).numpy(),
                np.asarray(jax.random.randint(jk, shape, 0, hi,
                                              dtype=jnp.int32)))
    # a nonzero minval and an empty range (span forced to 1)
    np.testing.assert_array_equal(
        T.randint(tk, (4,), 5, 1000).numpy(),
        np.asarray(jax.random.randint(jk, (4,), 5, 1000, dtype=jnp.int32)))
    np.testing.assert_array_equal(
        T.randint(tk, (4,), 9, 3).numpy(),
        np.asarray(jax.random.randint(jk, (4,), 9, 3, dtype=jnp.int32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli(seed):
    jk, tk = jax.random.key(seed), T.key(seed)
    for shape in SHAPES:
        for p in PROBS:
            np.testing.assert_array_equal(
                T.bernoulli(tk, p, shape).numpy(),
                np.asarray(jax.random.bernoulli(jk, p, shape)))


def _node_batch(seed, n=1000):
    """The engine's per-node keys: fold_in(round key, id) over ids."""
    jr = jax.random.fold_in(jax.random.key(seed), 3)
    ids = jnp.arange(n, dtype=jnp.int32)
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jr, ids)
    tkeys = T.fold_in(T.key_from_words(_kd(jr)), torch.arange(n))
    return jkeys, tkeys


@pytest.mark.parametrize("seed", [0, -1])
def test_vmapped_per_node_draws(seed):
    jkeys, tkeys = _node_batch(seed)
    np.testing.assert_array_equal(_u32(tkeys), _kd(jkeys))
    ids = jnp.arange(1000, dtype=jnp.int32)
    for n in (5000, 10**7):
        # the complete graph's self-excluding draw
        want = jax.vmap(lambda k, i: j_shift(jax.random.randint(
            k, (3,), 0, n - 1, dtype=jnp.int32), i))(jkeys, ids)
        got = shift_excluding_self(T.randint(tkeys, (3,), 0, n - 1),
                                   torch.arange(1000)[:, None])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the table sampler's value-only bound, one per node
    deg = np.random.default_rng(seed & 7).integers(0, 40, 1000)
    want = jax.vmap(lambda k, d: jax.random.randint(
        k, (2,), 0, jnp.maximum(d, 1), dtype=jnp.int32))(
            jkeys, jnp.asarray(deg, jnp.int32))
    got = T.randint(tkeys, (2,), 0,
                    torch.clamp(torch.from_numpy(deg), min=1)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.vmap(lambda k: jax.random.bernoulli(k, 0.05, (3,)))(jkeys)
    np.testing.assert_array_equal(T.bernoulli(tkeys, 0.05, (3,)).numpy(),
                                  np.asarray(want))


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1),
       data=st.integers(0, 2**32 - 1),
       hi=st.integers(1, 2**31 - 1))
def test_random_keys_and_bounds(seed, data, hi):
    jk = jax.random.fold_in(jax.random.key(seed), data)
    tk = T.fold_in(T.key(seed), data)
    np.testing.assert_array_equal(_u32(tk), _kd(jk))
    np.testing.assert_array_equal(
        T.randint(tk, (3,), 0, hi).numpy(),
        np.asarray(jax.random.randint(jk, (3,), 0, hi, dtype=jnp.int32)))


def test_refuses_seeds_past_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        T.key(1 << 32)
    with pytest.raises(ValueError, match="int32"):
        T.randint(T.key(0), (2,), 0, 1 << 31)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 1625, 1626, 2000])
def test_permutation(p):
    """``permutation(key, p)`` equals ``jax.random.permutation(key,
    arange(p))`` over several keys, across its one-round (p <= 1625) and
    two-round sorts."""
    for seed in range(6):
        key = jax.random.fold_in(jax.random.key(seed), 101)
        want = np.asarray(jax.random.permutation(
            key, jnp.arange(p, dtype=jnp.int32)))
        got = T.permutation(T.fold_in(T.key(seed), 101), p)
        np.testing.assert_array_equal(got.numpy(), want)
