"""The peer-sampling kernel's plain version
(gossip_tpu_torch/ops/fast_sampling.py) on the CPU.

* Under injected all-zero bits it equals the JAX package's
  ``sample_targets_pallas(..., interpret=True)``, whose off-TPU rendering
  of the hardware generator draws zeros (tolerance 0).
* Under random injected bits it equals a numpy model of the TPU kernel's
  mapping (``u % n``, or ``t = u % (n-1)``, ``t + (t >= row)``).
* On the port's Philox stream: seeds and rows vary the draws, no row
  draws itself, values lie in ``[0, n)``, the chi-square of
  tests/test_pallas.py holds (8192 draws, n = 64, 16 buckets, below 60),
  and ``compiled_until_packed(sampler="kernel")`` reaches 99% within 2
  rounds of the threefry sampler at n = 2^14 over three seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_tpu.ops.pallas_sampling import round_seed as j_round_seed
from gossip_tpu.ops.pallas_sampling import sample_targets_pallas
from gossip_tpu_torch.config import ProtocolConfig, RunConfig
from gossip_tpu_torch.models.si_packed import compiled_until_packed
from gossip_tpu_torch.ops import fast_sampling as FS
from gossip_tpu_torch.ops import philox
from gossip_tpu_torch.topology import generators as G

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


@pytest.mark.parametrize("excl", [True, False])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n_rows", [1000, 4096, 5000, 8193])
def test_zero_bits_match_reference_interpret(n_rows, k, excl):
    n_total = n_rows + 11
    want = np.asarray(sample_targets_pallas(jnp.int32(7), n_rows, n_total,
                                            k, excl, interpret=True))
    zeros = np.zeros((n_rows, k), np.uint32)
    got = FS.sample_targets(7, n_rows, n_total, k, excl, inject_bits=zeros,
                            device=CPU)
    assert got.dtype == torch.int32 and got.shape == (n_rows, k)
    np.testing.assert_array_equal(got.numpy(), want)


def _model(u, n_total, excl):
    """The TPU kernel's mapping in numpy, on uint32 draws [n_rows, k]."""
    u = u.astype(np.uint64)
    if excl and n_total > 1:
        t = u % np.uint64(n_total - 1)
        rows = np.arange(u.shape[0], dtype=np.uint64)[:, None]
        return (t + (t >= rows)).astype(np.int32)
    return (u % np.uint64(n_total)).astype(np.int32)


@pytest.mark.parametrize("n_total,excl", [(1000, True), (1000, False),
                                          (2**31 - 1, True), (1, True),
                                          (2, True), (5, False)])
def test_random_bits_match_numpy_model(n_total, excl):
    rng = np.random.default_rng(n_total)
    u = rng.integers(0, 2**32, size=(777, 3), dtype=np.uint32)
    u[:4] = [[0, 2**32 - 1, n_total - 1], [n_total, 1, 2**31]] * 2
    got = FS.sample_targets_plain(0, 777, n_total, 3, excl, inject_bits=u,
                                  device=CPU)
    np.testing.assert_array_equal(got.numpy(), _model(u, n_total, excl))


def test_stream_is_the_specified_philox_words():
    s = FS.round_seed(5, 3)
    words = philox.sampler_words(s, 4099, CPU).numpy()
    for e in (0, 1, 3, 4, 4095, 4098):
        c = philox.philox4x32_10(e >> 2, 0, 2, 0, s & philox.MASK32,
                                 philox.SAMPLER_SALT)
        assert words[e] == int(c[e & 3])
    got = FS.sample_targets(s, 1366, 10**6, 3, True, device=CPU)
    np.testing.assert_array_equal(
        got.numpy(), _model(words[:4098].reshape(1366, 3).astype(np.uint32),
                            10**6, True))


def test_round_seed_matches_reference():
    for seed, rnd in ((0, 0), (5, 1), (2**31 - 1, 26), (-7, 3),
                      (123456, 99)):
        assert FS.round_seed(seed, rnd) == int(j_round_seed(seed,
                                                            jnp.int32(rnd)))


def test_seeds_and_rows_vary_no_self_in_range():
    a = FS.sample_targets(42, 500, 10_000, device=CPU)
    b = FS.sample_targets(42, 500, 10_000, device=CPU)
    c = FS.sample_targets(43, 500, 10_000, device=CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    t = FS.sample_targets(9, 8192, 1 << 30, 1, False, device=CPU)[:, 0]
    assert not torch.equal(t[:4096], t[4096:])
    t = FS.sample_targets(3, 4096, 4096, 4, True, device=CPU)
    assert (t != torch.arange(4096)[:, None]).all()
    assert int(t.min()) >= 0 and int(t.max()) < 4096


def test_uniformity_chi_square():
    n, buckets = 64, 16
    t = FS.sample_targets(11, 8192, n, 1, False, device=CPU)[:, 0].numpy()
    counts = np.bincount(t * buckets // n, minlength=buckets)
    expected = len(t) / buckets
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 60, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_sampler_rounds_near_threefry(seed):
    n = 1 << 14
    proto = ProtocolConfig(mode="pull", fanout=1)
    run = RunConfig(seed=seed, max_rounds=64)
    rounds = {}
    for sampler in ("threefry", "kernel"):
        loop, init = compiled_until_packed(proto, G.complete(n), run,
                                           sampler=sampler, device=CPU)
        rounds[sampler] = loop(init).round
    assert abs(rounds["kernel"] - rounds["threefry"]) <= 2, rounds


def test_kernel_sampler_round_keeps_threefry_drops():
    """With ``sampler="kernel"`` the partners come from the kernel's
    stream and the drop coins still from the round's threefry key."""
    from gossip_tpu_torch.config import FaultConfig
    from gossip_tpu_torch.models.si import PULL_DROP_TAG
    from gossip_tpu_torch.models.si_packed import (init_packed_state,
                                                   make_packed_round,
                                                   pull_merge_packed)
    from gossip_tpu_torch.ops import threefry
    from gossip_tpu_torch.ops.sampling import apply_drop
    n, proto = 2000, ProtocolConfig(mode="pull")
    st = init_packed_state(RunConfig(seed=5), proto, n, CPU)
    st = st._replace(seen=st.seen | (torch.arange(n)[:, None] % 7 == 0)
                     .to(torch.int32))
    step = make_packed_round(proto, G.complete(n), FaultConfig(drop_prob=0.2),
                             sampler="kernel", sampler_seed=5, device=CPU)
    got = step(st._replace(round=3))
    partners = FS.sample_peers_fast(5, 3, n, n, device=CPU).long()
    partners = apply_drop(threefry.fold_in(st.key, 3), PULL_DROP_TAG,
                          torch.arange(n), partners, 0.2, n)
    assert torch.equal(got.seen,
                       st.seen | pull_merge_packed(st.seen, partners, n))
    assert got.msgs.item() == 2.0 * int((partners < n).sum())
    assert 0 < int((partners == n).sum()) < n


def test_refusals():
    with pytest.raises(ValueError, match="2\\^34"):
        FS.sample_targets_plain(0, 1 << 33, 10, 2, device=CPU)
    with pytest.raises(ValueError, match="n_total"):
        FS.sample_targets(0, 10, 0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs a CUDA device"):
            FS.sample_targets(0, 10, 10)
