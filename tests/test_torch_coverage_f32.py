"""The float32 rule of ``gossip_tpu_torch.ops.common``: the port counts
nodes in integers and rounds once; the reference adds float32 values.

* Up to 2^24 nodes the two are bitwise equal, on the bool and the packed
  layouts, eager (the reports) and under ``jax.jit`` (the loops' stop
  tests).
* Past 2^24 the reference's sum may round: at n = 20,000,001 with
  19,980,134 nodes set (ROADMAP queue 3 item 3) the port's coverage is
  the declared deviation, held to the reference's within one ulp of the
  sum.
* The run report carries the exact count beside the fraction.
* The sharded drivers add the ranks' float32 partials in rank order,
  bitwise the reference's ``lax.psum`` on its CPU mesh (K = 2, 4, 8),
  for partials whose sum passes 2^24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from gossip_tpu import config as JC
from gossip_tpu.backend import run_simulation as jrun_simulation
from gossip_tpu.compat import shard_map
from gossip_tpu.models import si as JSI
from gossip_tpu.ops import bitpack as JB
from gossip_tpu.parallel.sharded import make_mesh
from gossip_tpu_torch.backend import run_simulation
from gossip_tpu_torch.config import (MeshConfig, ProtocolConfig, RunConfig,
                                     TopologyConfig)
from gossip_tpu_torch.models.si import coverage, coverage_count
from gossip_tpu_torch.ops.bitpack import coverage_count_packed, \
    coverage_packed
from gossip_tpu_torch.ops.common import (f32_fraction, f32_mean,
                                         rank_order_sum)

N24 = 1 << 24
N_PAST = 20_000_001
SET_PAST = 19_980_134


@pytest.fixture(autouse=True)
def _no_executable_store(monkeypatch):
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE", "")


def _draws():
    """The ROADMAP probe's draws from ``default_rng(0)``: two at 2^24 and
    two at 2^24 + 3 (fractions 0.999 then 0.5), then the one at
    20,000,001 (0.999).  Returns the first 2^24 draw and the last."""
    rng = np.random.default_rng(0)
    first = rng.random((N24, 1)) < 0.999
    rng.random((N24, 1))
    rng.random((N24 + 3, 1))
    rng.random((N24 + 3, 1))
    return first, rng.random((N_PAST, 1)) < 0.999


@pytest.fixture(scope="module")
def draws():
    return _draws()


def _words(seen: np.ndarray) -> np.ndarray:
    """One rumor's packed words (bit 0), without packing's [n, 32]
    temporaries."""
    return seen[:, 0].astype(np.uint32)[:, None]


def _port_words(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32))


def _ref_packed(words, alive=None):
    """The reference's packed coverage under ``jax.jit`` (its loops'
    form; XLA fuses the unpacking, so no [n, 32] array is made)."""
    if alive is None:
        return float(jax.jit(lambda w: JB.coverage_packed(w, 1))(words))
    return float(jax.jit(lambda w, a: JB.coverage_packed(w, 1, a))(
        words, alive))


@pytest.mark.parametrize("layout", ["bool", "packed"])
def test_equal_at_2_24(draws, layout):
    """At n = 2^24 every float32 sum is exact: the port's coverage, plain
    and alive-weighted, is bitwise the reference's, eager and jitted."""
    seen = draws[0]
    alive = np.ones(N24, bool)
    alive[::7] = False
    count = int(seen[:, 0].sum())
    if layout == "bool":
        want = [float(JSI.coverage(jnp.asarray(seen))),
                float(jax.jit(JSI.coverage)(jnp.asarray(seen))),
                float(JSI.coverage(jnp.asarray(seen), jnp.asarray(alive))),
                float(jax.jit(JSI.coverage)(jnp.asarray(seen),
                                            jnp.asarray(alive)))]
        t = torch.from_numpy(seen)
        a = torch.from_numpy(alive)
        got = [coverage(t), coverage(t), coverage(t, a), coverage(t, a)]
        assert coverage_count(t) == (count, N24)
    else:
        words = _words(seen)
        want = [_ref_packed(words), _ref_packed(words),
                _ref_packed(words, alive), _ref_packed(words, alive)]
        w = _port_words(words)
        a = torch.from_numpy(alive)
        got = [coverage_packed(w, 1)] * 2 + [coverage_packed(w, 1, a)] * 2
        assert coverage_count_packed(w, 1) == (count, N24)
    assert got == want
    assert got[0] == f32_mean(count, N24)


def _within_one_ulp(ref: float, count: int, n: int, frac) -> bool:
    """Whether ``ref`` is ``frac(s, n)`` for a float32 sum ``s`` within
    one ulp of the exact ``count``."""
    c = np.float32(count)
    sums = (np.nextafter(c, np.float32(0)), c,
            np.nextafter(c, np.float32(np.inf)))
    return any(ref == frac(int(s), n) for s in sums)


@pytest.mark.parametrize("layout", ["bool", "packed"])
def test_past_2_24_is_the_declared_deviation(draws, layout):
    """ROADMAP queue 3 item 3's case: at n = 20,000,001 the port's
    coverage is its exact count rounded once (0.9990066885948181); the
    reference's float32 sum may round (0.9990068078041077 on this CPU's
    XLA), and is held within one ulp of the count."""
    seen = draws[1]
    count = int(seen[:, 0].sum())
    assert count == SET_PAST
    if layout == "bool":
        got = coverage(torch.from_numpy(seen))
        refs = [float(JSI.coverage(jnp.asarray(seen))),
                float(jax.jit(JSI.coverage)(jnp.asarray(seen)))]
    else:
        words = _words(seen)
        got = coverage_packed(_port_words(words), 1)
        refs = [_ref_packed(words)]
    assert got == f32_mean(SET_PAST, N_PAST) == 0.9990066885948181
    for ref in refs:
        assert _within_one_ulp(ref, count, N_PAST, f32_mean), ref


def test_report_carries_the_exact_count():
    """The report's coverage is the float32 rule applied to
    ``meta.coverage_count`` over ``meta.coverage_total``, on the bool,
    packed and sharded routes, and equals the reference's."""
    n = 2001
    cases = [(dict(mode="push"), False, None),
             (dict(mode="pull", rumors=3), False, None),
             (dict(mode="pull"), False, MeshConfig(n_devices=2))]
    for proto, curve, mesh in cases:
        run = dict(seed=2, max_rounds=40, engine="xla")
        port = run_simulation(ProtocolConfig(**proto), TopologyConfig(n=n),
                              RunConfig(**run), want_curve=curve,
                              device="cpu", mesh_cfg=mesh)
        ref = jrun_simulation(
            "jax-tpu", JC.ProtocolConfig(**proto), JC.TopologyConfig(n=n),
            JC.RunConfig(**run), None,
            None if mesh is None else JC.MeshConfig(n_devices=2))
        assert port.coverage == ref.coverage
        count, total = port.meta["coverage_count"], port.meta["coverage_total"]
        assert total == n and 0 < count <= n
        frac = f32_fraction if mesh is not None else f32_mean
        assert port.coverage == frac(count, total)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_rank_order_sum_is_the_reference_psum(k):
    """The float32 combine of the sharded ``msgs`` and ``lost``: partials
    added in rank order equal ``lax.psum`` under a jitted ``shard_map`` on
    the reference's K-device CPU mesh, for crafted partials whose sum
    passes 2^24 (where the order of the adds shows) and random ones."""
    mesh = make_mesh(k)
    psum = jax.jit(shard_map(lambda x: jax.lax.psum(x[0], "nodes"),
                             mesh=mesh, in_specs=PartitionSpec("nodes"),
                             out_specs=PartitionSpec()))
    rng = np.random.default_rng(k)
    cases = [np.roll(np.r_[np.float32(N24), np.ones(k - 1, np.float32)], i)
             for i in range(k)]
    cases += [(rng.integers(0, 1 << 23, k) * rng.choice([1, 3], k))
              .astype(np.float32) for _ in range(40)]
    tree = 0
    for parts in cases:
        want = np.float32(psum(jnp.asarray(parts)))
        got = rank_order_sum(torch.from_numpy(parts)).item()
        assert got == want, parts
        # pairwise addition differs on some: the order is what matters
        pairs = torch.from_numpy(parts)
        while pairs.shape[0] > 1:
            pairs = pairs[0::2] + pairs[1::2]
        tree += pairs.item() != want
    assert k == 2 or tree > 0
