"""The port's topologies (gossip_tpu_torch/topology/generators.py) against
the JAX package's: every family's ``nbrs`` and ``deg`` equal, element for
element, at n of 100 to 2,000, with the degree cap's subsampling and the
config-driven ``build``; and the converter from the reference's arrays."""

import numpy as np
import pytest

from gossip_tpu.config import TopologyConfig as JTopologyConfig
from gossip_tpu.topology import generators as JG
from gossip_tpu_torch.config import TopologyConfig
from gossip_tpu_torch.topology import generators as G

CPU = "cpu"


def _same(j, t):
    assert t.n == j.n and t.family == j.family
    if j.nbrs is None:
        assert t.nbrs is None and t.deg is None
        return
    np.testing.assert_array_equal(t.nbrs.numpy(), np.asarray(j.nbrs))
    np.testing.assert_array_equal(t.deg.numpy(), np.asarray(j.deg))
    assert t.width == j.width


@pytest.mark.parametrize("name,jfn,tfn", [
    ("complete_table", lambda: JG.complete_table(100),
     lambda: G.complete_table(100, CPU)),
    ("ring2", lambda: JG.ring(500, 2), lambda: G.ring(500, 2, CPU)),
    ("ring6", lambda: JG.ring(777, 6), lambda: G.ring(777, 6, CPU)),
    ("grid", lambda: JG.grid2d(30, 41), lambda: G.grid2d(30, 41, CPU)),
    ("erdos_renyi", lambda: JG.erdos_renyi(2000, 0.004, seed=3),
     lambda: G.erdos_renyi(2000, 0.004, seed=3, device=CPU)),
    ("erdos_renyi_dense", lambda: JG.erdos_renyi(100, 0.5, seed=1),
     lambda: G.erdos_renyi(100, 0.5, seed=1, device=CPU)),
    ("erdos_renyi_cap", lambda: JG.erdos_renyi(1500, 0.02, seed=5,
                                               degree_cap=12),
     lambda: G.erdos_renyi(1500, 0.02, seed=5, degree_cap=12, device=CPU)),
    ("watts_strogatz", lambda: JG.watts_strogatz(1000, 6, 0.2, seed=2),
     lambda: G.watts_strogatz(1000, 6, 0.2, seed=2, device=CPU)),
    ("power_law", lambda: JG.power_law(2000, 3, seed=4),
     lambda: G.power_law(2000, 3, seed=4, device=CPU)),
    ("power_law_cap", lambda: JG.power_law(2000, 2, seed=6, degree_cap=20),
     lambda: G.power_law(2000, 2, seed=6, degree_cap=20, device=CPU)),
])
def test_family_matches_reference(name, jfn, tfn):
    _same(jfn(), tfn())


@pytest.mark.parametrize("family,kw", [
    ("complete", {}), ("ring", {"k": 4}), ("grid", {}),
    ("erdos_renyi", {"p": 0.01, "degree_cap": 8}),
    ("watts_strogatz", {"k": 4, "p": 0.1}),
    ("power_law", {"k": 2, "degree_cap": 16}),
])
def test_build_matches_reference(family, kw):
    j = JG.build(JTopologyConfig(family=family, n=1200, seed=9, **kw))
    t = G.build(TopologyConfig(family=family, n=1200, seed=9, **kw), CPU)
    _same(j, t)


def test_converter_takes_the_reference_arrays():
    j = JG.watts_strogatz(300, 4, 0.3, seed=8)
    t = G.topology_from_numpy(np.asarray(j.nbrs), np.asarray(j.deg), j.n,
                              j.family, CPU)
    _same(j, t)
    assert G.topology_from_numpy(None, None, 300, "complete").implicit


def test_refusals_match_reference():
    for fn in (lambda: G.ring(10, 3), lambda: G.watts_strogatz(10, 1),
               lambda: G.power_law(3, 3)):
        with pytest.raises(ValueError):
            fn()
