"""Topology library: graph families as padded neighbour tables on a device.

The port of the JAX package's ``topology/generators.py``.  A topology is a
fixed-width table ``nbrs: int32[N, D]`` (D = the largest degree, optionally
capped) whose unused slots hold the sentinel ``N``, plus ``deg: int32[N]``.
The ``complete`` family is implicit (``nbrs is None``): samplers draw
peers from ``[0, N)`` directly.

The edge lists are built on the host with numpy, by the reference's own
code, so they are identical for the same seed; only the table's scatter
runs on the device (:func:`_scatter_table`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as cfg_mod
from gossip_tpu_torch.config import TopologyConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    """``nbrs[i, j]`` is the j-th neighbour of node i for ``j < deg[i]``
    and the sentinel ``n`` beyond; ``nbrs is None`` for the implicit
    complete graph."""

    nbrs: Optional[torch.Tensor]   # int32[N, D] or None
    deg: Optional[torch.Tensor]    # int32[N] or None
    n: int = 0
    family: str = cfg_mod.COMPLETE

    @property
    def implicit(self) -> bool:
        return self.nbrs is None

    @property
    def width(self) -> int:
        return 0 if self.nbrs is None else int(self.nbrs.shape[1])


def _device(device) -> torch.device:
    from gossip_tpu_torch.ops.common import resolve_device
    return resolve_device(device)


def _scatter_table(src: np.ndarray, dst: np.ndarray, col: np.ndarray,
                   n: int, d_max: int, device) -> torch.Tensor:
    """The padded table built on the device from the edge list: one
    scatter of E elements into a sentinel-filled ``[n, d_max]`` table, so
    only the edges cross to the device."""
    nbrs = torch.full((n, d_max), n, dtype=torch.int32, device=device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)
                                      ).to(device)
    nbrs.index_put_((as_t(src), as_t(col)),
                    torch.from_numpy(np.asarray(dst, np.int32)).to(device))
    return nbrs


def _pack(n: int, src: np.ndarray, dst: np.ndarray,
          degree_cap: Optional[int], family: str,
          rng: np.random.Generator, device) -> Topology:
    """Pack an edge list (directed pairs; undirected graphs pass both
    directions) into a padded neighbour table (the reference's ``_pack``,
    degree-cap subsampling included)."""
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n).astype(np.int32)
    d_max = int(deg.max()) if len(src) else 0
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    col = np.arange(len(src)) - np.repeat(starts, deg)
    if degree_cap is not None and d_max > degree_cap:
        # rows over the cap keep a random subset: within each, the edges
        # sorted by a uniform priority (drawn for every edge, as the
        # reference draws it); the rows under the cap keep their order,
        # so only the rows over it are sorted
        over_rows = np.flatnonzero((deg > degree_cap)[src])
        pri = rng.random(len(src))[over_rows]
        order2 = np.arange(len(src))
        order2[over_rows] = over_rows[np.lexsort((pri, src[over_rows]))]
        src, dst = src[order2], dst[order2]
        rank = np.arange(len(src)) - np.repeat(starts, deg)
        keep = rank < degree_cap
        src, dst, col = src[keep], dst[keep], rank[keep]
        deg = np.minimum(deg, degree_cap)
        d_max = degree_cap
    d_max = max(d_max, 1)
    dev = _device(device)
    nbrs = _scatter_table(src, dst, col, n, d_max, dev)
    return Topology(nbrs=nbrs, deg=torch.from_numpy(deg).to(dev), n=n,
                    family=family)


def complete(n: int) -> Topology:
    """Implicit complete graph: every node can sample every other."""
    return Topology(nbrs=None, deg=None, n=n, family=cfg_mod.COMPLETE)


def complete_table(n: int, device=None) -> Topology:
    """Materialized complete graph (small n only)."""
    src = np.repeat(np.arange(n), n - 1)
    dst = np.concatenate([np.delete(np.arange(n), i) for i in range(n)])
    return _pack(n, src.astype(np.int64), dst.astype(np.int64), None,
                 cfg_mod.COMPLETE, np.random.default_rng(0), device)


def ring(n: int, k: int = 2, device=None) -> Topology:
    """Ring lattice: each node linked to its k nearest neighbours (k/2 per
    side); k even."""
    if k % 2 or k < 2:
        raise ValueError("ring k must be even and >= 2")
    offs = np.concatenate([np.arange(1, k // 2 + 1),
                           -np.arange(1, k // 2 + 1)])
    src = np.repeat(np.arange(n), k)
    dst = (src + np.tile(offs, n)) % n
    return _pack(n, src, dst, None, cfg_mod.RING, np.random.default_rng(0),
                 device)


def grid2d(rows: int, cols: int, device=None) -> Topology:
    """2-D grid, 4-connected, not wrapping."""
    n = rows * cols
    i = np.arange(n)
    r, c = i // cols, i % cols
    pairs = []
    for dr, dc in ((0, 1), (1, 0)):
        ok = (r + dr < rows) & (c + dc < cols)
        a = i[ok]
        b = (r[ok] + dr) * cols + (c[ok] + dc)
        pairs.append((a, b))
        pairs.append((b, a))
    src = np.concatenate([p[0] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs])
    return _pack(n, src, dst, None, cfg_mod.GRID, np.random.default_rng(0),
                 device)


def erdos_renyi(n: int, p: float, seed: int = 0,
                degree_cap: Optional[int] = None, device=None) -> Topology:
    """G(n, p) by sparse edge sampling: Binomial(n(n-1)/2, p) distinct
    unordered pairs, O(E)."""
    rng = np.random.default_rng(seed)
    m_total = n * (n - 1) // 2
    m = rng.binomial(m_total, p)
    if m > m_total // 8:
        codes = rng.permutation(m_total)[:m]
    else:
        codes = np.unique(rng.integers(0, m_total, size=int(m * 1.05) + 16))
        batch = max(m // 8, 64)
        while len(codes) < m:
            extra = rng.integers(0, m_total, size=batch)
            codes = np.unique(np.concatenate([codes, extra]))
            batch *= 2
        codes = rng.permutation(codes)[:m]
    b = np.ceil((np.sqrt(8.0 * codes + 9) - 1) / 2).astype(np.int64)
    a = (codes - b * (b - 1) // 2).astype(np.int64)
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    return _pack(n, src, dst, degree_cap, cfg_mod.ERDOS_RENYI, rng, device)


def watts_strogatz(n: int, k: int = 4, beta: float = 0.1, seed: int = 0,
                   device=None) -> Topology:
    """Watts-Strogatz small world: a ring lattice whose edges are rewired
    to a uniform endpoint with probability beta (duplicates collapsed)."""
    if k % 2 or k < 2:
        raise ValueError("watts_strogatz k must be even and >= 2")
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), k // 2)
    dst = (src + np.tile(np.arange(1, k // 2 + 1), n)) % n
    rewire = rng.random(len(src)) < beta
    new_dst = rng.integers(0, n, size=len(src))
    new_dst = np.where(new_dst == src, (new_dst + 1) % n, new_dst)
    dst = np.where(rewire, new_dst, dst)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    codes = np.unique(s.astype(np.int64) * n + d)
    s, d = codes // n, codes % n
    return _pack(n, s, d, None, cfg_mod.WATTS_STROGATZ, rng, device)


def power_law(n: int, m: int = 2, seed: int = 0,
              degree_cap: Optional[int] = None, device=None) -> Topology:
    """Barabasi-Albert preferential attachment by the repeated-nodes trick,
    in growing chunks against a frozen endpoint pool (as the reference)."""
    rng = np.random.default_rng(seed)
    if m < 1 or n <= m:
        raise ValueError("power_law needs n > m >= 1")
    srcs = [np.repeat(np.arange(m + 1), m)]
    dsts = [np.concatenate([np.delete(np.arange(m + 1), i)[:m]
                            for i in range(m + 1)])]
    seed_pool = np.concatenate(srcs + dsts)
    new = np.arange(m + 1, n)
    # the endpoint pool, filled in place: each chunk draws from the pool
    # as it stood before the chunk and then appends its own endpoints
    pool = np.empty(len(seed_pool) + 2 * m * len(new), seed_pool.dtype)
    pool[:len(seed_pool)] = seed_pool
    pool_size = len(seed_pool)
    chunk = max(1024, (n - m - 1) // 64)
    for lo in range(0, len(new), chunk):
        nodes = new[lo:lo + chunk]
        picks = pool[rng.integers(0, pool_size, size=(len(nodes), m))]
        s = np.repeat(nodes, m)
        d = picks.reshape(-1)
        srcs.append(s)
        dsts.append(d)
        pool[pool_size:pool_size + len(s)] = s
        pool[pool_size + len(s):pool_size + 2 * len(s)] = d
        pool_size += 2 * len(s)
    src = np.concatenate(srcs + dsts)
    dst = np.concatenate(dsts + srcs)
    codes = np.unique(src.astype(np.int64) * n + dst)
    src, dst = codes // n, codes % n
    self_loop = src != dst
    return _pack(n, src[self_loop], dst[self_loop], degree_cap,
                 cfg_mod.POWER_LAW, rng, device)


def build(tc: TopologyConfig, device=None) -> Topology:
    """Build a topology from its config, its table on ``device``."""
    if tc.family == cfg_mod.COMPLETE:
        return complete(tc.n)
    if tc.family == cfg_mod.RING:
        return ring(tc.n, tc.k, device)
    if tc.family == cfg_mod.GRID:
        side = int(np.sqrt(tc.n))
        return grid2d(side, (tc.n + side - 1) // side, device)
    if tc.family == cfg_mod.ERDOS_RENYI:
        return erdos_renyi(tc.n, tc.p, tc.seed, tc.degree_cap, device)
    if tc.family == cfg_mod.WATTS_STROGATZ:
        return watts_strogatz(tc.n, tc.k, tc.p, tc.seed, device)
    if tc.family == cfg_mod.POWER_LAW:
        return power_law(tc.n, tc.k, tc.seed, tc.degree_cap, device)
    raise ValueError(tc.family)


def topology_from_numpy(nbrs, deg, n: int, family: str,
                        device=None) -> Topology:
    """The port's topology from the reference's ``nbrs``/``deg`` as numpy
    (``None`` for the implicit complete graph)."""
    if nbrs is None:
        return complete(n)
    dev = _device(device)
    return Topology(
        nbrs=torch.from_numpy(np.array(nbrs, np.int32)).to(dev),
        deg=torch.from_numpy(np.array(deg, np.int32)).to(dev), n=n,
        family=family)
