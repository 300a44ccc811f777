"""Topology library: graph families as padded neighbour tables on a device.

The port of the JAX package's ``topology/generators.py``.  A topology is a
fixed-width table ``nbrs: int32[N, D]`` (D = the largest degree, optionally
capped) whose unused slots hold the sentinel ``N``, plus ``deg: int32[N]``.
The ``complete`` family is implicit (``nbrs is None``): samplers draw
peers from ``[0, N)`` directly.

The edge lists are built on the host with numpy, by the reference's own
code, so they are identical for the same seed; the table's packing (a
stable sort by source and one scatter) runs on the device
(:func:`_pack`).
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


def _pack(n: int, src: np.ndarray, dst: np.ndarray,
          degree_cap: Optional[int], family: str,
          rng: np.random.Generator, device) -> Topology:
    """Pack an edge list (numpy or int64 tensors of directed pairs;
    undirected graphs pass both directions) into a padded neighbour
    table (the reference's ``_pack``, degree-cap subsampling included).
    The stable sort by source and the packing run in torch on the
    table's device (numpy's stable argsort of an int64 array is a merge
    sort: minutes at 10^8 edges on a slow host); a stable sort has one
    result.  The degree cap's subsampling draws from ``rng`` in numpy,
    as the reference does."""
    dev = _device(device)

    def as_t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        return a.to(dev)

    src_t, dst_t = as_t(src), as_t(dst)
    order = torch.argsort(src_t, stable=True)
    src_t, dst_t = src_t[order], dst_t[order]
    deg_t = torch.bincount(src_t, minlength=n)
    d_max = int(deg_t.max()) if len(src) else 0
    if degree_cap is not None and d_max > degree_cap:
        # rows over the cap keep a random subset: within each, the edges
        # sorted by a uniform priority (drawn for every edge, as the
        # reference draws it); the rows under the cap keep their order,
        # so only the rows over it are sorted
        src, dst = src_t.cpu().numpy(), dst_t.cpu().numpy()
        deg = deg_t.cpu().numpy().astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
        over_rows = np.flatnonzero((deg > degree_cap)[src])
        pri = rng.random(len(src))[over_rows]
        order2 = np.arange(len(src))
        order2[over_rows] = over_rows[np.lexsort((pri, src[over_rows]))]
        src, dst = src[order2], dst[order2]
        rank = np.arange(len(src)) - np.repeat(starts, deg)
        keep = rank < degree_cap
        src_t, dst_t, col = as_t(src[keep]), as_t(dst[keep]), as_t(rank[keep])
        deg_t = torch.from_numpy(np.minimum(deg, degree_cap)).to(dev)
        d_max = degree_cap
    else:
        starts = torch.cumsum(deg_t, 0) - deg_t
        col = (torch.arange(len(src), dtype=torch.int64, device=dev)
               - torch.repeat_interleave(starts, deg_t))
    nbrs = torch.full((n, max(d_max, 1)), n, dtype=torch.int32, device=dev)
    nbrs.index_put_((src_t, col), dst_t.to(torch.int32))
    return Topology(nbrs=nbrs, deg=deg_t.to(torch.int32), n=n,
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
    unordered pairs, O(E).  The draws are the reference's numpy draws;
    the sorts and the pair decoding run in torch on the table's device
    (sorted unique values and IEEE float64 arithmetic: the same
    arrays)."""
    rng = np.random.default_rng(seed)
    dev = _device(device)

    def unique(a):
        return torch.unique(torch.from_numpy(a).to(dev)).cpu().numpy()

    m_total = n * (n - 1) // 2
    m = rng.binomial(m_total, p)
    if m > m_total // 8:
        codes = rng.permutation(m_total)[:m]
    else:
        codes = unique(rng.integers(0, m_total, size=int(m * 1.05) + 16))
        batch = max(m // 8, 64)
        while len(codes) < m:
            extra = rng.integers(0, m_total, size=batch)
            codes = unique(np.concatenate([codes, extra]))
            batch *= 2
        codes = rng.permutation(codes)[:m]
    c = torch.from_numpy(np.ascontiguousarray(codes, np.int64)).to(dev)
    b = torch.ceil((torch.sqrt(c.to(torch.float64) * 8.0 + 9) - 1) / 2
                   ).to(torch.int64)
    a = c - b * (b - 1) // 2
    return _pack(n, torch.cat([a, b]), torch.cat([b, a]), degree_cap,
                 cfg_mod.ERDOS_RENYI, rng, device)


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
