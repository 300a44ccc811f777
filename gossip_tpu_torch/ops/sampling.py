"""Random peer sampling of the XLA engine, keyed by threefry.

The port of the JAX package's ``ops/sampling.py``.  Every node draws its
``k`` peers (and its drop coins) from its own key ``fold_in(round_key,
global_id)``, so the draws equal the reference's bit for bit
(:mod:`gossip_tpu_torch.ops.threefry`).  The reference's ``vmap`` over
per-node keys is a batch of keys here.  Targets are int64 tensors
``[N, k]`` holding node ids, or the sentinel ``n`` for "no peer".
"""

from __future__ import annotations

import torch

from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.topology.generators import Topology


def node_keys(round_key: torch.Tensor, global_ids: torch.Tensor):
    """Per-node keys ``[N, 2]``: the global node id folded into the round
    key."""
    return threefry.fold_in(round_key, global_ids)


def drop_mask(round_key: torch.Tensor, tag: int, global_ids: torch.Tensor,
              width: int, drop_prob) -> torch.Tensor:
    """bool[N, width] per-edge-use drop mask, keyed by global node id;
    ``drop_prob`` a float or a float32 0-d tensor."""
    keys = node_keys(threefry.fold_in(round_key, tag), global_ids)
    return threefry.bernoulli(keys, drop_prob, (width,))


def apply_drop(round_key: torch.Tensor, tag: int, global_ids: torch.Tensor,
               targets: torch.Tensor, drop_prob, sentinel: int,
               force: bool = False) -> torch.Tensor:
    """Lossy links: dropped targets become the sentinel.  A zero rate
    draws nothing (the reference's static early-out) unless ``force``:
    the churn rounds always draw, at the round's probability from the
    schedule (a float32 0-d tensor; at 0 the mask is all False)."""
    if not force and drop_prob <= 0.0:
        return targets
    dropped = drop_mask(round_key, tag, global_ids, targets.shape[1],
                        drop_prob)
    return torch.where(dropped, sentinel, targets)


def shift_excluding_self(r: torch.Tensor, gid) -> torch.Tensor:
    """``r`` uniform on ``[0, n-1)`` becomes uniform on ``[0, n)`` without
    ``gid``: every draw ``>= gid`` moves up by one."""
    return r + (r >= gid).to(r.dtype)


def table_lookup_or_sentinel(idx: torch.Tensor, rows: torch.Tensor,
                             deg: torch.Tensor, sentinel: int):
    """Neighbour ``idx`` of each row (int64); degree-0 rows give the
    sentinel.  The gather reads the table in its own dtype."""
    t = torch.gather(rows, -1, idx).to(torch.int64)
    return torch.where(deg > 0, t, sentinel)


def sample_peers_complete(round_key: torch.Tensor, global_ids: torch.Tensor,
                          n_total: int, k: int,
                          exclude_self: bool = True) -> torch.Tensor:
    """Uniform peers on the implicit complete graph, int64[N, k]."""
    keys = node_keys(round_key, global_ids)
    if exclude_self and int(n_total) > 1:
        r = threefry.randint(keys, (k,), 0, int(n_total) - 1)
        return shift_excluding_self(r, global_ids.to(torch.int64)[:, None])
    return threefry.randint(keys, (k,), 0, int(n_total))


def sample_peers_table(round_key: torch.Tensor, global_ids: torch.Tensor,
                       nbrs: torch.Tensor, deg: torch.Tensor, k: int,
                       sentinel: int) -> torch.Tensor:
    """k uniform neighbours per node from a padded table, int64[N, k];
    degree-0 nodes give the sentinel."""
    keys = node_keys(round_key, global_ids)
    d = deg.to(torch.int64)[:, None]
    idx = threefry.randint(keys, (k,), 0, torch.clamp(d, min=1))
    return table_lookup_or_sentinel(idx, nbrs, d, sentinel)


def sample_peers(round_key: torch.Tensor, global_ids: torch.Tensor,
                 topo: Topology, k: int,
                 exclude_self: bool = True) -> torch.Tensor:
    """Implicit complete graph or neighbour table."""
    if topo.implicit:
        return sample_peers_complete(round_key, global_ids, topo.n, k,
                                     exclude_self)
    return sample_peers_table(round_key, global_ids, topo.nbrs, topo.deg, k,
                              sentinel=topo.n)
