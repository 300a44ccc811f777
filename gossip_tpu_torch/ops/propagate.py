"""Propagation of the XLA engine: one round's data movement.

The port of the JAX package's ``ops/propagate.py`` (single device):

* **push** (:func:`push_delta`): each node writes its digest row at its
  targets.  The reference's scatter-max drops targets equal to the
  sentinel ``n``; torch refuses an index out of range, so those land in
  one extra row that is cut off.
* **pull** (:func:`pull_merge`): each node ORs its sampled peers' rows.
* **flood** (:func:`flood_gather`): the OR over the whole neighbour row.
* **sharded push** (:func:`push_counts`): receive counts over the whole
  padded node range, which the ranks add with a reduce-scatter;
  ``counts > 0`` is the OR.

Each takes an optional leading batch axis ``S`` (the sweeps' seeds,
scenarios or configs, :mod:`gossip_tpu_torch.parallel.sweep`): targets
``[S, N, k]`` against payloads ``[S, N, R]``.  Point s's scatter lands in
its own block of one flat count table (offset ``s * (n_pad + 1)``), so
one ``index_add_`` serves the batch; a gather reads point s's rows.  A
partner table without the batch axis (a shared neighbour table) is read
by every point.
"""

from __future__ import annotations

import torch


def push_counts(n_pad: int, targets: torch.Tensor,
                payload: torch.Tensor) -> torch.Tensor:
    """int32[..., n_pad, R]: row t counts the senders i with target t
    whose ``payload[i]`` holds each rumor.  Targets are ids in ``[0,
    n_pad)`` or ``n_pad`` (dropped: they land in one extra row that is cut
    off, so the sentinel never reaches the reduce-scatter).  With a
    leading batch axis each point counts into its own block."""
    *lead, nl, k = targets.shape
    r = payload.shape[-1]
    b = 1
    for d in lead:
        b *= d
    flat_t = targets.reshape(b, nl * k).to(torch.int64)
    if b > 1:
        flat_t = flat_t + (n_pad + 1) * torch.arange(
            b, dtype=torch.int64, device=targets.device)[:, None]
    flat_p = payload.to(torch.int32)[..., None, :].expand(*lead, nl, k, r)
    hits = torch.zeros(b * (n_pad + 1), r, dtype=torch.int32,
                       device=payload.device)
    hits.index_add_(0, flat_t.reshape(-1), flat_p.reshape(b * nl * k, r))
    return hits.reshape(*lead, n_pad + 1, r)[..., :n_pad, :]


def push_delta(n: int, targets: torch.Tensor,
               payload: torch.Tensor) -> torch.Tensor:
    """bool[..., n, R]: row t is the OR of ``payload[i]`` over every node
    i with target t.  Targets are ids in ``[0, n)`` or the sentinel ``n``
    (dropped)."""
    return push_counts(n, targets, payload) > 0


def pull_merge(seen_all: torch.Tensor, partners: torch.Tensor,
               valid_sentinel: int) -> torch.Tensor:
    """bool[..., N, R]: the OR of the k sampled peers' rows; sentinel
    entries are masked out.  ``seen_all`` ``[S, n, R]`` with partners
    ``[S, N, k]`` reads each point's own rows, with ``[N, k]`` the same
    rows of every point."""
    valid = partners < valid_sentinel
    safe = torch.clamp(partners, max=valid_sentinel - 1).to(torch.int64)
    if seen_all.dim() == 2:
        got = seen_all[safe]
    elif partners.dim() == 2:
        got = seen_all[:, safe]
    else:
        pts = torch.arange(seen_all.shape[0], device=safe.device)
        got = seen_all[pts[:, None, None], safe]
    return (got & valid[..., None]).any(dim=-2)


def flood_gather(seen_all: torch.Tensor, nbrs: torch.Tensor,
                 n: int) -> torch.Tensor:
    """bool[..., N, R]: the OR over each node's whole neighbour row."""
    return pull_merge(seen_all, nbrs, n)
