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
"""

from __future__ import annotations

import torch


def push_counts(n_pad: int, targets: torch.Tensor,
                payload: torch.Tensor) -> torch.Tensor:
    """int32[n_pad, R]: row t counts the senders i with target t whose
    ``payload[i]`` holds each rumor.  Targets are ids in ``[0, n_pad)`` or
    ``n_pad`` (dropped: they land in one extra row that is cut off, so the
    sentinel never reaches the reduce-scatter)."""
    nl, k = targets.shape
    r = payload.shape[1]
    flat_t = targets.reshape(-1).to(torch.int64)
    flat_p = payload.to(torch.int32)[:, None, :].expand(nl, k, r)
    hits = torch.zeros(n_pad + 1, r, dtype=torch.int32,
                       device=payload.device)
    hits.index_add_(0, flat_t, flat_p.reshape(nl * k, r))
    return hits[:n_pad]


def push_delta(n: int, targets: torch.Tensor,
               payload: torch.Tensor) -> torch.Tensor:
    """bool[n, R]: row t is the OR of ``payload[i]`` over every node i
    with target t.  Targets are ids in ``[0, n)`` or the sentinel ``n``
    (dropped)."""
    return push_counts(n, targets, payload) > 0


def pull_merge(seen_all: torch.Tensor, partners: torch.Tensor,
               valid_sentinel: int) -> torch.Tensor:
    """bool[N, R]: the OR of the k sampled peers' rows; sentinel entries
    are masked out."""
    valid = partners < valid_sentinel
    safe = torch.clamp(partners, max=valid_sentinel - 1).to(torch.int64)
    got = seen_all[safe] & valid[:, :, None]
    return got.any(dim=1)


def flood_gather(seen_all: torch.Tensor, nbrs: torch.Tensor,
                 n: int) -> torch.Tensor:
    """bool[N, R]: the OR over each node's whole neighbour row."""
    return pull_merge(seen_all, nbrs, n)
