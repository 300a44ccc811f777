"""Decisions every engine of the port shares: which device an entry
point runs on, how a 32-bit word is held, and the float32 arithmetic
that turns a count into the reference's coverage.

Declared deviation: float32 sums past 2^24.  The reference adds float32
values for its coverage (``jnp.mean`` or ``.sum()`` of float32 bits, in
``models/si.coverage`` and ``ops/bitpack.coverage_packed``) and for the
sharded drivers' ``msgs`` and ``lost`` (a float32 ``psum`` of the
shards' partials).  The port counts nodes in integers at every size and
rounds the count to float32 once; it does not copy XLA's reduction
order, which is one backend's, not the reference's behaviour.  So:

* up to 2^24 nodes every float32 sum is exact, and the port's coverage,
  stop round and ``msgs`` are bitwise the reference's;
* past 2^24 nodes the port's coverage is held to the reference's within
  the float32 rounding of the count (one ulp of the sum), and its stop
  round within one round.  The run report carries the exact count
  beside the fraction (``meta.coverage_count`` over
  ``meta.coverage_total``);
* the sharded ``msgs`` and ``lost`` add the ranks' float32 partials in
  rank order (:func:`rank_order_sum`), as XLA's CPU ``psum`` does; that
  is bitwise the reference's whenever the round's total is exact in
  float32, and within one rounding a round past it.
"""

from __future__ import annotations

import numpy as np
import torch

from gossip_tpu_torch.ops.philox import MASK32


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bit_tensor(bits, device) -> torch.Tensor:
    """Injected bits as a tensor on ``device``: a uint32 numpy array is
    taken as int32 with the same bits, a tensor as it is."""
    if isinstance(bits, np.ndarray):
        bits = torch.from_numpy(
            np.ascontiguousarray(bits, np.uint32).view(np.int32))
    return bits.to(device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without a card it raises, unless the CPU was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            "the port needs a CUDA device (its rounds run on the card) "
            "and torch sees none; pass device='cpu' (--device cpu) to run "
            "the plain versions on the CPU")
    return dev


def f32_fraction(count: int, total: int) -> float:
    """``float32(count) / float32(total)`` in float32, the reference's
    coverage division (and so its loops' stop tests)."""
    return float(np.float32(count) / np.float32(total))


def f32_mean(count: int, n: int) -> float:
    """``float32(count) * float32(1 / n)`` in float32: a plain mean of
    ``n`` bits as XLA computes it (the exact sum times the float32
    reciprocal of ``n``), and so any division by a static ``n`` inside
    ``jax.jit``, such as the reference's compiled loops' coverage."""
    return float(np.float32(count) * (np.float32(1) / np.float32(n)))


def rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum over the leading axis of ``parts`` (one row per rank),
    added in rank order in float32: ``((p0 + p1) + p2) + ...``.  Every
    rank that holds the same rows holds the same sum."""
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc
