"""Bit-packed rumor state: 32 rumors per 32-bit word.

The port of the JAX package's ``ops/bitpack.py``.  Rumor ``r`` lives in
word ``r // 32``, bit ``r % 32``.  Words are int32 tensors holding the
reference's uint32 bits.  Padding bits past the rumor count stay zero and
every consumer masks by the real count.

Coverage is a float32 fraction of an integer count.  The reference sums
float32 bits, which is exact up to 2^24 nodes; the port counts in
integers at every size (a declared deviation: past 2^24 nodes the
coverage is within one ulp of the reference's sum, the stop round within
one; :mod:`gossip_tpu_torch.ops.common`).  Its rounding is the
reference's: a plain mean
is ``float32(count) * float32(1 / n)`` (XLA turns the mean's division by
the constant ``n`` into a product with its reciprocal,
:func:`~gossip_tpu_torch.ops.common.f32_mean`), an alive-weighted one
``float32(count) / float32(n_alive)``, except inside the reference's
compiled loops under a fault program without random deaths, where the
alive count is a constant too and the quotient is again a product
(``folded``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch.ops.common import f32_fraction, f32_mean, from_words

WORD = 32


def n_words(rumors: int) -> int:
    return (rumors + WORD - 1) // WORD


def pack(seen: torch.Tensor) -> torch.Tensor:
    """bool[N, R] -> int32[N, ceil(R / 32)]."""
    n, r = seen.shape
    w = n_words(r)
    bits = torch.zeros(n, w * WORD, dtype=torch.int64, device=seen.device)
    bits[:, :r] = seen.to(torch.int64)
    weights = torch.arange(WORD, dtype=torch.int64, device=seen.device)
    words = (bits.reshape(n, w, WORD) << weights).sum(dim=2)
    return from_words(words)


def unpack(packed: torch.Tensor, rumors: int) -> torch.Tensor:
    """int32[N, W] -> bool[N, rumors]."""
    n, w = packed.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * WORD)[:, :rumors].to(torch.bool)


def rumor_count_tensor(packed: torch.Tensor, rumors: int,
                       alive: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """int64[rumors] on the words' device: the nodes holding each rumor
    (alive nodes only, with ``alive``), exact."""
    words = packed if alive is None else torch.where(
        alive[:, None], packed, torch.zeros((), dtype=packed.dtype,
                                            device=packed.device))
    masks = np.left_shift(np.uint32(1), np.arange(WORD, dtype=np.uint32)
                          ).view(np.int32)
    return torch.stack([torch.count_nonzero(words[:, r // WORD]
                                            & int(masks[r % WORD]))
                        for r in range(rumors)])


def rumor_counts_packed(packed: torch.Tensor, rumors: int,
                        alive: Optional[torch.Tensor] = None) -> list:
    """:func:`rumor_count_tensor` as a list of ints (one host read)."""
    return rumor_count_tensor(packed, rumors, alive).tolist()


def coverage_count_packed(packed: torch.Tensor, rumors: int,
                          alive: Optional[torch.Tensor] = None):
    """``(count, total)``: the exact holders of the least-held rumor
    (alive nodes only, with ``alive``) and the nodes counted."""
    low = min(rumor_counts_packed(packed, rumors, alive))
    return low, packed.shape[0] if alive is None else int(alive.sum())


def coverage_packed(packed: torch.Tensor, rumors: int,
                    alive: Optional[torch.Tensor] = None,
                    folded: bool = False) -> float:
    """Min-over-rumors coverage of a packed state, alive-weighted with
    ``alive`` (``folded``: as a product with the reciprocal of the alive
    count, ``models.si.coverage``)."""
    low, total = coverage_count_packed(packed, rumors, alive)
    frac = f32_mean if alive is None or folded else f32_fraction
    return frac(low, total)
