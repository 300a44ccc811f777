"""Threefry-2x32 keys and draws in plain torch, bitwise equal to ``jax.random``.

The JAX package's XLA engine keys every draw with threefry:
``fold_in(fold_in(key(seed), round), node_id)`` (its ``ops/sampling.py``).
That stream does not depend on the platform, so the port reproduces it
bit for bit, as jax 0.9.0 computes it with ``jax_threefry_partitionable``
on and ``jax_default_prng_impl = threefry2x32``:

* ``threefry2x32(k, x)``: Threefry-2x32 with 20 rounds, rotations
  ``(13, 15, 26, 6)`` and ``(17, 29, 16, 24)``, key schedule
  ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)`` injected every four rounds with the
  round count ``1..5`` added to the second word (``jax/_src/prng.py``,
  ``_threefry2x32_lowering``);
* ``key(seed)``: the two words ``(0, seed mod 2^32)`` of a 32-bit seed
  (``threefry_seed``);
* ``fold_in(key, d)``: ``threefry2x32(key, (0, uint32(d)))``;
* ``split(key, num)[i]``: ``threefry2x32(key, (0, i))`` (the
  partitionable, fold-like split);
* ``random_bits(key, shape)``: element ``i`` (row-major) is ``y0 ^ y1`` of
  ``threefry2x32(key, (i >> 32, i mod 2^32))``;
* ``randint(key, shape, lo, hi)`` (int32): two words per element, from
  ``split(key)``'s halves, combined as ``jax/_src/random.py:_randint``
  does in wrapping uint32 arithmetic;
* ``uniform`` (float32 in ``[0, 1)``): ``(bits >> 9) | 0x3F800000``
  bitcast, minus 1.0;
* ``bernoulli(key, p, shape)``: ``uniform < float32(p)``;
* ``permutation(key, p)`` of ``arange(p)`` (``_shuffle``): ``ceil(3 ln
  max(1, p) / ln(2^32 - 1))`` rounds, each ``key, sub = split(key)``, then
  a stable sort of the values by ``random_bits(sub, (p,))`` read as
  unsigned.

Representation: a key is an int64 tensor whose last axis holds the two
32-bit words, values in ``[0, 2^32)``; a batch of keys is ``[..., 2]``.
Every function that takes a key batch applies the single-key function to
each key, as the JAX package's ``vmap`` over keys does, written as a
broadcast, never a Python loop.  Words are held as int64 and masked after
every operation (torch has no complete unsigned 32-bit arithmetic on every
device).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)`` under key
    words ``(k0, k1)``; all four int64 tensors (or ints) in ``[0, 2^32)``
    that broadcast together.  Returns the two output words."""
    words = (k0, k1, x0, x1)
    if not any(isinstance(t, torch.Tensor) for t in words):
        words = tuple(torch.as_tensor(t, dtype=torch.int64) for t in words)
    # an int stays a Python scalar (a tensor made of it on a card would be
    # a blocking host-to-device copy); the first round's mixing broadcasts
    # both words to the operands' common shape
    k0, k1, x0, x1 = (t.to(torch.int64) if isinstance(t, torch.Tensor)
                      else int(t) for t in words)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """int64[2]: ``jax.random.key(seed)``'s words for a 32-bit seed
    (negative seeds wrap: ``key(-1)`` is ``(0, 0xFFFFFFFF)``)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < 1 << 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def key_from_words(words, device=None) -> torch.Tensor:
    """int64[..., 2] from ``jax.random.key_data`` words (uint32 numpy)."""
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64)
                            ).to(device)


def key_to_words(k: torch.Tensor) -> np.ndarray:
    """uint32 numpy words of a key (batch), as ``jax.random.key_data``."""
    return k.detach().cpu().numpy().astype(np.uint32)


def _hash(k: torch.Tensor, x0, x1) -> torch.Tensor:
    """``threefry2x32`` of a key batch ``[..., 2]`` (broadcast against the
    counters) stacked as a key batch."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], x0, x1)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a key batch ``[..., 2]`` folded with 32-bit
    ``data`` (an int or an integer tensor broadcast against the batch;
    negative values wrap as ``uint32(data)`` does)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    return _hash(k, 0, data)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` of a key batch: ``[num, ..., 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    i = i.reshape((num,) + (1,) * (k.dim() - 1))
    return _hash(k.unsqueeze(0), 0, i)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` of a key batch ``[..., 2]``:
    int64 words of shape ``(..., *shape)``."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    i = torch.arange(size, dtype=torch.int64, device=k.device).reshape(shape)
    kk = k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(kk[..., 0], kk[..., 1], i >> 32, i & MASK32)
    return y0 ^ y1


def _as_bound(v):
    return v.to(torch.int64) if isinstance(v, torch.Tensor) else int(v)


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, int32)`` of a key
    batch ``[..., 2]``: int64 values of shape ``(..., *shape)``.  The
    bounds are ints or integer tensors broadcast against that shape (the
    JAX function's static and value-only bounds draw alike: the draw
    depends on the bound's value only).

    ``_randint`` draws ``higher`` and ``lower`` words from the two halves
    of ``split(k)`` and returns ``minval + ((higher % span) * mult +
    lower % span) % span`` with ``mult = (2^16 % span)^2 % span``, every
    product wrapping in uint32.  For a span above 2^16 the wrapped
    ``mult`` is 0, so ``higher`` does not count; the function then skips
    its draw (the result is the same)."""
    dev = k.device
    lo, hi = _as_bound(minval), _as_bound(maxval)
    if any(isinstance(v, torch.Tensor) for v in (lo, hi)):
        lo_t = torch.as_tensor(lo, dtype=torch.int64, device=dev)
        hi_t = torch.as_tensor(hi, dtype=torch.int64, device=dev)
        for v in (lo_t, hi_t):
            if bool(((v < -(1 << 31)) | (v >= 1 << 31)).any()):
                raise ValueError("randint bounds must fit int32")
        span = torch.where(hi_t <= lo_t, 1, (hi_t - lo_t) & MASK32)
        static_big = False
    else:
        for v in (lo, hi):
            if not -(1 << 31) <= v < 1 << 31:
                raise ValueError("randint bounds must fit int32")
        span = 1 if hi <= lo else (hi - lo) & MASK32
        static_big = span > 1 << 16
        lo_t = lo
    lower = random_bits(_hash(k, 0, 1), shape)      # split(k)[1]
    if static_big:
        offset = lower % span
    else:
        mult = (((1 << 16) % span) * ((1 << 16) % span) & MASK32) % span
        higher = random_bits(_hash(k, 0, 0), shape)  # split(k)[0]
        offset = ((((higher % span) * mult) & MASK32) + lower % span) \
            & MASK32
        offset = offset % span
    # minval + int32(offset): the sum wraps in int32
    out = (lo_t + offset) & MASK32
    return torch.where(out >= 1 << 31, out - (1 << 32), out)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in ``[0, 1)`` of a key
    batch: float32 of shape ``(..., *shape)``."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` of a key batch: bool of shape
    ``(..., *shape)``, ``uniform < float32(p)``.  ``p`` is a float or a
    float32 tensor on the keys' device that broadcasts against that shape
    (a per-round probability read from a schedule table: 0-d, or one a
    batch point shaped ``[S, 1, ..., 1]``)."""
    if not isinstance(p, torch.Tensor):
        # a CPU scalar: a kernel argument on a card, with no copy
        p = torch.tensor(np.float32(p))
    elif p.dtype != torch.float32:
        raise ValueError(f"p must be a float32 tensor, got {p.dtype} "
                         f"of shape {tuple(p.shape)}")
    return uniform(k, shape) < p


def permutation(k: torch.Tensor, p: int) -> torch.Tensor:
    """``jax.random.permutation(k, arange(p))`` of one key: int64[p].
    ``_shuffle`` sorts the values by fresh random words as often as
    ``3 ln p / ln(2^32 - 1)`` says (one round up to p = 1625, two up to
    2^32 / 1625), each sort stable on the words read as unsigned."""
    x = torch.arange(p, dtype=torch.int64, device=k.device)
    rounds = int(np.ceil(3 * np.log(max(1, p))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (p,)), stable=True).indices
        x = x[order]
    return x
