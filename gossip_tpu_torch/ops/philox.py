"""Philox4x32-10 in plain torch, and the random streams of the fused rounds.

The TPU kernel draws its partner bits from the TPU's hardware generator
(``pltpu.prng_seed`` / ``prng_random_bits``), which has no counterpart on
a GPU.  The port defines its own counter-based streams instead; the CUDA
kernels (``csrc/philox.cuh``) compute exactly the same bits, and the
plain rounds in :mod:`gossip_tpu_torch.ops.fused_round` and
:mod:`gossip_tpu_torch.ops.fused_mr_round` draw them here.

Stream specification (the CUDA source mirrors it word for word)
---------------------------------------------------------------
* Generator: Philox4x32-10 of Random123 (Salmon et al., SC'11):
  multipliers ``0xD2511F53``, ``0xCD9E8D57``; Weyl key increments
  ``0x9E3779B9``, ``0xBB67AE85``; ten rounds, the key bumped between
  rounds.  Known answer: counter ``(0, 0, 0, 0)``, key ``(0, 0)`` gives
  ``6627e8d5 e169c58d bc57ac4c 9b00dbd8``.
* Key of a round: ``k0 = uint32(seed) * 1000003 mod 2^32`` (the bits of
  the TPU path's wrapping int32 product), ``k1 = uint32(round) ^ salt``;
  the salt of the single-rumor round is 0.
* Draw ``d`` of table word ``w = i*128 + j`` (row ``i``, lane ``j``):
  ``Philox(ctr=(w, d >> 2, 0, 0), key)[d & 3]``.  A round makes
  ``32 * fanout / plane_sharing`` draws per word, ``d`` indexing them in
  the layout of the TPU kernel's injected ``rbits``
  (``d = (k // plane_sharing) * fanout + f`` for bit plane ``k``, fanout
  draw ``f``).
* Row shift of lane ``j``: ``Philox(ctr=(j, 0, 1, 0), key)[0]``, reduced
  ``% rows`` (unsigned) by the round, as the TPU kernel reduces
  ``sbits[0, j]``.

The multi-rumor round (``csrc/fused_mr_round.cu`` and ``csrc/mr_gather.cu``,
both routes of :mod:`gossip_tpu_torch.ops.fused_mr_round`) draws one
stream of its own:

* Key: ``k1`` carries the salt ``0x5D0`` (:data:`MR_SALT`, the TPU
  path's ``round_salt``), so ``(uint32(seed) * 1000003, uint32(round) ^
  0x5D0)``.
* Shift word of lane ``j`` for fanout draw ``f``:
  ``Philox(ctr=(j, f, 1, 0), key)[0]``, reduced ``% rows``.
* Draw ``f`` of word ``w``: ``Philox(ctr=(w, f >> 2, 0, 0), key)[f & 3]``
  (the single-rumor layout with one draw per fanout draw).

The TPU path's staged route keys a different stream (threefry shifts,
per-block hardware seeds); that stream is an artifact of the TPU and is
not reproduced: both routes of the port draw the stream above.

The peer sampler (``csrc/sampler.cu``, the plain
:func:`gossip_tpu_torch.ops.fast_sampling.sample_targets_plain`) draws a
third stream, one word per output element:

* Key: ``(uint32(s), 0x5A3)`` (:data:`SAMPLER_SALT`), ``s`` the int32
  seed scalar (``round_seed(seed, round)``).
* Element ``e = i * k + c`` of the ``[n_rows, k]`` output:
  ``Philox(ctr=(e >> 2, 0, 2, 0), key)[e & 3]``, so one call serves four
  consecutive elements; counter word 2 keeps it apart from the round
  streams, and ``n_rows * k < 2^34`` keeps ``e >> 2`` in 32 bits.

The TPU kernel reseeds its hardware generator per 4096-row block; that
blocking is an artifact of the TPU grid and is not reproduced.

Representation: torch has no unsigned 32-bit arithmetic on every backend,
so the plain functions hold 32-bit words as int64 values in
``[0, 2^32)`` and mask after every operation.  A 32 x 32-bit product
does not fit int64, so ``mulhilo`` splits the multiplier into 16-bit
halves.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
ROUND_MIX = 1000003          # seed-mixing prime of the TPU path's seed pair
MR_SALT = 0x5D0              # round salt of the multi-rumor stream
SAMPLER_SALT = 0x5A3         # second key word of the sampler's stream
SAMPLER_MAX_ELEMENTS = 1 << 34
LANES = 128


def round_key(seed: int, round_: int, salt: int = 0):
    """(k0, k1) of one round, as Python ints in [0, 2^32)."""
    return ((int(seed) & MASK32) * ROUND_MIX & MASK32,
            (int(round_) & MASK32) ^ salt)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2^32), without overflowing int64."""
    lo_part = x * (m & 0xFFFF)                      # < 2^48
    hi_part = x * (m >> 16)                         # < 2^48
    mid = lo_part + ((hi_part & 0xFFFF) << 16)      # < 2^49
    return (hi_part >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counter ``(c0, c1, c2, c3)`` under key
    ``(k0, k1)``; counters are int64 tensors or ints in [0, 2^32) that
    broadcast together, keys ints.  Returns four int64 tensors on the
    device of the tensor counters."""
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    # an int counter is filled on the device, not copied from the host,
    # so a CUDA graph can capture the call
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(c.to(torch.int64) if isinstance(c, torch.Tensor)
          else torch.full((), c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def shift_words(k0: int, k1: int, draws: int = 1,
                device=None) -> torch.Tensor:
    """int64[draws, 128]: the raw shift word of every lane for every
    fanout draw ``f < draws``, ``Philox(ctr=(j, f, 1, 0))[0]`` (reduce
    ``% rows``).  The single-rumor round takes draw 0 only."""
    lanes = torch.arange(LANES, dtype=torch.int64, device=device)
    fs = torch.arange(draws, dtype=torch.int64, device=device)
    return philox4x32_10(lanes[None, :], fs[:, None], 1, 0, k0, k1)[0]


def sampler_words(seed_scalar: int, total: int,
                  device=None) -> torch.Tensor:
    """int64[total]: the sampler stream's word of every output element."""
    if not 0 <= total < SAMPLER_MAX_ELEMENTS:
        raise ValueError(f"the sampler stream numbers at most 2^34 "
                         f"elements, got {total}")
    calls = torch.arange(-(-total // 4), dtype=torch.int64, device=device)
    words = philox4x32_10(calls, 0, 2, 0, int(seed_scalar) & MASK32,
                          SAMPLER_SALT)
    return torch.stack(words, dim=1).reshape(-1)[:total]


def draw_words(k0: int, k1: int, rows: int, draws: int,
               device=None) -> torch.Tensor:
    """int64[draws, rows, 128]: draw ``d`` of every table word."""
    words = torch.arange(rows * LANES, dtype=torch.int64,
                         device=device).reshape(rows, LANES)
    out = []
    for q in range(0, draws, 4):
        out.extend(philox4x32_10(words, q >> 2, 0, 0, k0, k1))
    return torch.stack(out[:draws])
