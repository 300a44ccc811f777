"""The roofline's calibration microkernels and their plain versions.

The port of the three Pallas microkernels of the JAX package's
``tools/roofline.py`` (``prng_body``, ``prng_gather_body``,
``vpu_body``), which time the fused round kernels' primitive operations
at the shape those kernels use: an ``[R, 128]`` table of 32-bit words
(``R = n_rows(n)``, 2448 at N = 10M), the int32 tensor of the round
modules holding the reference's uint32 bits.  Each step takes the chained
iteration ``i`` and updates the table in place, as the reference's
aliased call does:

* :func:`prng_chain_step`: ``t[i, j] |= OR_{d<32} draw_d(w)``;
* :func:`prng_gather_step`: ``t[i, j] |= OR_{d<32} t[i, draw_d(w) & 127]``,
  every gather reading the pre-call row;
* :func:`vpu_step`: 256 steps ``acc = (acc ^ (s + k)) | (acc >> 1)`` in
  uint32, ``s = uint32(int32(i) * 1000003)``.

``draw_d(w)`` of word ``w = i*128 + j`` is the single-rumor round's
Philox stream (:mod:`gossip_tpu_torch.ops.philox`), keyed for iteration
``i`` by :func:`step_key` ``= round_key(i, i)``, the reference's seed pair
``[i * 1000003, i]``: the microkernels draw exactly the bits the round
kernel draws, and no new stream is defined.  ``inject_bits``
(int32[32, R, 128], or uint32 numpy with the same bits) replaces the
draws, ``inject_bits[d, i, j]`` for ``draw_d(w)``.  The reference's
interpreter draws zeros, so under zero bits the plain steps equal its
microkernels.

On a CUDA tensor each step launches its kernel in ``csrc/calibrate.cu``;
on a CPU tensor it runs the plain version (``*_plain``, which returns a
new tensor).  Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops.common import bit_tensor, from_words, to_words

LANES = 128
DRAWS = 32                 # draws per word, one per bit plane
VPU_CHAIN = 256            # dependent steps per word of the vpu chain
MASK32 = philox.MASK32


def step_key(i: int):
    """(k0, k1) of chained iteration ``i``: ``(uint32(i) * 1000003, i)``,
    the reference's seed pair; ``k0`` is also the vpu chain's ``s``."""
    return philox.round_key(i, i)


def _draws(i: int, rows: int, inject_bits, device) -> torch.Tensor:
    """int64[32, rows, 128]: every word's 32 draws, from the stream or
    the injected bits."""
    if inject_bits is None:
        return philox.draw_words(*step_key(i), rows, DRAWS, device)
    return to_words(bit_tensor(inject_bits, device))


def prng_chain_step_plain(i: int, table: torch.Tensor,
                          inject_bits=None) -> torch.Tensor:
    """The prng microkernel in plain torch: ``table`` ORed with its
    words' 32 draws."""
    acc = to_words(table)
    for d in _draws(i, table.shape[0], inject_bits, table.device):
        acc = acc | d
    return from_words(acc)


def prng_gather_step_plain(i: int, table: torch.Tensor,
                           inject_bits=None) -> torch.Tensor:
    """The prng_gather microkernel in plain torch: ``table`` ORed with
    the 32 words of its own pre-call row that its draws pick."""
    t = to_words(table)
    acc = t
    for d in _draws(i, table.shape[0], inject_bits, table.device):
        acc = acc | torch.gather(t, 1, d & (LANES - 1))
    return from_words(acc)


def vpu_step_plain(i: int, table: torch.Tensor) -> torch.Tensor:
    """The vpu microkernel in plain torch: the 256-step chain on every
    word, in uint32 arithmetic held in int64."""
    s = step_key(i)[0]
    acc = to_words(table)
    for k in range(VPU_CHAIN):
        acc = (acc ^ ((s + k) & MASK32)) | (acc >> 1)
    return from_words(acc)


def _device_of(table: torch.Tensor) -> str:
    """"cuda" or "cpu" for an int32[R, 128] table; raise otherwise."""
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != LANES:
        raise ValueError(f"table must be int32[R, {LANES}], got "
                         f"{table.dtype}{list(table.shape)}")
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no calibration kernel for a {table.device.type} "
                         "tensor; the port runs on cuda or cpu")
    return table.device.type


def _drawing_step(launch, plain, i: int, table: torch.Tensor, inject_bits):
    """One step of a drawing microkernel on ``table`` in place: the
    kernel for a CUDA table, the plain version for a CPU one."""
    if _device_of(table) == "cuda":
        bits = (None if inject_bits is None
                else bit_tensor(inject_bits, table.device))
        return launch(table, step_key(i), bits)
    return table.copy_(plain(i, table, inject_bits))


def prng_chain_step(i: int, table: torch.Tensor,
                    inject_bits=None) -> torch.Tensor:
    """Chained step ``i`` of the prng microkernel, in place; returns
    ``table``."""
    return _drawing_step(_kernels.cal_prng, prng_chain_step_plain, i, table,
                         inject_bits)


def prng_gather_step(i: int, table: torch.Tensor,
                     inject_bits=None) -> torch.Tensor:
    """Chained step ``i`` of the prng_gather microkernel, in place;
    returns ``table``."""
    return _drawing_step(_kernels.cal_prng_gather, prng_gather_step_plain, i,
                         table, inject_bits)


def vpu_step(i: int, table: torch.Tensor) -> torch.Tensor:
    """Chained step ``i`` of the vpu microkernel, in place; returns
    ``table``.  It draws nothing, so it takes no injected bits."""
    if _device_of(table) == "cuda":
        return _kernels.cal_vpu(table, step_key(i)[0])
    return table.copy_(vpu_step_plain(i, table))
