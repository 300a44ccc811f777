"""The peer-sampling kernel: uniform complete-graph peers in one launch.

The port of the JAX package's ``ops/pallas_sampling.py``.  The default
sampler (:mod:`gossip_tpu_torch.ops.sampling`) derives a threefry key per
node and draws through it: about five threefry evaluations per node per
round.  This kernel (``csrc/sampler.cu``) replaces the keys and the draw
with one counter-based stream: element ``(i, c)`` of the ``[n_rows, k]``
output maps one 32-bit draw ``u`` to ``u % n`` or, excluding self,
``t = u % (n - 1)``, ``t + (t >= i)``, the TPU kernel's mapping.  The
stream is the port's Philox stream (``ops/philox.py``, "peer sampler"):
the TPU kernel's hardware generator has no GPU counterpart, so
trajectories differ from the threefry sampler's, as they do on the TPU.
The modulo has a selection bias below ``n / 2^32``.

Where this differs from the reference: the reference's
``sample_peers_fast`` falls back to the threefry sampler off the TPU.  The
port does not: on a CUDA device :func:`sample_targets` launches the kernel
(or raises), and on an explicit CPU device it runs
:func:`sample_targets_plain`, the same Philox stream in plain torch.  So
``sampler="kernel"`` draws one stream on every device.
"""

from __future__ import annotations

import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops.common import bit_tensor, resolve_device

ROUND_MIX = 1000003


def round_seed(base_seed: int, round_: int) -> int:
    """The kernel's int32 seed scalar: ``int32(seed) * 1000003 +
    int32(round)``, wrapping in int32 as the reference's does."""
    v = ((int(base_seed) & 0xFFFFFFFF) * ROUND_MIX + (int(round_)
                                                      & 0xFFFFFFFF))
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _map(u: torch.Tensor, n_rows: int, k: int, n_total: int,
         exclude_self: bool) -> torch.Tensor:
    """Draws int64 ``[n_rows, k]`` in ``[0, 2^32)`` -> int32 peers."""
    if exclude_self and n_total > 1:
        t = u % (n_total - 1)
        rows = torch.arange(n_rows, dtype=torch.int64, device=u.device)
        return (t + (t >= rows[:, None]).to(torch.int64)).to(torch.int32)
    return (u % n_total).to(torch.int32)


def _check_args(n_rows: int, k: int, n_total: int):
    if n_rows < 0 or k < 1:
        raise ValueError(f"need n_rows >= 0 and k >= 1, got {n_rows}, {k}")
    if not 0 < n_total < 1 << 31:
        raise ValueError(f"n_total must be in [1, 2^31), got {n_total}")
    if n_rows * k >= philox.SAMPLER_MAX_ELEMENTS:
        raise ValueError(f"n_rows * k = {n_rows * k} exceeds the sampler "
                         "stream's 2^34 elements")


def sample_targets_plain(seed_scalar: int, n_rows: int, n_total: int,
                         k: int = 1, exclude_self: bool = True,
                         inject_bits=None, device=None) -> torch.Tensor:
    """The kernel in plain torch: int32[n_rows, k] peers from the
    sampler stream keyed by ``seed_scalar``, or from ``inject_bits``
    (uint32 numpy or int32 tensor ``[n_rows, k]``)."""
    _check_args(n_rows, k, n_total)
    dev = resolve_device(device)
    if inject_bits is None:
        u = philox.sampler_words(seed_scalar, n_rows * k, dev)
    else:
        u = bit_tensor(inject_bits, dev).to(torch.int64) & philox.MASK32
    return _map(u.reshape(n_rows, k), n_rows, k, n_total, exclude_self)


def sample_targets(seed_scalar: int, n_rows: int, n_total: int, k: int = 1,
                   exclude_self: bool = True, inject_bits=None,
                   device=None) -> torch.Tensor:
    """Uniform peers on the implicit complete graph, int32[n_rows, k]: one
    launch of ``csrc/sampler.cu`` on a CUDA device, the plain version on
    the CPU (default device: CUDA)."""
    _check_args(n_rows, k, n_total)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return sample_targets_plain(seed_scalar, n_rows, n_total, k,
                                    exclude_self, inject_bits, dev)
    if dev.type != "cuda":
        raise ValueError(f"no sampler for a {dev.type} device; the port "
                         "runs on cuda or cpu")
    out = torch.empty(n_rows, k, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out
    inject = (None if inject_bits is None
              else bit_tensor(inject_bits, dev).contiguous())
    return _kernels.sampler(out, n_total, exclude_self, seed_scalar,
                            inject_bits=inject)


def sample_peers_fast(base_seed: int, round_: int, n_rows: int,
                      n_total: int, k: int = 1, exclude_self: bool = True,
                      device=None) -> torch.Tensor:
    """The rounds' entry: :func:`sample_targets` keyed by
    ``round_seed(base_seed, round_)``, on every device (no threefry
    fallback; module doc)."""
    return sample_targets(round_seed(base_seed, round_), n_rows, n_total, k,
                          exclude_self, device=device)
