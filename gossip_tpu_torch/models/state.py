"""Simulation state of the XLA engine: the whole cluster as a few tensors.

The port of the JAX package's ``models/state.py``.  ``seen`` is
``bool[N, R]`` (node i holds rumor r) or, on the bit-packed engine, the
same bits packed 32 rumors to a word (:mod:`gossip_tpu_torch.ops.bitpack`).
The PRNG key is its two threefry words (:mod:`gossip_tpu_torch.ops.threefry`);
round keys are ``fold_in(key, round)``.  ``msgs`` is a float32 scalar on
the state's device, accumulated in the reference's order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch.config import FaultConfig, ProtocolConfig, RunConfig
from gossip_tpu_torch.ops import threefry
from gossip_tpu_torch.ops.common import resolve_device

DEATH_SALT = 0x5157      # the static dead set's key is key(fault.seed ^ this)


class SimState(NamedTuple):
    seen: torch.Tensor       # bool[N, R], or int32[N, W] packed words
    round: int               # the synchronous clock
    key: torch.Tensor        # int64[2]: the base key's threefry words
    msgs: torch.Tensor       # float32 scalar: cumulative messages sent


def init_state(run: RunConfig, proto: ProtocolConfig, n: int,
               device=None) -> SimState:
    """Rumor r starts at node ``(origin + r) % n``; the key is
    ``key(run.seed)``.  On ``device`` (default CUDA)."""
    dev = resolve_device(device)
    r = proto.rumors
    seen = torch.zeros(n, r, dtype=torch.bool, device=dev)
    cols = torch.arange(r, device=dev)
    seen[(run.origin + cols) % n, cols] = True
    return SimState(seen=seen, round=0, key=threefry.key(run.seed, dev),
                    msgs=torch.zeros((), dtype=torch.float32, device=dev))


def static_death_draw(fault: Optional[FaultConfig], n: int,
                      device=None) -> Optional[torch.Tensor]:
    """The one static-death draw: alive where
    ``bernoulli(key(fault.seed ^ 0x5157), rate, (n,))`` is False; None
    without deaths."""
    if fault is None or fault.node_death_rate <= 0.0:
        return None
    k = threefry.key(fault.seed ^ DEATH_SALT, resolve_device(device))
    return ~threefry.bernoulli(k, fault.node_death_rate, (n,))


def alive_mask(fault: Optional[FaultConfig], n: int, origin: int = 0,
               device=None) -> Optional[torch.Tensor]:
    """bool[n] static alive mask with the rumor origin pinned alive; None
    when nothing dies (the fault-free path masks nothing)."""
    alive = static_death_draw(fault, n, device)
    if alive is None:
        return None
    alive[origin] = True
    return alive


def state_from_numpy(seen, round_, key_data, msgs, device=None) -> SimState:
    """The port's state from the reference's ``SimState`` as numpy values:
    ``seen`` bool[N, R] (or uint32[N, W] packed words, kept as int32 with
    the same bits), the round, ``jax.random.key_data(base_key)`` as
    uint32[2], and msgs."""
    dev = resolve_device(device)
    seen = np.asarray(seen)
    if seen.dtype == np.bool_:
        t = torch.from_numpy(seen.copy())
    elif seen.dtype == np.uint32:
        t = torch.from_numpy(np.ascontiguousarray(seen).view(np.int32).copy())
    else:
        raise ValueError(f"seen must be bool or uint32, got {seen.dtype}")
    return SimState(seen=t.to(dev), round=int(round_),
                    key=threefry.key_from_words(key_data, dev),
                    msgs=torch.tensor(np.float32(msgs), device=dev))


def state_to_numpy(state: SimState):
    """(seen, round, key_data, msgs) as the reference's numpy values:
    bool seen as bool, packed words as uint32, the key as uint32[2]."""
    seen = state.seen.detach().cpu().contiguous().numpy()
    if seen.dtype == np.int32:
        seen = seen.view(np.uint32)
    return (seen, np.int32(state.round), threefry.key_to_words(state.key),
            np.float32(state.msgs.item()))
