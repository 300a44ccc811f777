"""Configuration dataclasses of the port's engines.

The port keeps its own copy of the fields and checks that its engines
read, with the field names and defaults of the JAX package's
``config.py`` (except ``RunConfig.engine``, whose default stays
``fused``), so a caller (or a test) can build both from the same keyword
arguments.  All configs are frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY, SWIM, RUMOR = (
    "push", "pull", "pushpull", "flood", "antientropy", "swim", "rumor")
MODES = (PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY, SWIM, RUMOR)
SI_MODES = (PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY)
COMPLETE, RING, GRID, ERDOS_RENYI, WATTS_STROGATZ, POWER_LAW = (
    "complete", "ring", "grid", "erdos_renyi", "watts_strogatz", "power_law")
FAMILIES = (COMPLETE, RING, GRID, ERDOS_RENYI, WATTS_STROGATZ, POWER_LAW)
ENGINES = ("auto", "fused", "xla", "native")
EXCHANGES = ("dense", "sparse", "halo")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Which graph the rumor spreads on.  ``complete`` is implicit: a
    uniform random peer, no neighbour table; the other families are
    padded neighbour tables (:mod:`gossip_tpu_torch.topology.generators`).
    ``k``: ring / Watts-Strogatz neighbours, power-law attachment edges;
    ``p``: Erdos-Renyi edge or Watts-Strogatz rewire probability;
    ``degree_cap``: the table's width cap; ``seed``: the generator's."""

    family: str = COMPLETE
    n: int = 1024
    k: int = 4
    p: float = 0.01
    degree_cap: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown topology family {self.family!r}")
        if self.n < 2:
            raise ValueError("need at least 2 nodes")


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Gossip protocol semantics: every node contacts ``fanout`` sampled
    peers per round (never itself when ``exclude_self``); ``rumors``
    concurrent rumors; anti-entropy exchanges every ``period`` rounds."""

    mode: str = PUSH
    fanout: int = 1
    rumors: int = 1
    exclude_self: bool = True
    period: int = 1

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown protocol mode {self.mode!r}")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if self.rumors < 1:
            raise ValueError("rumors must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """In-round fault injection: a static dead set drawn at
    ``node_death_rate`` from ``seed`` (``models/state.alive_mask``), and
    a per-pull drop probability.  ``churn`` is any time-varying fault
    schedule; the port only records whether one was given (every engine
    refuses it until the nemesis slice)."""

    node_death_rate: float = 0.0
    drop_prob: float = 0.0
    seed: int = 0
    churn: object = None

    def __post_init__(self):
        if not 0.0 <= self.node_death_rate <= 1.0:
            raise ValueError(
                f"node_death_rate={self.node_death_rate} outside [0, 1]")
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob={self.drop_prob} outside [0, 1]")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run parameters: run until ``target_coverage`` or ``max_rounds``.
    ``engine``: ``fused`` (the CUDA round kernels: pull on the implicit
    complete graph), ``xla`` (the threefry-keyed engine of the JAX
    package's XLA path: every SI mode, every topology, bit-packed for
    pull and anti-entropy), ``auto`` (fused where it is eligible, else
    xla); ``native`` belongs to the JAX package's event simulator and is
    refused."""

    target_coverage: float = 0.99
    max_rounds: int = 256
    seed: int = 0
    origin: int = 0
    engine: str = "fused"

    def __post_init__(self):
        if not 0.0 < self.target_coverage <= 1.0:
            raise ValueError("target_coverage must be in (0, 1]")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"choose from {ENGINES}")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for node sharding.  The port runs one device; a mesh
    of more, or another exchange, is refused until the multi-GPU slice."""

    n_devices: int = 1
    exchange: str = "dense"

    def __post_init__(self):
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; "
                             f"choose from {EXCHANGES}")
