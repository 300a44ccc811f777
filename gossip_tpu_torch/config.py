"""Configuration dataclasses of the fused single-rumor route.

The port keeps its own copy of the fields and checks that the fused pull
route reads, with the field names of the JAX package's ``config.py`` so a
caller (or a test) can build both from the same keyword arguments.  All
configs are frozen.
"""

from __future__ import annotations

import dataclasses

MODES = ("push", "pull", "pushpull", "flood", "antientropy", "swim",
         "rumor")
FAMILIES = ("complete", "ring", "grid", "erdos_renyi", "watts_strogatz",
            "power_law")
ENGINES = ("auto", "fused", "xla", "native")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Which graph the rumor spreads on.  ``complete`` is implicit: a
    uniform random peer, no neighbour table."""

    family: str = "complete"
    n: int = 1024

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown topology family {self.family!r}")
        if self.n < 2:
            raise ValueError("need at least 2 nodes")


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Gossip protocol semantics: every node contacts ``fanout`` sampled
    peers per round; ``rumors`` concurrent rumors."""

    mode: str = "push"
    fanout: int = 1
    rumors: int = 1

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown protocol mode {self.mode!r}")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if self.rumors < 1:
            raise ValueError("rumors must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """In-kernel fault injection: a static dead set drawn at
    ``node_death_rate`` from ``seed``, and a per-pull drop probability.
    ``churn`` is any time-varying fault schedule; the port only records
    whether one was given (the fused route refuses it)."""

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
    """Run parameters: run until ``target_coverage`` or
    ``max_rounds``; ``engine`` selects the round implementation (the port
    has only ``fused``)."""

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
