"""Configuration dataclasses of the port's engines.

The port keeps its own copy of the fields and checks that its engines
read, with the field names and defaults of the JAX package's
``config.py`` (except ``RunConfig.engine``, whose default stays
``fused``), so a caller (or a test) can build both from the same keyword
arguments.  All configs are frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY, SWIM, RUMOR = (
    "push", "pull", "pushpull", "flood", "antientropy", "swim", "rumor")
MODES = (PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY, SWIM, RUMOR)
SI_MODES = (PUSH, PULL, PUSH_PULL, FLOOD, ANTI_ENTROPY)
COMPLETE, RING, GRID, ERDOS_RENYI, WATTS_STROGATZ, POWER_LAW = (
    "complete", "ring", "grid", "erdos_renyi", "watts_strogatz", "power_law")
FAMILIES = (COMPLETE, RING, GRID, ERDOS_RENYI, WATTS_STROGATZ, POWER_LAW)
RUMOR_VARIANTS = ("feedback", "blind")
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
    concurrent rumors; anti-entropy exchanges every ``period`` rounds.

    SWIM (:mod:`gossip_tpu_torch.models.swim`): ``swim_proxies`` indirect
    probes, ``swim_suspect_rounds`` before a suspect is confirmed dead,
    ``swim_subjects`` watched subjects (the window's width), which
    ``swim_rotate`` moves by its width every ``swim_epoch_rounds``
    (0: :func:`~gossip_tpu_torch.models.swim.suggested_epoch_rounds`);
    ``swim_diss`` the dissemination's lowering (``scatter``, ``sort`` or
    ``pack``, equal results) and ``swim_rng`` its draws (``split``: one
    threefry chain per quantity; ``packed``: one multi-word draw per
    node, another stream).  Rumor mongering
    (:mod:`gossip_tpu_torch.models.rumor`): a hot rumor stops spreading
    after ``rumor_k`` pushes to nodes that knew it (``feedback``) or
    after ``rumor_k`` pushes (``blind``)."""

    mode: str = PUSH
    fanout: int = 1
    rumors: int = 1
    exclude_self: bool = True
    period: int = 1
    swim_proxies: int = 3
    swim_suspect_rounds: int = 4
    swim_subjects: int = 8
    swim_rotate: bool = False
    swim_epoch_rounds: int = 0
    swim_diss: str = "sort"
    swim_rng: str = "split"
    rumor_k: int = 2
    rumor_variant: str = "feedback"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown protocol mode {self.mode!r}")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if self.rumors < 1:
            raise ValueError("rumors must be >= 1")
        if self.swim_subjects < 1:
            raise ValueError("swim_subjects must be >= 1")
        if self.swim_epoch_rounds < 0:
            raise ValueError("swim_epoch_rounds must be >= 0 (0 = auto)")
        if self.swim_diss not in ("scatter", "sort", "pack"):
            raise ValueError(f"unknown swim_diss {self.swim_diss!r}; "
                             "choose 'scatter', 'sort', or 'pack'")
        if self.swim_rng not in ("split", "packed"):
            raise ValueError(f"unknown swim_rng {self.swim_rng!r}; "
                             "choose 'split' or 'packed'")
        if self.rumor_k < 1:
            raise ValueError("rumor_k must be >= 1")
        if self.rumor_variant not in RUMOR_VARIANTS:
            raise ValueError(f"unknown rumor_variant "
                             f"{self.rumor_variant!r}; choose from "
                             f"{RUMOR_VARIANTS}")


# Ceiling on a schedule's horizon (the length of the nemesis tables):
# an absurd partition or ramp end is refused instead of building a huge
# table.  Event rounds share the cap, which keeps them below the
# tables' NEVER sentinel.
MAX_CHURN_HORIZON = 100_000


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """A fault program over rounds, lowered by
    :mod:`gossip_tpu_torch.ops.nemesis` into round-indexed tables:

    * ``events``: ``(node, die_round, recover_round)``; the node is down
      for rounds ``die_round <= r < recover_round`` (it neither sends,
      answers nor receives); ``recover_round < 0`` never comes back.  A
      scripted death of the rumor origin is honored (unlike the random
      death mask, which pins the origin alive).
    * ``partitions``: ``(start, end, cut)``; for rounds ``start <= r <
      end`` every message between a node ``< cut`` and a node ``>= cut``
      is lost.  Windows must not overlap.
    * ``ramp``: ``(start, end, from_p, to_p)``; the drop probability is
      ``FaultConfig.drop_prob`` before ``start``, moves linearly from
      ``from_p`` to ``to_p`` over ``[start, end)`` and holds ``to_p``
      after.

    Lists are coerced to tuples (a JSON object delivers lists).  The
    checks and messages are the JAX package's."""

    events: Tuple[Tuple[int, int, int], ...] = ()
    partitions: Tuple[Tuple[int, int, int], ...] = ()
    ramp: Optional[Tuple[int, int, float, float]] = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            tuple(int(x) for x in e) for e in self.events))
        object.__setattr__(self, "partitions", tuple(
            tuple(int(x) for x in w) for w in self.partitions))
        if self.ramp is not None:
            r = tuple(self.ramp)
            if len(r) != 4:
                raise ValueError(f"drop ramp {r} must be "
                                 "(start, end, from_p, to_p)")
            object.__setattr__(
                self, "ramp",
                (int(r[0]), int(r[1]), float(r[2]), float(r[3])))
        for e in self.events:
            if len(e) != 3:
                raise ValueError(f"churn event {e} must be "
                                 "(node, die_round, recover_round)")
            node, die, rec = e
            if node < 0:
                raise ValueError(f"churn event node {node} must be >= 0")
            if die < 0:
                raise ValueError(f"churn event die_round {die} must be "
                                 ">= 0")
            if 0 <= rec <= die:
                raise ValueError(
                    f"churn event {e}: recover_round must be > die_round "
                    "(or < 0 for a permanent crash)")
            if die > MAX_CHURN_HORIZON or rec > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"churn event {e}: rounds exceed the schedule "
                    f"horizon cap {MAX_CHURN_HORIZON} (rec < 0 already "
                    "means 'down forever')")
        nodes = [e[0] for e in self.events]
        if len(set(nodes)) != len(nodes):
            raise ValueError("churn events must script each node at most "
                             "once (one die/recover pair per node)")
        spans = []
        for w in self.partitions:
            if len(w) != 3:
                raise ValueError(f"partition window {w} must be "
                                 "(start, end, cut)")
            start, end, cut = w
            if start < 0 or end <= start:
                raise ValueError(f"partition window {w}: need "
                                 "0 <= start < end")
            if cut <= 0:
                raise ValueError(f"partition window {w}: cut must be a "
                                 "positive node id (both sides non-empty)")
            if end > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"partition window {w}: end {end} exceeds the "
                    f"schedule horizon cap {MAX_CHURN_HORIZON}")
            spans.append((start, end))
        spans.sort()
        for (s0, e0), (s1, _) in zip(spans, spans[1:]):
            if s1 < e0:
                raise ValueError("partition windows overlap: "
                                 f"[{s0}, {e0}) and [{s1}, ...)")
        if self.ramp is not None:
            start, end, p0, p1 = self.ramp
            if start < 0 or end <= start:
                raise ValueError(f"drop ramp {self.ramp}: need "
                                 "0 <= start < end")
            if end > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"drop ramp {self.ramp}: end {end} exceeds the "
                    f"schedule horizon cap {MAX_CHURN_HORIZON}")
            for p in (p0, p1):
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"drop ramp probability {p} outside [0, 1]")

    @property
    def empty(self) -> bool:
        return not (self.events or self.partitions or self.ramp)

    def horizon(self) -> int:
        """Rounds after which the tables are constant: every window
        closed and the ramp at its final value."""
        ends = [1]
        ends += [end for _, end, _ in self.partitions]
        if self.ramp is not None:
            ends.append(self.ramp[1])
        return max(ends) + 1


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """In-round fault injection: a static dead set drawn at
    ``node_death_rate`` from ``seed`` (``models/state.alive_mask``), a
    per-message drop probability, SWIM's scripted failures (the nodes
    ``dead_nodes`` fail for good at ``fail_round``), and ``churn``, a
    fault program over rounds (:class:`ChurnConfig`; a dict is coerced,
    and an empty program is ``None``, which keeps every engine on its
    static path)."""

    node_death_rate: float = 0.0
    drop_prob: float = 0.0
    seed: int = 0
    dead_nodes: Tuple[int, ...] = ()
    fail_round: int = 0
    churn: Optional[ChurnConfig] = None

    def __post_init__(self):
        if not isinstance(self.dead_nodes, tuple):
            object.__setattr__(self, "dead_nodes", tuple(self.dead_nodes))
        if any(d < 0 for d in self.dead_nodes):
            raise ValueError("dead_nodes must be non-negative node ids")
        if self.fail_round < 0:
            raise ValueError("fail_round must be >= 0")
        if not 0.0 <= self.node_death_rate <= 1.0:
            raise ValueError(
                f"node_death_rate={self.node_death_rate} outside [0, 1]")
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob={self.drop_prob} outside [0, 1]")
        if isinstance(self.churn, dict):
            object.__setattr__(self, "churn", ChurnConfig(**self.churn))
        if self.churn is not None and not isinstance(self.churn,
                                                     ChurnConfig):
            raise ValueError(f"churn must be a ChurnConfig, a dict or "
                             f"None, got {type(self.churn).__name__}")
        if self.churn is not None and self.churn.empty:
            object.__setattr__(self, "churn", None)


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
