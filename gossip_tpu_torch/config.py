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


# Byzantine liar actions (ops/nemesis byz lowering).  Every kind is a
# SERVE-side transform of the state row a liar hands to pulling peers:
BYZ_CORRUPT = "corrupt"        # flip payload words it forwards (xor arg)
BYZ_REPLAY = "replay"          # serve a stale snapshot of its own planes
BYZ_EQUIVOCATE = "equivocate"  # different state per partner (keyed by id)
BYZ_INFLATE = "inflate"        # write columns/keys it does not own

BYZ_KINDS = (BYZ_CORRUPT, BYZ_REPLAY, BYZ_EQUIVOCATE, BYZ_INFLATE)


@dataclasses.dataclass(frozen=True)
class ByzConfig:
    """A scripted *byzantine program*: nodes that lie, the adversarial
    half of the nemesis (:mod:`gossip_tpu_torch.ops.nemesis`).

    Where :class:`ChurnConfig` scripts fail-stop faults (a down node is
    silent), this scripts liars: ``liars`` are ``(node, round, kind,
    arg)`` quadruples; from ``round`` on, ``node`` serves every pull
    with a transformed state row (:data:`BYZ_KINDS`).  The program
    lowers to per-node tables on the device
    (:func:`~gossip_tpu_torch.ops.nemesis.build_byz`), and the
    transforms are rendered on the receiver's side, so a liar's own
    state stays honest: the lie is on the wire (a faulty replica can
    say anything but cannot rewrite what it already gossiped).

    A liar corrupts only components it does NOT own: its own
    column, element or key writes are its own to make and cannot be
    told from honest writes, so honest convergence is judged on
    honest-owned components only.

    ``quorum`` is the echo threshold q of the defended packed-set
    admission: a bit not served by its owner directly is admitted only
    when seen from >= q distinct partners in one round (so f < q
    non-colluding forgers are tolerated).

    One action per node (the ChurnConfig one-event rule); an empty
    program is normalized to ``None`` by :class:`FaultConfig`.  The
    checks and messages are the JAX package's.
    """

    liars: Tuple[Tuple[int, int, str, int], ...] = ()
    quorum: int = 2

    def __post_init__(self):
        object.__setattr__(self, "liars", tuple(
            (int(a[0]), int(a[1]), str(a[2]), int(a[3]) if len(a) > 3
             else 0)
            for a in (tuple(x) for x in self.liars)))
        for a in self.liars:
            if len(a) != 4:
                raise ValueError(f"byz liar {a} must be "
                                 "(node, round, kind[, arg])")
            node, rnd, kind, arg = a
            if node < 0:
                raise ValueError(f"byz liar node {node} must be >= 0")
            if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"byz liar round {rnd} outside "
                    f"[0, {MAX_CHURN_HORIZON}] (the schedule horizon "
                    "cap, shared with ChurnConfig)")
            if kind not in BYZ_KINDS:
                raise ValueError(f"unknown byz kind {kind!r}; choose "
                                 f"from {BYZ_KINDS}")
            if arg < 0:
                raise ValueError(f"byz liar {a}: arg must be >= 0 (an "
                                 "xor/inflation pattern, not a sign)")
        nodes = [a[0] for a in self.liars]
        if len(set(nodes)) != len(nodes):
            raise ValueError("byz program must script each node at "
                             "most once (one standing lie per node — "
                             "the ChurnConfig one-event rule)")
        if not 1 <= self.quorum <= 3:
            raise ValueError(
                f"quorum={self.quorum} outside [1, 3]: the defended "
                "set kernels count echoes with a carry-save chain of "
                "depth 3 (ops/crdt.pull_merge_crdt_byz); a larger "
                "quorum needs a deeper chain, added when an engine "
                "needs it")

    @property
    def empty(self) -> bool:
        return not self.liars


# CRDT payload kinds (ops/crdt.py).  The Gossip Glomers sibling
# workloads of the reference's broadcast: same epidemic exchange, a
# commutative-merge payload instead of the infected bit.
GCOUNTER = "gcounter"      # grow-only counter: per-node shards, merge=max
PNCOUNTER = "pncounter"    # inc/dec counter: P and N shard planes
GSET = "gset"              # grow-only set: packed add bit-planes, merge=OR
ORSET = "orset"            # add/remove set: add + tombstone planes, merge=OR
VCLOCK = "vclock"          # per-node vector clocks, merge=elementwise max

CRDT_KINDS = (GCOUNTER, PNCOUNTER, GSET, ORSET, VCLOCK)
CRDT_COUNTER_KINDS = (GCOUNTER, PNCOUNTER)
CRDT_SET_KINDS = (GSET, ORSET)


@dataclasses.dataclass(frozen=True)
class CrdtConfig:
    """A commutative-merge payload workload (ops/crdt.py, models/crdt.py).

    The injections are a *program over rounds*, exactly like the nemesis
    schedule: counter ``adds`` are ``(node, round, amount)`` triples
    (node adds ``amount`` to its own shard at ``round``; for
    ``pncounter`` a negative amount lands in the N plane, for
    ``gcounter`` amounts must be positive), set ``set_adds`` /
    ``set_removes`` are ``(element, round)`` pairs injected at the
    element's owner node ``(origin + element) % n`` (the rumor-origin
    convention).  Empty ``adds`` on a counter kind means the default
    program: node ``j`` adds ``1 + j % 7`` at round 0 (closed form, so
    no O(N) config is ever materialized); empty ``set_adds`` means
    every element is added at round 0 at its owner.

    Ground truth is the merge of all *applied* injections — an
    injection is applied iff its owner is alive at the injection round
    AND eventually alive under the fault program (ops/crdt.ground
    truth doc: the batched analog of the Maelstrom counter checker
    counting only ACKED adds — a node destined for permanent death
    contributes nothing, which is what makes exact value convergence
    on the eventual-alive set a guaranteed invariant).
    """

    kind: str = GCOUNTER
    adds: Tuple[Tuple[int, int, int], ...] = ()
    set_adds: Tuple[Tuple[int, int], ...] = ()
    set_removes: Tuple[Tuple[int, int], ...] = ()
    elements: int = 64          # set element universe E (W = ceil(E/32))

    def __post_init__(self):
        object.__setattr__(self, "adds", tuple(
            tuple(int(x) for x in a) for a in self.adds))
        object.__setattr__(self, "set_adds", tuple(
            tuple(int(x) for x in a) for a in self.set_adds))
        object.__setattr__(self, "set_removes", tuple(
            tuple(int(x) for x in a) for a in self.set_removes))
        if self.kind not in CRDT_KINDS:
            raise ValueError(f"unknown CRDT kind {self.kind!r}; choose "
                             f"from {CRDT_KINDS}")
        if self.elements < 1:
            raise ValueError("elements must be >= 1")
        if self.kind in CRDT_SET_KINDS:
            if self.adds:
                raise ValueError(f"{self.kind} takes set_adds/"
                                 "set_removes, not counter adds")
        else:
            if self.set_adds or self.set_removes:
                raise ValueError(f"{self.kind} takes counter adds, not "
                                 "set_adds/set_removes")
        if self.kind == VCLOCK and self.adds:
            # vclock carries no injection program at all (owner ticks
            # only) — silently dropping a scripted one would violate
            # the reject-loudly policy every other kind mismatch obeys
            raise ValueError("vclock takes no injection program (the "
                             "owner tick is the only local event); "
                             "drop the adds")
        if self.kind == GSET and self.set_removes:
            raise ValueError("gset is grow-only; removes need kind="
                             "'orset'")
        for a in self.adds:
            if len(a) != 3:
                raise ValueError(f"counter add {a} must be "
                                 "(node, round, amount)")
            node, rnd, amt = a
            if node < 0:
                raise ValueError(f"add node {node} must be >= 0")
            if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"add round {rnd} outside [0, {MAX_CHURN_HORIZON}] "
                    "(the schedule horizon cap, shared with ChurnConfig)")
            if self.kind == GCOUNTER and amt <= 0:
                raise ValueError(
                    f"gcounter add {a}: amounts must be positive "
                    "(grow-only; use pncounter for decrements)")
            if self.kind == PNCOUNTER and amt == 0:
                raise ValueError(f"pncounter add {a}: amount must be "
                                 "nonzero")
        for name, pairs in (("set_add", self.set_adds),
                            ("set_remove", self.set_removes)):
            for p in pairs:
                if len(p) != 2:
                    raise ValueError(f"{name} {p} must be "
                                     "(element, round)")
                elem, rnd = p
                if not 0 <= elem < self.elements:
                    raise ValueError(
                        f"{name} element {elem} outside the universe "
                        f"[0, {self.elements})")
                if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                    raise ValueError(
                        f"{name} round {rnd} outside "
                        f"[0, {MAX_CHURN_HORIZON}]")
        seen_elems = [e for e, _ in self.set_adds]
        if len(set(seen_elems)) != len(seen_elems):
            raise ValueError("set_adds must script each element at most "
                             "once (the packed-plane OR-set models one "
                             "unique add tag per element — "
                             "docs/WORKLOADS.md)")
        seen_rems = [e for e, _ in self.set_removes]
        if len(set(seen_rems)) != len(seen_rems):
            raise ValueError("set_removes must script each element at "
                             "most once")
        # A remove at-or-before its element's add would make the
        # packed tombstone plane remove-wins where the documented
        # contract is add-wins == 2P (the remove must happen-after the
        # observed add tag) — reject the silent semantic fork.  An
        # unscripted add means the default program's round 0; a remove
        # of a never-added element is a harmless no-op and allowed.
        add_round = {e: r for e, r in self.set_adds}
        for e, rr in self.set_removes:
            ra = add_round.get(e, 0 if not self.set_adds else None)
            if ra is not None and rr <= ra:
                raise ValueError(
                    f"set_remove ({e}, {rr}) fires at or before the "
                    f"element's add (round {ra}): a remove must "
                    "happen-after the add it tombstones, or add-wins "
                    "and 2P semantics diverge (docs/WORKLOADS.md)")

    def horizon(self) -> int:
        """Rounds after which no further injection fires (the zero-row
        steady state of the lowered injection tables)."""
        rounds = [0]
        rounds += [r for _, r, _ in self.adds]
        rounds += [r for _, r in self.set_adds]
        rounds += [r for _, r in self.set_removes]
        return max(rounds) + 1


@dataclasses.dataclass(frozen=True)
class LogConfig:
    """A replicated kafka-style log workload (ops/logs.py,
    models/log.py) — the last Gossip Glomers sibling of the
    reference's broadcast: ordered per-key offset payloads with
    committed offsets, gossiped as fixed-capacity ring buffers whose
    merge is elementwise max over owner-indexed slot planes.

    ``sends`` are ``(node, key, round, value)`` — node appends
    ``value`` to key's log at ``round``; ``commits`` are ``(node, key,
    round, upto)`` — node commits key's offsets below
    ``min(upto, acked_len(key))`` at ``round``.  Both are *programs
    over rounds* lowered to runtime operands (the nemesis/CRDT
    pattern); empty means the closed-form default programs
    (ops/logs.log_sends / log_commits — no O(K) config object).

    Contracts the validation enforces loudly:

    * values >= 1 (0 is the empty-slot sentinel — a 0 value would be
      invisible to the merge);
    * at most ``capacity`` sends per key (the ring position is
      ``offset % capacity``; more sends would wrap onto an unconsumed
      slot and silently alias two offsets);
    * per-key script order is round-nondecreasing (offsets are
      assigned in script order — ops/logs.send_offsets — so this is
      what makes offset order equal time order, the ORDERED half of
      the kafka invariants);
    * commit ``upto`` >= 1 (committing nothing is the default state).
    """

    keys: int = 4               # K: number of per-key logs
    capacity: int = 16          # C: ring slots per key
    sends: Tuple[Tuple[int, int, int, int], ...] = ()
    commits: Tuple[Tuple[int, int, int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "sends", tuple(
            tuple(int(x) for x in s) for s in self.sends))
        object.__setattr__(self, "commits", tuple(
            tuple(int(x) for x in c) for c in self.commits))
        if self.keys < 1:
            raise ValueError("keys must be >= 1")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        per_key_rounds: dict = {}
        for s in self.sends:
            if len(s) != 4:
                raise ValueError(f"log send {s} must be "
                                 "(node, key, round, value)")
            node, key, rnd, val = s
            if node < 0:
                raise ValueError(f"send node {node} must be >= 0")
            if not 0 <= key < self.keys:
                raise ValueError(f"send key {key} outside "
                                 f"[0, {self.keys})")
            if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"send round {rnd} outside [0, {MAX_CHURN_HORIZON}]"
                    " (the schedule horizon cap, shared with "
                    "ChurnConfig)")
            if val < 1:
                raise ValueError(
                    f"send {s}: values must be >= 1 (0 is the "
                    "empty-slot sentinel the merge identity rides)")
            rounds = per_key_rounds.setdefault(key, [])
            if rounds and rnd < rounds[-1]:
                raise ValueError(
                    f"send {s}: key {key}'s sends must be scripted in "
                    "round-nondecreasing order — offsets are assigned "
                    "in script order, so out-of-order rounds would "
                    "break offset-order == time-order (the kafka "
                    "ordered-append contract, ops/logs module doc)")
            rounds.append(rnd)
        for key, rounds in per_key_rounds.items():
            if len(rounds) > self.capacity:
                raise ValueError(
                    f"key {key} scripts {len(rounds)} sends but "
                    f"capacity is {self.capacity}: the ring would wrap "
                    "onto an unconsumed slot and alias two offsets — "
                    "raise capacity or split the program")
        # the DEFAULT send program appends 4 entries per key
        # (ops/logs.log_sends) — it must obey the same no-wrap
        # contract, or an unscripted tiny-capacity config would alias
        # slots silently where a scripted one errors loudly
        if not self.sends and self.capacity < 4:
            raise ValueError(
                f"capacity={self.capacity} cannot hold the default "
                "send program (4 sends per key — ops/logs.log_sends): "
                "the ring would wrap and alias offsets; raise "
                "capacity to >= 4 or script the sends")
        for c in self.commits:
            if len(c) != 4:
                raise ValueError(f"log commit {c} must be "
                                 "(node, key, round, upto)")
            node, key, rnd, upto = c
            if node < 0:
                raise ValueError(f"commit node {node} must be >= 0")
            if not 0 <= key < self.keys:
                raise ValueError(f"commit key {key} outside "
                                 f"[0, {self.keys})")
            if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"commit round {rnd} outside "
                    f"[0, {MAX_CHURN_HORIZON}]")
            if upto < 1:
                raise ValueError(f"commit {c}: upto must be >= 1 "
                                 "(nothing-committed is the default "
                                 "state, not a scripted op)")

    def horizon(self) -> int:
        """Rounds after which no further send/commit fires (the
        zero-row steady state of the lowered injection tables).  The
        DEFAULT programs end at rounds 3 (sends) / 4 (commits —
        ops/logs.log_sends / log_commits), so an empty config still
        needs max_rounds > 4."""
        rounds = [3 if not self.sends else 0,
                  4 if not self.commits else 0]
        rounds += [r for _, _, r, _ in self.sends]
        rounds += [r for _, _, r, _ in self.commits]
        return max(rounds) + 1


# Txn traffic load shapes (ops/registers.txn_writes): how the default
# skewed write program spreads over rounds.
TXN_LOADS = ("uniform", "diurnal")


@dataclasses.dataclass(frozen=True)
class TxnConfig:
    """A totally-available transaction workload over last-writer-wins
    registers (ops/registers.py, models/register.py): the Maelstrom
    ``txn-rw-register`` shape batched, K per-key registers gossiped on
    the pull exchange, each a ``(value, timestamp)`` pair whose
    timestamp packs the lexicographic ``(round, owner)`` key into one
    int32, so the merge is an exact lattice join.

    ``writes`` script the write micro-ops as a program over rounds,
    ``(node, key, round, value)`` quadruples lowered to device tensors
    like the CRDT and log injections.  Empty means the skewed default
    program (ops/registers.txn_writes): a closed form, with no RNG, of
    ``txns`` writes whose key popularity is zipfian(``zipf_alpha``)
    over ``keys``, redirected onto key 0 with probability ``hot_key``
    during the middle third of the program (a hot-key storm), spread
    over ``spread_rounds`` rounds by the ``load`` curve (``uniform``, or
    ``diurnal``: density ``1 + sin`` peaking mid-window).

    Contracts validated loudly, in the JAX package's words:

    * values >= 1 (0 is the never-written sentinel of the value plane);
    * at most one write per ``(key, round, node)``: two writes sharing
      one packed timestamp would fork the LWW winner silently (the
      unique-timestamp contract; the default program is collision-free
      by construction and re-checked at lowering);
    * zipf_alpha > 0, 0 <= hot_key <= 1, spread_rounds >= 1.

    Ground truth is LWW over the applied writes: a write applies iff its
    owner is alive at the write round and eventually alive under the
    fault program (the acked-adds rule of the CRDT and log payloads).
    """

    keys: int = 8               # K: register universe
    txns: int = 16              # T: default-program write count
    zipf_alpha: float = 1.1     # key-popularity skew (> 0)
    hot_key: float = 0.0        # storm mass onto key 0, middle third
    load: str = "uniform"       # writes-over-rounds shape (TXN_LOADS)
    spread_rounds: int = 8      # rounds the default program spans
    writes: Tuple[Tuple[int, int, int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "writes", tuple(
            tuple(int(x) for x in w) for w in self.writes))
        if self.keys < 1:
            raise ValueError("keys must be >= 1")
        if self.txns < 1:
            raise ValueError("txns must be >= 1")
        if self.zipf_alpha <= 0:
            raise ValueError(
                f"zipf_alpha={self.zipf_alpha} must be > 0 (1.0 is "
                "classic zipf; larger is more skewed)")
        if not 0.0 <= self.hot_key <= 1.0:
            raise ValueError(
                f"hot_key={self.hot_key} outside [0, 1] (the storm "
                "probability mass redirected onto key 0)")
        if self.load not in TXN_LOADS:
            raise ValueError(f"unknown load {self.load!r}; choose "
                             f"from {TXN_LOADS}")
        if self.spread_rounds < 1:
            raise ValueError("spread_rounds must be >= 1")
        seen = set()
        for w in self.writes:
            if len(w) != 4:
                raise ValueError(f"txn write {w} must be "
                                 "(node, key, round, value)")
            node, key, rnd, val = w
            if node < 0:
                raise ValueError(f"write node {node} must be >= 0")
            if not 0 <= key < self.keys:
                raise ValueError(f"write key {key} outside "
                                 f"[0, {self.keys})")
            if rnd < 0 or rnd > MAX_CHURN_HORIZON:
                raise ValueError(
                    f"write round {rnd} outside [0, {MAX_CHURN_HORIZON}]"
                    " (the schedule horizon cap, shared with "
                    "ChurnConfig)")
            if val < 1:
                raise ValueError(
                    f"write {w}: values must be >= 1 (0 is the "
                    "never-written sentinel of the value plane)")
            trip = (key, rnd, node)
            if trip in seen:
                raise ValueError(
                    f"write {w}: duplicate (key, round, node) — the "
                    "(round, owner) timestamp is what makes LWW "
                    "deterministic, and two writes sharing one "
                    "timestamp would fork the winner silently "
                    "(docs/WORKLOADS.md \"Transactions\")")
            seen.add(trip)

    def horizon(self) -> int:
        """Rounds after which no further write fires; the default
        program spans ``spread_rounds`` rounds."""
        if self.writes:
            return max(r for _, _, r, _ in self.writes) + 1
        return self.spread_rounds


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """In-round fault injection: a static dead set drawn at
    ``node_death_rate`` from ``seed`` (``models/state.alive_mask``), a
    per-message drop probability, SWIM's scripted failures (the nodes
    ``dead_nodes`` fail for good at ``fail_round``), and ``churn``, a
    fault program over rounds (:class:`ChurnConfig`; a dict is coerced,
    and an empty program is ``None``, which keeps every engine on its
    static path), and ``byz``, a program of liars (:class:`ByzConfig`,
    coerced and normalized the same way), which only the CRDT and the
    LWW-register exchanges run."""

    node_death_rate: float = 0.0
    drop_prob: float = 0.0
    seed: int = 0
    dead_nodes: Tuple[int, ...] = ()
    fail_round: int = 0
    churn: Optional[ChurnConfig] = None
    byz: Optional[ByzConfig] = None

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
        if isinstance(self.byz, dict):
            object.__setattr__(self, "byz", ByzConfig(**self.byz))
        if self.byz is not None and self.byz.empty:
            object.__setattr__(self, "byz", None)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run parameters: run until ``target_coverage`` or ``max_rounds``.
    ``engine``: ``fused`` (the CUDA round kernels: pull on the implicit
    complete graph), ``xla`` (the threefry-keyed engine of the JAX
    package's XLA path: every SI mode, every topology, bit-packed for
    pull and anti-entropy), ``auto`` (fused where it is eligible, else
    xla); ``native`` is the go-native backend's C++ event core
    (``backend.run_gonative``), which the jax-tpu engines refuse."""

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
    """The node mesh: ``n_devices`` ranks, each holding a contiguous
    block of the (padded) node rows (:mod:`gossip_tpu_torch.parallel`).
    ``exchange``: the cross-shard pattern: ``dense`` (the all_gather /
    reduce-scatter of whole digest tables), ``sparse`` (all_to_all
    requests and responses) or ``halo`` (``ppermute`` of boundary rows
    on banded tables).  ``shared_card``: run the ranks
    on one card under gloo (a test mode; otherwise each rank takes a card
    of its own and more ranks than cards are refused)."""

    n_devices: int = 1
    exchange: str = "dense"
    shared_card: bool = False

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; "
                             f"choose from {EXCHANGES}")


# The serving layer's refusal of what this package does not run yet: the
# reference's request-axis mesh and its multi-process replicas.
MESH_NOT_PORTED = ("the request-axis megabatch mesh is not ported yet "
                   "(ROADMAP queue 1, item 7d); serve with one device")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Admission-batching knobs of the serving sidecar
    (:mod:`gossip_tpu_torch.rpc.batcher`), the reference's fields,
    defaults and checks:

    * ``tick_ms``: the collector cadence; each tick the queue drains and
      each batch-key group runs as one megabatch;
    * ``max_batch``: per-tick per-key cap on coalesced lanes (ensemble
      members count one each); the rest wait for the next tick;
    * ``max_queue``: the backpressure cap; an admission past it is
      refused with RESOURCE_EXHAUSTED;
    * ``devices``, ``coordinator``, ``num_processes``, ``process_id``:
      the reference's request-axis mesh and its multi-process replica.
      Checked as the reference checks them, then refused above one
      device or one process (:data:`MESH_NOT_PORTED`)."""

    tick_ms: float = 20.0
    max_batch: int = 64
    max_queue: int = 256
    devices: int = 1
    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0

    def __post_init__(self):
        # the reference's words
        if self.tick_ms <= 0:
            raise ValueError("tick_ms must be > 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.devices < 1 or (self.devices & (self.devices - 1)):
            raise ValueError(
                "devices must be a power of two >= 1 (pow2 lane "
                "buckets must divide the mesh so dispatch never "
                f"fragments the executable cache), got {self.devices}")
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError("process_id must be in [0, num_processes)")
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError(
                "a multi-process replica (num_processes > 1) needs a "
                "coordinator address (host:port) for "
                "jax.distributed.initialize")
        if self.devices > 1:
            raise ValueError(f"devices={self.devices}: {MESH_NOT_PORTED}")
        if self.num_processes > 1:
            raise ValueError(f"num_processes={self.num_processes}: a "
                             f"replica spanning processes is part of "
                             f"the same slice; {MESH_NOT_PORTED}")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Replicated-serving knobs of the failover router
    (:mod:`gossip_tpu_torch.rpc.router`), the reference's fields,
    defaults and checks: ``replicas`` (spawned fleets), the probe
    cadence and deadline, ``down_after`` consecutive failed probes
    before a replica leaves rotation, ``up_after`` consecutive healthy
    probes before a downed one returns (the flap hysteresis),
    ``max_inflight`` per replica before the router sheds,
    ``control_capacity`` (each replica's control-plane log ring) and
    ``devices_per_replica`` (refused above 1, :data:`MESH_NOT_PORTED`)."""

    replicas: int = 2
    probe_interval_ms: float = 250.0
    probe_timeout_s: float = 2.0
    down_after: int = 2
    up_after: int = 3
    max_inflight: int = 8
    control_capacity: int = 64
    devices_per_replica: int = 1

    def __post_init__(self):
        # the reference's words
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if (self.devices_per_replica < 1
                or (self.devices_per_replica
                    & (self.devices_per_replica - 1))):
            raise ValueError(
                "devices_per_replica must be a power of two >= 1, "
                f"got {self.devices_per_replica}")
        if self.probe_interval_ms <= 0:
            raise ValueError("probe_interval_ms must be > 0")
        if self.probe_timeout_s <= 0:
            raise ValueError("probe_timeout_s must be > 0")
        if self.down_after < 1:
            raise ValueError("down_after must be >= 1")
        if self.up_after < 1:
            raise ValueError("up_after must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.control_capacity < 4:
            raise ValueError("control_capacity must be >= 4")
        if self.devices_per_replica > 1:
            raise ValueError(f"devices_per_replica="
                             f"{self.devices_per_replica}: "
                             f"{MESH_NOT_PORTED}")
