"""Per-round protocol metrics on the device: the epidemic observables of
Demers et al. (PODC 1987) recorded inside the port's round loops.

The port of the JAX package's ``ops/round_metrics.py``.  A driver that
runs under an active run ledger (:func:`wanted`) builds a
:class:`RoundMetrics` stack of small device buffers (``float32[T]`` a
counter, ``float32[T, S]`` for the per-shard ``front``), and its round
loop calls :func:`record` once a round at the round index the loop
already holds on the host.  :func:`record` writes device tensors (or host
numbers the driver already has) into the buffers: no ``.item()``, no
``int(tensor)``, no boolean mask, no random draw, so the trajectory is
bitwise what it was without metrics and the loop gains no host read.
A loop that already keeps every round's counters fills its stack after
the loop instead (:func:`record_rounds`).

The stack is flushed once a driver call: the driver hands it to the
chokepoint (:func:`deliver`), which is
:func:`~gossip_tpu_torch.utils.timing.steady_timed`: after its stop event
it reads every stack to the host in one copy and writes one
``round_metrics`` ledger event each (:func:`emit`), the reference's
fields, rounding and ``totals``, truncated to the rounds run.  No driver
returns its stack (the reference's ``find`` has no counterpart); a stack
delivered outside any chokepoint is flushed at once.

Counter semantics (the reference's; see its module for the long form):
``newly`` the (node, rumor) entries newly held this round; ``msgs`` the
round's messages; ``dup`` ``max(offered - newly, 0)`` with ``offered =
rumors * payload_factor(mode) * msgs`` (the rumor driver's feedback
variant records its exact count); ``bytes`` the analytic per-device
egress of the round's collectives; ``front`` the per-shard coverage
after the round; and, per stack kind, the nemesis observables
``alive``, ``cut_pairs``, ``dropped`` and the payloads' ``value_conv``,
``log_conv``, ``txn_conv``, ``byz_conv``.

Two deliberate differences from the reference, both invisible below
2^24 entries:

* ``newly`` is the exact integer difference of the entry counts (int64
  on the device), where the reference subtracts two float32 totals;
  so ``sum(newly)`` is exactly the final count less the start count at
  any size (at the README's 10M x 256 the totals pass 2^24 many times
  over).  ``dup`` subtracts it in float32, as the reference does.
* **Sharded drivers.**  Each rank records its own partial count
  (``newly``) and its own ``front`` column; the partials are summed and
  the columns gathered once, at the flush, never once a round.  The
  flush is a collective of every rank of the stack's group, so every
  rank builds the stack when the ledger is on (rank 0 writes the event;
  the other ranks hold a :class:`~gossip_tpu_torch.utils.telemetry.
  NullLedger` marked as a peer, :func:`wanted`).

``GOSSIP_ROUND_METRICS=0`` (or empty, or ``off``) is the kill switch,
and without an active run ledger no stack is built (:func:`wanted`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C

ENV_VAR = "GOSSIP_ROUND_METRICS"

# the float32 channels, one row each of a stack's buffer
F32 = ("offered", "msgs", "bytes", "alive", "cut_pairs", "dropped")
_ROW = {name: i for i, name in enumerate(F32)}
# the integer channels, this rank's partial counts, summed over the ranks
# at the flush: the entries held (``newly``), a rumor driver's hits, and
# a payload's converged nodes and honest converged nodes
INTS = ("newly", "contacts", "conv", "byz")
_IROW = {name: i for i, name in enumerate(INTS)}
# the conv column's event name by stack kind
CONV_KEYS = (("crdt", "value_conv"), ("log", "log_conv"), ("txn", "txn_conv"))


def enabled() -> bool:
    """The environment switch: on unless ``GOSSIP_ROUND_METRICS`` is
    empty, ``0`` or ``off``."""
    return os.environ.get(ENV_VAR, "1").lower() not in ("", "0", "off")


def wanted() -> bool:
    """Whether a driver builds its loop with a metrics stack: the switch
    is on and a run ledger records (or this rank is a peer of the rank
    that records, whose flush needs every rank's stack)."""
    if not enabled():
        return False
    from gossip_tpu_torch.utils import telemetry
    led = telemetry.current()
    return bool(getattr(led, "active", False)
                or getattr(led, "peer", False))


class RoundMetrics:
    """One driver call's buffer stack: the rounds recorded so far
    (``cursor``, a host int), the float32 channels ``f32[len(F32), T]``,
    this rank's integer partials ``int64[len(INTS), T]`` and its
    ``front`` columns ``float32[T, S_local]``.  ``group`` (a
    :class:`~gossip_tpu_torch.parallel.group.Group` of more than one
    rank) sums the partials and gathers the columns at the flush;
    ``shards`` is the event's shard count.  A payload stack's converged
    fractions are the summed counts over ``conv_total`` (and
    ``byz_total``), a true float32 quotient, or with ``folded`` the
    product with the total's float32 reciprocal (XLA's fold of a
    division by a compile-time scalar)."""

    def __init__(self, max_rounds: int, n_shards: int, label: str, device,
                 nemesis: bool = False, crdt: bool = False, log: bool = False,
                 txn: bool = False, byz: bool = False, group=None,
                 local_shards: Optional[int] = None, conv_total: int = 0,
                 byz_total: int = 0, folded: bool = False):
        if max_rounds < 1:
            raise ValueError(f"max_rounds={max_rounds} must be >= 1")
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        dev = torch.device(device)
        self.label = label
        self.shards = n_shards
        self.group = group if group is not None and group.size > 1 else None
        cols = n_shards if local_shards is None else local_shards
        self.cursor = 0
        self.f32 = torch.zeros(len(F32), max_rounds, dtype=torch.float32,
                               device=dev)
        self.ints = torch.zeros(len(INTS), max_rounds, dtype=torch.int64,
                                device=dev)
        self.front = torch.zeros(max_rounds, cols, dtype=torch.float32,
                                 device=dev)
        self.nemesis, self.crdt, self.log = nemesis, crdt, log
        self.txn, self.byz = txn, byz
        self.conv_total, self.byz_total = conv_total, byz_total
        self.folded = folded
        self.dup_from = "offered"       # or "contacts" / "contacts_exact"

    @property
    def max_rounds(self) -> int:
        return self.ints.shape[1]


def init(max_rounds: int, n_shards: int, label: str, device="cpu",
         **kw) -> RoundMetrics:
    """A zeroed stack for up to ``max_rounds`` rounds over ``n_shards``
    shards (the reference's ``init``; ``kw``: the stack kinds
    ``nemesis``, ``crdt``, ``log``, ``txn``, ``byz``, and ``group`` /
    ``local_shards`` / the totals for a sharded or payload driver)."""
    return RoundMetrics(max_rounds, n_shards, label, device, **kw)


def _put(row: torch.Tensor, i: int, value, dtype) -> None:
    """``row[i] = value`` on the device: a copy from a device tensor or a
    fill from a host number, never a read."""
    if isinstance(value, torch.Tensor):
        row[i].copy_(value.reshape(()).to(dtype), non_blocking=True)
    else:
        row[i].fill_(value)


def record(m: RoundMetrics, *, newly, msgs, bytes, front, offered=None,
           contacts=None, contacts_exact: bool = False, conv=None, byz=None,
           alive=None, cut_pairs=None, dropped=None) -> RoundMetrics:
    """Write one round's row at the cursor (clamped to the last row, as
    the reference's) and advance it.  ``newly`` is this rank's exact
    count difference (an int64 tensor or an int), ``front`` its shards'
    fractions.  ``dup`` is made at the flush: ``max(offered - newly,
    0)``, or from a rumor driver's ``contacts`` (this rank's hit-counter
    difference): those themselves when ``contacts_exact`` (the feedback
    variant), else ``max(contacts - newly, 0)``.  ``conv`` / ``byz`` are
    this rank's converged-node counts of a payload stack.  The optional
    channels are written only when passed.  Returns ``m``."""
    i = min(m.cursor, m.max_rounds - 1)
    if contacts is not None:
        m.dup_from = "contacts_exact" if contacts_exact else "contacts"
    for name, value in (("newly", newly), ("contacts", contacts),
                        ("conv", conv), ("byz", byz)):
        if value is not None:
            _put(m.ints[_IROW[name]], i, value, torch.int64)
    if isinstance(front, torch.Tensor):
        m.front[i].copy_(front.reshape(-1).to(torch.float32),
                         non_blocking=True)
    else:
        m.front[i].fill_(float(front))
    for name, value in (("offered", offered), ("msgs", msgs),
                        ("bytes", bytes), ("alive", alive),
                        ("cut_pairs", cut_pairs), ("dropped", dropped)):
        if value is not None:
            _put(m.f32[_ROW[name]], i, value, torch.float32)
    m.cursor += 1
    return m


def record_rounds(m: RoundMetrics, rounds: int, *, newly, front, msgs,
                  bytes, offered) -> RoundMetrics:
    """:func:`record` of ``rounds`` rounds at once, from the cursor: a
    driver whose loop already keeps every round's counters fills its
    stack after the loop.  ``newly`` is int64[rounds], ``front``
    float32[rounds, S_local]; the other channels are the same every
    round (host numbers).  Returns ``m``."""
    rows = slice(m.cursor, m.cursor + rounds)
    m.ints[_IROW["newly"], rows].copy_(newly)
    m.front[rows].copy_(front)
    for name, value in (("offered", offered), ("msgs", msgs),
                        ("bytes", bytes)):
        m.f32[_ROW[name], rows].fill_(value)
    m.cursor += rounds
    return m


# -- per-round helpers (device arithmetic only) ---------------------------

def payload_factor(mode: str) -> float:
    """The fraction of a mode's counted messages that carry a digest
    toward the receiver (the reference's table): push, flood and rumor
    1, pull 1/2 (request and response, one carries), push-pull and
    anti-entropy 2/3."""
    return {C.PUSH: 1.0, C.FLOOD: 1.0, C.RUMOR: 1.0, C.PULL: 0.5,
            C.PUSH_PULL: 2.0 / 3.0, C.ANTI_ENTROPY: 2.0 / 3.0}[mode]


def gate_on_exchange_rounds(value, period: int, round_: int, off=0.0):
    """``value`` on exchange rounds, ``off`` on quiescent anti-entropy
    rounds: the one ``round % period == 0`` predicate (the round is the
    loop's host int)."""
    if period <= 1 or round_ % period == 0:
        return value
    return off


def dup_estimate(offered, newly):
    """``max(offered - newly, 0)`` in float32 (numpy or torch)."""
    if isinstance(offered, torch.Tensor) or isinstance(newly, torch.Tensor):
        d = (torch.as_tensor(offered, dtype=torch.float32)
             - torch.as_tensor(newly).to(torch.float32))
        return torch.clamp(d, min=0.0)
    return np.maximum(np.float32(offered) - np.float32(newly),
                      np.float32(0.0))


def count_bool(seen: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """int64: the set (node, rumor) entries over alive rows of
    ``bool[N, R]``."""
    return (seen & alive[:, None]).sum()


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """int64 popcount of each 32-bit word (int32 bits)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & 0xFFFFFFFF) >> 24


def count_packed(words: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """int64: the set bits over alive rows of a rumor-packed ``[N, W]``
    table (padding bits past ``rumors`` are never set)."""
    pc = _popcount32(words)
    return torch.where(alive[:, None], pc, 0).sum()


def count_planes(planes: torch.Tensor) -> torch.Tensor:
    """int64: the set bits of a plane stack (the all-ones padding columns
    add a constant, which cancels in the rounds' differences)."""
    return _popcount32(planes).sum()


def _shard_fraction(per: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """``per / max(tot, 1)`` in float32: a true quotient, as XLA computes
    the reference's (its denominator is a vector, which it does not fold
    into a reciprocal product even when it is a constant)."""
    return per.to(torch.float32) / torch.clamp(tot.to(torch.float32),
                                               min=1.0)


def front_bool(seen: torch.Tensor, alive: torch.Tensor,
               n_shards: int = 1) -> torch.Tensor:
    """float32[S]: each shard's covered fraction of a row-sharded bool
    table (covered: alive and holding any rumor; the denominator the
    shard's alive rows)."""
    covered = seen.any(dim=1) & alive
    return _shard_fraction(covered.reshape(n_shards, -1).sum(dim=1),
                           alive.reshape(n_shards, -1).sum(dim=1))


def front_packed(words: torch.Tensor, alive: torch.Tensor,
                 n_shards: int = 1) -> torch.Tensor:
    """:func:`front_bool` of the rumor-packed layout."""
    covered = (words != 0).any(dim=1) & alive
    return _shard_fraction(covered.reshape(n_shards, -1).sum(dim=1),
                           alive.reshape(n_shards, -1).sum(dim=1))


def front_counts(least: torch.Tensor, n: int) -> torch.Tensor:
    """float32: a plane shard's front from its least per-rumor count,
    ``float32(least) * float32(1 / n)`` (the reference's
    ``coverage_words``, whose division by the static ``n`` XLA folds)."""
    return least.to(torch.float32) * float(np.float32(1) / np.float32(n))


def front_planes(planes: torch.Tensor, n: int, n_shards: int = 1
                 ) -> torch.Tensor:
    """float32[S]: each shard's least coverage over the planes it owns of
    a stack ``[W, rows, 128]`` (int32 bits), from the bits' counts."""
    bits = torch.arange(32, device=planes.device)
    w = planes.reshape(planes.shape[0], -1).to(torch.int64) & 0xFFFFFFFF
    per = ((w[:, :, None] >> bits) & 1).sum(dim=1)          # [W, 32]
    least = per.reshape(n_shards, -1).min(dim=1).values
    return front_counts(least, n)


# -- the flush --------------------------------------------------------------

_LOCAL = threading.local()


@contextlib.contextmanager
def collecting():
    """Collect the stacks that drivers :func:`deliver` inside the block
    (the chokepoint's window); yields the list."""
    outer = getattr(_LOCAL, "sink", None)
    _LOCAL.sink = sink = []
    try:
        yield sink
    finally:
        _LOCAL.sink = outer


def deliver(m: Optional[RoundMetrics], fn: Optional[str] = None) -> None:
    """A driver hands its stack to the chokepoint that called it; without
    one it is flushed at once to the ambient ledger."""
    if m is None:
        return
    sink = getattr(_LOCAL, "sink", None)
    if sink is not None:
        sink.append((m, fn))
        return
    from gossip_tpu_torch.utils import telemetry
    emit([m], telemetry.current(), fn=fn)


def _host(m: RoundMetrics):
    """The stack's host copy, every rank's shares combined: ``(f32 rows,
    int64 rows, front [T, shards])``; a collective under a group (one
    sum and one gather)."""
    ints, front = m.ints, m.front
    if m.group is not None:
        ints = m.group.all_reduce_sum(ints)
        front = m.group.all_gather(front.t().contiguous()).t()   # [T, S]
    return m.f32.cpu().numpy(), ints.cpu().numpy(), front.cpu().numpy()


def _fraction(counts: np.ndarray, total: int, folded: bool) -> np.ndarray:
    """float32 ``counts / max(total, 1)`` (or its folded product)."""
    c = counts.astype(np.float32)
    t = np.float32(max(total, 1))
    return c * (np.float32(1) / t) if folded else c / t


def emit(out, ledger, fn=None) -> None:
    """One host copy and one ``round_metrics`` event (``sync=False``) for
    each stack in ``out`` (a list of stacks or ``(stack, fn)`` pairs),
    truncated to the rounds recorded.  Every rank of a
    sharded stack calls it (its flush is a collective); only an active
    ledger writes."""
    for item in out:
        m, name = item if isinstance(item, tuple) else (item, fn)
        rows, ints, front = _host(m)
        if not getattr(ledger, "active", False):
            continue
        r = min(m.cursor, m.max_rounds)
        ch = {k: rows[_ROW[k]] for k in F32}
        newly, contacts = ints[_IROW["newly"]], ints[_IROW["contacts"]]
        if m.dup_from == "offered":
            dup = np.maximum(ch["offered"] - newly.astype(np.float32),
                             np.float32(0.0))
        elif m.dup_from == "contacts_exact":
            dup = contacts.astype(np.float32)
        else:
            dup = np.maximum(contacts.astype(np.float32)
                             - newly.astype(np.float32), np.float32(0.0))
        fracs = {}
        for kind, key in CONV_KEYS:
            if getattr(m, kind):
                fracs[key] = _fraction(ints[_IROW["conv"]], m.conv_total,
                                       m.folded)
        if m.byz:
            fracs["byz_conv"] = _fraction(ints[_IROW["byz"]], m.byz_total,
                                          m.folded)

        def ser(a, nd=3):
            return [round(float(v), nd) for v in np.asarray(a)[:r]]

        extra = {}
        if m.nemesis:
            extra = {"alive": ser(ch["alive"]),
                     "cut_pairs": ser(ch["cut_pairs"]),
                     "dropped": ser(ch["dropped"])}
        extra.update({k: ser(v, nd=4) for k, v in fracs.items()})
        totals = {"newly": round(float(np.sum(newly[:r])), 3),
                  "dup": round(float(np.sum(dup[:r])), 3),
                  "msgs": round(float(np.sum(ch["msgs"][:r])), 3),
                  "bytes": round(float(np.sum(ch["bytes"][:r])), 3)}
        if m.nemesis:
            totals["dropped"] = round(float(np.sum(ch["dropped"][:r])), 3)
        for key, v in fracs.items():
            totals[f"{key}_final"] = round(float(v[r - 1]), 4) if r else 0.0
        ledger.event(
            "round_metrics", sync=False, driver=m.label, fn=name,
            rounds=r, shards=int(front.shape[1]),
            newly=ser(newly.astype(np.float64)), dup=ser(dup),
            msgs=ser(ch["msgs"]), bytes=ser(ch["bytes"]), **extra,
            front=[[round(float(v), 4) for v in row] for row in front[:r]],
            totals=totals,
            front_final=([round(float(v), 4) for v in front[r - 1]]
                         if r else None))
