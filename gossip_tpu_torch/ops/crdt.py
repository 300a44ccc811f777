"""CRDT payloads: commutative-merge state on the gossip fabric.

The port of the JAX package's ``ops/crdt.py`` on one device.  Each node
carries a state row whose merge is commutative, associative and
idempotent, so gossip order, duplication and loss never corrupt the
value (Shapiro et al., "Conflict-free Replicated Data Types", SSS 2011).

Array forms (one row per node):

* **G-Counter / PN-Counter**: per-node shards ``int32[N, S]``; column
  ``j`` belongs to node ``j % n``, which alone increments it, and the
  merge is the elementwise max.  ``gcounter``: S = n; ``pncounter``:
  S = 2n, columns ``0..n-1`` the increment (P) plane, ``n..2n-1`` the
  decrement (N) plane, value = sum(P) - sum(N).
* **G-Set / OR-Set**: packed bit planes ``[N, 2W]`` (32 elements a
  word, :mod:`gossip_tpu_torch.ops.bitpack` order): words ``0..W-1``
  the add plane, ``W..2W-1`` the tombstone plane, merge = bitwise OR,
  membership = add & ~tombstone.  The reference's uint32 words are held
  as int32 with the same bits.
* **Vector clocks**: ``int32[N, n]``; the owner ticks its own entry,
  merge = elementwise max.  They have a merge and a tick but no
  exchange driver, as in the reference.

Injections are a program over rounds (:func:`inject_args`): padded
int32 tensors on the device, lowered once from the config.  An
injection is *applied* iff its owner is alive at its round and
eventually alive under the fault program (the acked-adds semantics), so
exact convergence to :func:`ground_truth` on the eventual-alive set is
an invariant under any fault program.  :func:`converged_count` counts
the nodes whose whole row equals the truth bitwise; the loops divide
that integer by the eventual-alive total once, on the host.

The byzantine exchange (:func:`pull_merge_crdt_byz`) renders, on the
receiver's side, what an active liar partner serves (corrupt: xor;
replay: the all-zero genesis row; equivocate: a pattern keyed by the
receiver's id; inflate: raised columns or forged bits), always on
components the liar does not own; with ``defend=True`` the admission
takes only the partner's own counter columns, or a set bit served by
its owner or echoed by ``quorum`` distinct partners in the round.

Memory: one round gathers ``k`` rows for every node.  The exchange works
on blocks of destination rows (:func:`block_rows_for`), so a round holds
the state, its successor and one block, never ``[N, k, S]``; max and OR
are exact, so the blocking changes no bit.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from gossip_tpu_torch.config import (CRDT_COUNTER_KINDS, CRDT_SET_KINDS,
                                     GCOUNTER, PNCOUNTER, VCLOCK,
                                     CrdtConfig, FaultConfig)
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.bitpack import n_words, pack
from gossip_tpu_torch.ops.common import from_words, resolve_device
from gossip_tpu_torch.ops.philox import MASK32

# Minimum padded injection-list length (a power-of-two bucket).
INJECT_A_MIN = 8

# Round of the padding rows: beyond any real round, so they never fire.
NO_ROUND = 1 << 29

# Bytes of one gathered block ``[rows, k, S]`` of int32 (the exchange's
# working set beside the two state buffers).
BLOCK_BYTES = 1 << 28

# The equivocation pattern's multiplier (uint32 arithmetic).
EQUIV_MUL = 2654435761


def shard_columns(kind: str, n: int) -> int:
    """S: the state's column count for ``n`` nodes."""
    if kind == GCOUNTER or kind == VCLOCK:
        return n
    if kind == PNCOUNTER:
        return 2 * n
    raise ValueError(f"{kind!r} is not a counter-shard kind")


def set_words(cfg: CrdtConfig) -> int:
    """2W: the packed set state's word count (add + tombstone planes)."""
    return 2 * n_words(cfg.elements)


def state_width(cfg: CrdtConfig, n: int) -> int:
    """Columns of a state row (counter shards or packed set words)."""
    if cfg.kind in CRDT_SET_KINDS:
        return set_words(cfg)
    return shard_columns(cfg.kind, n)


def block_rows_for(width: int, k: int, budget: int = BLOCK_BYTES) -> int:
    """Destination rows a block of the exchange takes so that its
    gathered ``[rows, k, width]`` int32 stays within ``budget`` bytes."""
    return max(1, budget // (4 * max(1, k) * max(1, width)))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement wrap)."""
    return from_words(x & MASK32)


# -- merges (the join-semilattice operations) --------------------------

def merge_max(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Counter-shard / vector-clock join: elementwise max (into ``out``
    if given)."""
    return torch.maximum(a, b, out=out)


def merge_or(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Packed-set join: bitwise OR on both planes (into ``out`` if
    given)."""
    return torch.bitwise_or(a, b, out=out)


def merge(kind: str, a: torch.Tensor, b: torch.Tensor,
          out=None) -> torch.Tensor:
    """The one kind dispatcher every exchange goes through."""
    if kind in CRDT_SET_KINDS:
        return merge_or(a, b, out=out)
    return merge_max(a, b, out=out)


def _partner_rows(rows_all, safe_j, ok_j):
    """rows_all[safe_j] with the rows of invalid partners zeroed (a new
    tensor, zeroed in place)."""
    return rows_all.index_select(0, safe_j).masked_fill_(~ok_j[:, None], 0)


def _partners(partners, sentinel, serve):
    """(valid, safe, ok): real partners, their ids clamped into range,
    and those that serve (real and, with ``serve``, up)."""
    valid = partners < sentinel
    safe = torch.clamp(partners, max=sentinel - 1).to(torch.int64)
    return valid, safe, valid if serve is None else valid & serve[safe]


def _gather(rows_all, partners, sentinel, serve):
    """(valid, safe, got[Nl, k, S]): the partners' rows, zero where the
    partner is the sentinel or (``serve``) does not serve."""
    valid, safe, ok = _partners(partners, sentinel, serve)
    got = torch.stack([_partner_rows(rows_all, safe[:, j], ok[:, j])
                       for j in range(partners.shape[1])], dim=1)
    return valid, safe, got


def pull_join(join, rows_all: torch.Tensor, partners: torch.Tensor,
              sentinel: int, serve: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The ``join(a, b, out=None)`` of each node's ``k`` sampled peers'
    rows -> ``[Nl, S]``; an invalid partner gives the all-zero row.
    ``serve`` (bool[n]) folds the visibility mask into the gather: a
    partner that is down gives 0 too, as a gather from the reference's
    masked rows does.  One partner at a time, so the working set is two
    ``[Nl, S]`` rows."""
    _, safe, ok = _partners(partners, sentinel, serve)
    out = _partner_rows(rows_all, safe[:, 0], ok[:, 0])
    for j in range(1, partners.shape[1]):
        join(out, _partner_rows(rows_all, safe[:, j], ok[:, j]), out=out)
    return out


def pull_merge_crdt(kind: str, rows_all: torch.Tensor,
                    partners: torch.Tensor, sentinel: int,
                    serve: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`pull_join` with the kind's merge (0 is its identity)."""
    return pull_join(functools.partial(merge, kind), rows_all, partners,
                     sentinel, serve)


# -- the byzantine exchange --------------------------------------------

def set_owner_words(elements: int, n: int, origin: int,
                    device=None) -> torch.Tensor:
    """int32[n, 2W]: the element bits node i owns (element e's owner is
    ``(origin + e) % n``), on both planes."""
    dev = resolve_device(device)
    owners = (origin + torch.arange(elements, device=dev)) % n
    own = owners[None, :] == torch.arange(n, device=dev)[:, None]
    w = pack(own)
    return torch.cat([w, w], dim=1)


def _set_universe(elements: int, words2: int, device=None) -> torch.Tensor:
    """int32[2W]: the universe's bits on both planes (no transform
    touches the padding bits past ``elements``)."""
    w = pack(torch.ones((1, elements), dtype=torch.bool,
                        device=resolve_device(device)))[0]
    return torch.cat([w, w])[:words2]


def _select_kind(kindp, got, corrupt, equiv, inflate):
    out = torch.where(kindp == NE.BYZ_CODES["corrupt"], corrupt, got)
    out = torch.where(kindp == NE.BYZ_CODES["replay"],
                      torch.zeros_like(got), out)
    out = torch.where(kindp == NE.BYZ_CODES["equivocate"], equiv, out)
    return torch.where(kindp == NE.BYZ_CODES["inflate"], inflate, out)


def _byz_serve_counter(got, safe, active, gids, byz, n: int):
    """What liar partners serve, counter shards ``[Nl, k, S]``: non-own
    columns only; the adds wrap modulo 2^32 as int32 arithmetic does."""
    kindp = byz.kind[safe][:, :, None]
    argp = byz.arg[safe][:, :, None]
    s = got.shape[-1]
    col_owner = torch.arange(s, device=got.device) % n
    nonown = col_owner[None, None, :] != safe[:, :, None]
    g64, a64 = got.to(torch.int64), argp.to(torch.int64)
    corrupt = torch.where(nonown, got ^ argp, got)
    inflate = torch.where(nonown, _wrap32(g64 + a64), got)
    equiv = torch.where(nonown, _wrap32(
        g64 + a64 * (1 + gids.to(torch.int64)[:, None, None])), got)
    out = _select_kind(kindp, got, corrupt, equiv, inflate)
    return torch.where(active[:, :, None], out, got)


def _byz_serve_set(got, safe, active, gids, byz, own_words, universe):
    """What liar partners serve, packed set planes ``[Nl, k, 2W]``:
    non-own bits inside the universe only; the equivocation pattern is
    ``arg ^ (gid * 2654435761 mod 2^32)``."""
    kindp = byz.kind[safe][:, :, None]
    argp = byz.arg[safe][:, :, None]
    foreign = ~own_words[safe] & universe
    corrupt = got ^ (argp & foreign)
    inflate = got | foreign
    epat = argp ^ _wrap32(gids.to(torch.int64) * EQUIV_MUL)[:, None, None]
    equiv = got ^ (epat & foreign)
    out = _select_kind(kindp, got, corrupt, equiv, inflate)
    return torch.where(active[:, :, None], out, got)


def _unique_valid(safe: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[Nl, k]: the first occurrence of each distinct valid partner
    (a partner sampled twice is one witness)."""
    k = safe.shape[1]
    if k == 1:
        return valid
    eq = safe[:, :, None] == safe[:, None, :]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=safe.device), -1)[None]
    dup = (eq & valid[:, None, :] & earlier).any(dim=2)
    return valid & ~dup


def pull_merge_crdt_byz(cfg: CrdtConfig, rows_all: torch.Tensor,
                        partners: torch.Tensor, sentinel: int, *, byz,
                        round_: int, gids: torch.Tensor, n: int,
                        origin: int, alive_fn, defend: bool,
                        serve: Optional[torch.Tensor] = None,
                        own_words: Optional[torch.Tensor] = None,
                        universe: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """:func:`pull_merge_crdt` under a liar program: gather, zero the
    invalid (and, with ``serve``, the down) partners, render what each
    active liar serves, then the honest merge (``defend=False``, the
    control arm) or the defended admission (owner-column guard for
    counters; owner-direct or ``quorum``-echo for set bits).  A liar
    that is down serves nothing (``alive_fn`` gates the transform).
    ``own_words`` / ``universe`` may be passed precomputed."""
    kind = cfg.kind
    valid, safe, got = _gather(rows_all, partners, sentinel, serve)
    active = (valid & NE.byz_active(byz, safe, round_)
              & alive_fn(safe, round_))
    if kind in CRDT_SET_KINDS:
        if own_words is None:
            own_words = set_owner_words(cfg.elements, n, origin,
                                        rows_all.device)
        if universe is None:
            universe = _set_universe(cfg.elements, rows_all.shape[-1],
                                     rows_all.device)
        got = _byz_serve_set(got, safe, active, gids, byz, own_words,
                             universe)
        if not defend:
            out = got[:, 0, :]
            for j in range(1, got.shape[1]):
                out = merge_or(out, got[:, j, :])
            return out
        # owner-direct bits, plus bits echoed by >= quorum distinct
        # partners (a carry-save counting chain of depth 3)
        uniq = _unique_valid(safe, valid)
        once = torch.zeros_like(got[:, 0, :])
        twice, thrice, direct = (torch.zeros_like(once) for _ in range(3))
        for j in range(got.shape[1]):
            b = torch.where(uniq[:, j, None], got[:, j, :],
                            torch.zeros_like(once))
            thrice = thrice | (twice & b)
            twice = twice | (once & b)
            once = once | b
            direct = direct | (got[:, j, :] & own_words[safe[:, j]])
        q = int(byz.quorum)
        echoed = once if q <= 1 else (twice if q == 2 else thrice)
        return direct | echoed
    got = _byz_serve_counter(got, safe, active, gids, byz, n)
    if defend:
        # from partner p admit only p's own columns; max is the
        # monotonicity clamp
        s = got.shape[-1]
        col_owner = torch.arange(s, device=got.device) % n
        admit = ((col_owner[None, None, :] == safe[:, :, None])
                 & valid[:, :, None])
        got = torch.where(admit, got, torch.zeros((), dtype=got.dtype,
                                                  device=got.device))
    out = got[:, 0, :]
    for j in range(1, got.shape[1]):
        out = merge_max(out, got[:, j, :])
    return out


# -- honest-component convergence --------------------------------------

def honest_component_mask(cfg: CrdtConfig, n: int, origin: int,
                          honest: torch.Tensor) -> torch.Tensor:
    """The honest-owned components of a row: bool[S] for counter shards,
    int32[2W] bits for packed sets."""
    dev = honest.device
    if cfg.kind in CRDT_SET_KINDS:
        owners = (origin + torch.arange(cfg.elements, device=dev)) % n
        w = pack(honest[owners][None, :])[0]
        return torch.cat([w, w])
    s = state_width(cfg, n)
    return honest[torch.arange(s, device=dev) % n]


def byz_converged_tensor(cfg: CrdtConfig, rows: torch.Tensor,
                         truth: torch.Tensor, alive_honest: torch.Tensor,
                         comp_mask: torch.Tensor) -> torch.Tensor:
    """int64 0-d: honest eventually-alive nodes whose honest-owned
    components equal the truth bitwise (the ``byz_conv`` numerator), on
    the device."""
    if cfg.kind in CRDT_SET_KINDS:
        eq = ((rows & comp_mask[None, :])
              == (truth & comp_mask)[None, :]).all(dim=-1)
    else:
        eq = torch.where(comp_mask[None, :], rows == truth[None, :],
                         True).all(dim=-1)
    return (eq & alive_honest).sum()


def byz_converged_count(cfg: CrdtConfig, rows: torch.Tensor,
                        truth: torch.Tensor, alive_honest: torch.Tensor,
                        comp_mask: torch.Tensor) -> int:
    """:func:`byz_converged_tensor` as an int."""
    return int(byz_converged_tensor(cfg, rows, truth, alive_honest,
                                    comp_mask))


# -- injection lowering ------------------------------------------------

def _pad_pow2(length: int) -> int:
    return max(INJECT_A_MIN, 1 << max(0, (length - 1).bit_length()))


def counter_adds(cfg: CrdtConfig, n: int):
    """The effective add list ``[(node, round, amount), ...]``: scripted,
    or the default program: node j adds ``1 + j % 7`` at round 0 (a
    pncounter's odd nodes decrement)."""
    if cfg.adds:
        return list(cfg.adds)
    sign = -1 if cfg.kind == PNCOUNTER else 1
    return [(j, 0, int(1 + j % 7) * (sign if j % 2 else 1))
            for j in range(n)]


def _i32(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=dev)


def inject_args(cfg: CrdtConfig, n: int, device=None) -> tuple:
    """The injection program as padded int32 tensors on ``device``:
    counters ``(col, round, amount)`` with a pncounter's N-plane offset
    folded into ``col``; sets ``(add_elem, add_round, rem_elem,
    rem_round)``; padding rows at :data:`NO_ROUND`."""
    dev = resolve_device(device)
    kind = cfg.kind
    if kind == VCLOCK:
        return ()
    if kind in CRDT_COUNTER_KINDS:
        adds = counter_adds(cfg, n)
        bad = [a for a in adds if a[0] >= n]
        if bad:
            raise ValueError(f"counter adds reference node ids >= "
                             f"n={n}: {bad}")
        pad = _pad_pow2(len(adds)) - len(adds)
        col = [(node if amt >= 0 else n + node)
               if kind == PNCOUNTER else node for node, _, amt in adds]
        return (_i32(col + [0] * pad, dev),
                _i32([r for _, r, _ in adds] + [NO_ROUND] * pad, dev),
                _i32([abs(a) for _, _, a in adds] + [0] * pad, dev))
    set_adds = (list(cfg.set_adds) if cfg.set_adds
                else [(e, 0) for e in range(cfg.elements)])

    def elem_rounds(pairs):
        pad = (_pad_pow2(len(pairs)) if pairs else INJECT_A_MIN) - len(pairs)
        return (_i32([e for e, _ in pairs] + [0] * pad, dev),
                _i32([r for _, r in pairs] + [NO_ROUND] * pad, dev))

    return elem_rounds(set_adds) + elem_rounds(list(cfg.set_removes))


def injection_rounds(*rounds: torch.Tensor) -> frozenset:
    """The rounds (host ints) at which some injection of the given round
    operands is scripted: the step touches the state on those only."""
    out = set()
    for t in rounds:
        out.update(int(r) for r in t.tolist() if r < NO_ROUND)
    return frozenset(out)


def inject_round_operands(cfg: CrdtConfig, inj: tuple) -> tuple:
    """The round operands of :func:`inject_args`'s tuple."""
    return inj[1::2] if cfg.kind in CRDT_SET_KINDS else inj[1:2]


def _applied_mask(rounds: torch.Tensor, owners: torch.Tensor, alive_at_fn,
                  eventual: torch.Tensor) -> torch.Tensor:
    """bool[A]: the injections that are applied: real, owner alive at
    the round, owner eventually alive."""
    real = rounds < NO_ROUND
    return real & alive_at_fn(owners, rounds) & eventual[owners]


def alive_at_fn(fault: Optional[FaultConfig], n: int, origin: int,
                device=None):
    """``(nodes, rounds) -> bool``: liveness of ``nodes`` at ``rounds``
    under the static mask and the churn windows (tensors that broadcast;
    ``rounds`` may be an int).  Shared by the injections, the truth and
    the liars' gate, so they cannot disagree."""
    dev = resolve_device(device)
    base = (NE.base_alive_or_ones(fault, n, origin, dev)
            if fault is not None
            else torch.ones(n, dtype=torch.bool, device=dev))
    ch = NE.get(fault)
    if ch is not None:
        die, rec = NE._event_tables(ch, n, dev)
    else:
        die = rec = torch.full((n,), NE.NEVER, dtype=torch.int32, device=dev)

    def fn(nodes, rounds):
        nodes = torch.as_tensor(nodes, device=dev).to(torch.int64)
        down = (die[nodes] <= rounds) & (rec[nodes] > rounds)
        return base[nodes] & ~down

    return fn


def eventual_alive_crdt(fault: Optional[FaultConfig], n: int, origin: int,
                        device=None) -> torch.Tensor:
    """bool[n]: the eventual-alive set (the convergence denominator)."""
    dev = resolve_device(device)
    if fault is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return NE.eventual_alive(fault, n, origin, dev)


def _fired_bits(elements: int, elem, fire) -> torch.Tensor:
    """bool[E]: element e is set where some fired row names it (the
    reference's scatter-max)."""
    bits = torch.zeros(elements, dtype=torch.int32, device=elem.device)
    bits.scatter_reduce_(0, elem.to(torch.int64), fire.to(torch.int32),
                         "amax")
    return bits.bool()


def _counter_row(kind, inj, fire, n) -> torch.Tensor:
    """int32[S]: the fired amounts summed into their columns."""
    col, _, amt = inj
    row = torch.zeros(shard_columns(kind, n), dtype=torch.int32,
                      device=col.device)
    return row.index_add_(0, col.to(torch.int64),
                          torch.where(fire, amt, 0))


def apply_injections(cfg: CrdtConfig, val: torch.Tensor, inj: tuple,
                     round_, n: int, origin: int, alive_fn,
                     eventual: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """``val`` with this round's applied injections merged in, IN PLACE:
    counters add into each column's owner row, sets OR into the element
    owner's row (the reference's ``inject_rows`` merged into the state,
    without its dense ``[N, S]`` rows).  ``val`` holds the rows of the
    global ids ``[lo, lo + len(val))``: the whole state from ``lo = 0``,
    or a rank's window of a sharded one, where an injection whose owner
    lies outside the window is not this rank's."""
    r = int(round_)
    if cfg.kind == VCLOCK:
        raise ValueError("vclock rows tick via vclock_tick, not "
                         "injections")
    dev = val.device
    hi = lo + val.shape[0]
    if cfg.kind in CRDT_COUNTER_KINDS:
        col, rnd, _ = inj
        fire = (rnd == r) & _applied_mask(rnd, col % n, alive_fn, eventual)
        row = _counter_row(cfg.kind, inj, fire, n)
        cols = torch.arange(row.shape[0], device=dev)
        owner = cols % n
        mine = (owner >= lo) & (owner < hi)
        val.index_put_((owner[mine] - lo, cols[mine]), row[mine],
                       accumulate=True)
        return val
    owners = (origin + torch.arange(cfg.elements, device=dev)) % n
    w = n_words(cfg.elements)
    elems = torch.arange(cfg.elements, device=dev)
    mine = (owners >= lo) & (owners < hi)
    for off, (elem, rnd) in ((0, inj[:2]), (w, inj[2:])):
        fire = (rnd == r) & _applied_mask(rnd, owners[elem], alive_fn,
                                          eventual)
        bits = _fired_bits(cfg.elements, elem, fire)
        words = torch.zeros((val.shape[0], w), dtype=torch.int64,
                            device=dev)
        words.index_put_((owners[mine] - lo, elems[mine] // 32),
                         bits[mine].to(torch.int64) << (elems[mine] % 32),
                         accumulate=True)
        val[:, off:off + w] |= from_words(words)
    return val


def vclock_tick(vc: torch.Tensor, gids: torch.Tensor, alive: torch.Tensor,
                n: int) -> torch.Tensor:
    """One local event per alive node: ``vc[i, gids[i]] += alive[i]``
    (an out-of-range entry is dropped)."""
    out = vc.clone()
    rows = torch.arange(vc.shape[0], device=vc.device)
    gids = gids.to(torch.int64)
    keep = gids < vc.shape[1]
    out.index_put_((rows[keep], gids[keep]),
                   alive[keep].to(vc.dtype), accumulate=True)
    return out


# -- ground truth and value convergence (integer-exact) ----------------

def ground_truth(cfg: CrdtConfig, inj: tuple, fault, n: int, origin: int,
                 device=None) -> torch.Tensor:
    """The merged row ``[S]`` every eventually-alive node must reach:
    the merge of all applied injections, from the same operands and
    liveness predicate as the round's injection."""
    dev = resolve_device(device)
    alive_fn = alive_at_fn(fault, n, origin, dev)
    eventual = eventual_alive_crdt(fault, n, origin, dev)
    if cfg.kind in CRDT_COUNTER_KINDS:
        col, rnd, _ = inj
        fire = _applied_mask(rnd, col % n, alive_fn, eventual)
        return _counter_row(cfg.kind, inj, fire, n)
    owners = (origin + torch.arange(cfg.elements, device=dev)) % n

    def plane(elem, rnd):
        fire = _applied_mask(rnd, owners[elem], alive_fn, eventual)
        return pack(_fired_bits(cfg.elements, elem, fire)[None, :])[0]

    return torch.cat([plane(*inj[:2]), plane(*inj[2:])])


def counter_value(kind: str, rows: torch.Tensor, n: int) -> torch.Tensor:
    """The merged counter value of each row, int32 (sums wrap as the
    reference's int32 sums do)."""
    def isum(x):
        return _wrap32(x.sum(dim=-1, dtype=torch.int64))
    if kind == GCOUNTER:
        return isum(rows)
    if kind == PNCOUNTER:
        return _wrap32(isum(rows[..., :n]).to(torch.int64)
                       - isum(rows[..., n:]).to(torch.int64))
    raise ValueError(f"{kind!r} has no scalar counter value")


def set_members(rows: torch.Tensor) -> torch.Tensor:
    """Membership planes of packed set state: add & ~tombstone."""
    w = rows.shape[-1] // 2
    return rows[..., :w] & ~rows[..., w:]


def converged_count(rows: torch.Tensor, truth: torch.Tensor,
                    alive: torch.Tensor) -> torch.Tensor:
    """int64 0-d: alive nodes whose whole row equals the truth bitwise
    (both planes of a set), counted over blocks of rows."""
    n = rows.shape[0]
    b = block_rows_for(rows.shape[1], 1)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for a in range(0, n, b):
        eq = (rows[a:a + b] == truth[None, :]).all(dim=-1)
        total += (eq & alive[a:a + b]).sum()
    return total


def payload_count(cfg: CrdtConfig, rows: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """int64 0-d: the payload mass over alive rows (counter shard sums
    or set bits), exact, with no host read (the round metrics'
    ``newly`` integrand).  Equal to the reference's float32 sum while
    the mass stays below 2^24, where that sum is exact; above, the
    reference's value depends on its summation order and this one is
    the exact mass (its float32 rounding, correctly rounded once)."""
    live = torch.where(alive[:, None], rows.to(torch.int64), 0)
    if cfg.kind in CRDT_SET_KINDS:
        live = live & 0xFFFFFFFF
        return ((live[..., None] >> torch.arange(32, device=rows.device))
                & 1).sum()
    return live.sum()


def value_conv_frac(rows: torch.Tensor, truth: torch.Tensor,
                    alive: torch.Tensor) -> torch.Tensor:
    """float32 0-d: the converged fraction of the alive rows, the
    reference's in-loop ``value_conv`` column (pinned readouts use
    :func:`converged_count` and divide on the host)."""
    return (converged_count(rows, truth, alive).to(torch.float32)
            / torch.clamp(alive.sum().to(torch.float32), min=1.0))


def byz_conv_frac(cfg: CrdtConfig, rows: torch.Tensor, truth: torch.Tensor,
                  alive_honest: torch.Tensor,
                  comp_mask: torch.Tensor) -> torch.Tensor:
    """float32 0-d: the ``byz_conv`` column, the honest converged
    fraction (the :func:`value_conv_frac` rule)."""
    return (byz_converged_tensor(cfg, rows, truth, alive_honest, comp_mask)
            .to(torch.float32)
            / torch.clamp(alive_honest.sum().to(torch.float32), min=1.0))