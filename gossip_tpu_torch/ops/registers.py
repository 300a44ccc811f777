"""Last-writer-wins registers: the transaction payload on the gossip
fabric.

The port of the JAX package's ``ops/registers.py`` on one device: the
Maelstrom ``txn-rw-register`` workload (multi-key read/write
transactions over replicated registers) in array form.  K registers
flatten to one ``int32[N, 2K]`` row per node:

* columns ``0 .. K-1``, the value planes: column k holds the winning
  value of register k (0 = never written; values are >= 1);
* columns ``K .. 2K-1``, the timestamp planes: column K+k holds the
  winning write's timestamp, ``round * n + owner + 1``
  (:func:`pack_ts`; 0 = never written), so the order of ``(round,
  owner)`` is one integer compare and the tie at equal rounds goes to
  the higher owner.

:func:`merge_lww` is the per-key join: the larger timestamp wins and
brings its value, and at equal timestamps the larger value wins.  That
is the lexicographic maximum of ``(timestamp, value)``, a total order,
so the join is commutative, associative and idempotent on every int32
state and the exchange may fold partners in any order.

Writes are a program over rounds (:func:`inject_args`, padded device
tensors) built from the config or by the skewed default generator
(:func:`txn_writes`, pure Python floats, copied statement for statement
from the reference: a reordered sum would move a key).  A write is
applied iff its owner is alive at its round and eventually alive (the
CRDT payloads' predicates, shared from :mod:`gossip_tpu_torch.ops.crdt`);
:func:`ground_truth` picks each key's winning applied write from the
same operands as the round's injection (:func:`apply_injections`), and
convergence is the CRDT payloads' integer count over whole rows.

The byzantine exchange (:func:`pull_merge_reg_byz`): a liar serves
foreign entries (claimed owner ``(ts - 1) % n`` not itself) with forged
timestamps or values; the defended admission takes an entry from
partner p only when p is its claimed owner and its claimed round
``(ts - 1) // n`` is not in the future.  The liars' int32 sums wrap
modulo 2^32 as the reference's do (computed in int64 and wrapped).
"""

from __future__ import annotations

import math

import torch

from gossip_tpu_torch.config import TxnConfig
# one definition each of the padding bucket, the no-injection round and
# the liveness predicates, shared with the CRDT and log payloads
from gossip_tpu_torch.ops.crdt import (NO_ROUND, _applied_mask, _gather,
                                       _i32, _pad_pow2, _wrap32, alive_at_fn,
                                       converged_count, eventual_alive_crdt,
                                       injection_rounds, pull_join)
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.common import resolve_device

__all__ = ["alive_at_fn", "apply_injections", "byz_conv_frac",
           "byz_converged_count", "byz_converged_tensor", "payload_count",
           "check_ts_packable", "converged_count", "eventual_alive_crdt",
           "ground_truth", "honest_key_mask", "inject_args",
           "injection_rounds", "merge_lww", "pack_ts", "pull_merge_reg",
           "pull_merge_reg_byz", "state_width", "truth_summary",
           "txn_writes"]


def state_width(cfg: TxnConfig) -> int:
    """2K: value planes then timestamp planes."""
    return 2 * cfg.keys


def check_ts_packable(cfg: TxnConfig, n: int) -> None:
    """The packed timestamp ``round * n + owner + 1`` must fit int32;
    an overflow would fork LWW winners between replicas, so it is
    refused (the reference's words)."""
    last = cfg.horizon() - 1
    if (last + 1) * n + 1 > 2 ** 31 - 1:
        raise ValueError(
            f"packed (round, owner) timestamp overflows int32 at "
            f"round {last} with n={n} (needs (round+1)*n+1 < 2^31); "
            "shrink the write program's horizon or n")


def pack_ts(rounds: torch.Tensor, owners: torch.Tensor,
            n: int) -> torch.Tensor:
    """int32 ``round * n + owner + 1``; padding rows (``NO_ROUND``) give
    0, which never wins."""
    real = rounds < NO_ROUND
    rc = torch.where(real, rounds, 0)
    return torch.where(real, rc * n + owners + 1, 0).to(torch.int32)


# -- the LWW join ------------------------------------------------------

def merge_lww(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Per-key join of two ``[..., 2K]`` rows: the larger timestamp and
    its value, ``max(value)`` at equal timestamps (into ``out`` if given;
    ``out`` may be ``a`` or ``b``: the value choice reads both timestamp
    planes, so it is made before the timestamps are written)."""
    k = a.shape[-1] // 2
    va, ta = a[..., :k], a[..., k:]
    vb, tb = b[..., :k], b[..., k:]
    v = torch.where(ta > tb, va,
                    torch.where(tb > ta, vb, torch.maximum(va, vb)))
    if out is None:
        return torch.cat([v, torch.maximum(ta, tb)], dim=-1)
    torch.maximum(ta, tb, out=out[..., k:])
    out[..., :k] = v
    return out


def pull_merge_reg(rows_all: torch.Tensor, partners: torch.Tensor,
                   sentinel: int, serve=None) -> torch.Tensor:
    """The LWW join of each node's ``k`` sampled peers' register rows
    (the all-zero row for an invalid or, with ``serve``, a down
    partner)."""
    return pull_join(merge_lww, rows_all, partners, sentinel, serve)


# -- the byzantine exchange --------------------------------------------

def _claimed(t: torch.Tensor, n: int):
    """(owner, round) a packed timestamp claims: ``(t - 1) % n`` and
    ``(t - 1) // n``, floored as ``jnp`` floors them, in int64 (the
    callers read them only where ``t > 0``; a wrapped forgery may be
    negative)."""
    t1 = t.to(torch.int64) - 1
    return (torch.remainder(t1, n),
            torch.div(t1, n, rounding_mode="floor"))


def _byz_serve_reg(got, safe, active, gids, byz, n: int):
    """What active liar partners serve, register rows ``[Nl, k, 2K]``,
    on foreign written entries only (``t > 0`` and claimed owner not the
    liar): corrupt = timestamp + n (claimed round + 1) and value xor
    arg; replay = the all-zero genesis row; equivocate = timestamp +
    ``n * (1 + (receiver & 3))``; inflate = timestamp + ``n * arg``.
    The sums wrap modulo 2^32 as the reference's int32 sums do."""
    k = got.shape[-1] // 2
    v, t = got[..., :k], got[..., k:]
    kindp = byz.kind[safe][:, :, None]
    argp = byz.arg[safe][:, :, None]
    owner, _ = _claimed(t, n)
    foreign = (t > 0) & (owner != safe[:, :, None])
    t64, a64 = t.to(torch.int64), argp.to(torch.int64)
    g64 = gids.to(torch.int64)[:, None, None]
    t_cor = torch.where(foreign, _wrap32(t64 + n), t)
    v_cor = torch.where(foreign, v ^ argp, v)
    t_inf = torch.where(foreign, _wrap32(t64 + n * a64), t)
    t_eqv = torch.where(foreign, _wrap32(t64 + n * (1 + (g64 & 3))), t)
    codes = NE.BYZ_CODES
    vv = torch.where(kindp == codes["corrupt"], v_cor, v)
    tt = torch.where(kindp == codes["corrupt"], t_cor, t)
    vv = torch.where(kindp == codes["replay"], 0, vv)
    tt = torch.where(kindp == codes["replay"], 0, tt)
    tt = torch.where(kindp == codes["equivocate"], t_eqv, tt)
    tt = torch.where(kindp == codes["inflate"], t_inf, tt)
    out = torch.cat([vv, tt], dim=-1)
    return torch.where(active[:, :, None], out, got)


def pull_merge_reg_byz(rows_all: torch.Tensor, partners: torch.Tensor,
                       sentinel: int, *, byz, round_: int,
                       gids: torch.Tensor, n: int, alive_fn, defend: bool,
                       serve=None) -> torch.Tensor:
    """:func:`pull_merge_reg` under a liar program: gather (zero for an
    invalid or, with ``serve``, a down partner), render what each active
    liar serves (a liar that is down serves nothing), then the LWW join
    of every partner's row (``defend=False``, the control arm) or of the
    admitted entries only: from partner p at round r, ``ts > 0``, claimed
    owner p and claimed round at most r (owner-direct propagation)."""
    valid, safe, got = _gather(rows_all, partners, sentinel, serve)
    active = (valid & NE.byz_active(byz, safe, round_)
              & alive_fn(safe, round_))
    got = _byz_serve_reg(got, safe, active, gids, byz, n)
    if defend:
        k = got.shape[-1] // 2
        t = got[..., k:]
        owner, claimed_round = _claimed(t, n)
        admit = (valid[:, :, None] & (t > 0)
                 & (owner == safe[:, :, None]) & (claimed_round <= round_))
        got = torch.where(torch.cat([admit, admit], dim=-1), got, 0)
    out = got[:, 0, :]
    for j in range(1, got.shape[1]):
        out = merge_lww(out, got[:, j, :])
    return out


# -- honest-component convergence -------------------------------------

def honest_key_mask(cfg: TxnConfig, inj: tuple, fault, n: int, origin: int,
                    honest: torch.Tensor) -> torch.Tensor:
    """bool[K]: the keys whose ground-truth winner is honest-owned, or
    never written (a liar may withhold or overwrite its own wins, which
    no defense can detect)."""
    _, _, best = _write_plan(cfg, inj, fault, n, origin)
    owner, _ = _claimed(best, n)
    owner = torch.where(best > 0, owner, 0)
    return (best == 0) | honest[owner]


def byz_converged_tensor(cfg: TxnConfig, rows: torch.Tensor,
                         truth: torch.Tensor, alive_honest: torch.Tensor,
                         key_mask: torch.Tensor) -> torch.Tensor:
    """int64 0-d: honest eventually-alive rows equal to the truth on
    every honest-won key, both planes (the ``byz_conv`` numerator), on
    the device."""
    m2 = torch.cat([key_mask, key_mask])
    eq = torch.where(m2[None, :], rows == truth[None, :], True).all(dim=-1)
    return (eq & alive_honest).sum()


def byz_converged_count(cfg: TxnConfig, rows: torch.Tensor,
                        truth: torch.Tensor, alive_honest: torch.Tensor,
                        key_mask: torch.Tensor) -> int:
    """:func:`byz_converged_tensor` as an int."""
    return int(byz_converged_tensor(cfg, rows, truth, alive_honest,
                                    key_mask))


def byz_conv_frac(cfg: TxnConfig, rows: torch.Tensor, truth: torch.Tensor,
                  alive_honest: torch.Tensor,
                  key_mask: torch.Tensor) -> torch.Tensor:
    """float32 0-d: the ``byz_conv`` column, the honest converged
    fraction (the reference's in-loop form; pinned readouts use the
    integer count)."""
    return (byz_converged_tensor(cfg, rows, truth, alive_honest, key_mask)
            .to(torch.float32)
            / torch.clamp(alive_honest.sum().to(torch.float32), min=1.0))


def payload_count(cfg: TxnConfig, rows: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """int64 0-d: the timestamp mass over alive rows (the round metrics'
    ``newly`` integrand: timestamps only grow under the LWW join), exact
    and with no host read.  The reference sums it in float32, which is
    exact only while the mass stays below 2^24; past it the reference's
    value depends on its summation order and this one is the exact
    mass."""
    return torch.where(alive[:, None], rows[..., cfg.keys:].to(torch.int64),
                       0).sum()


# -- the skewed default traffic program (closed forms, no RNG) ---------

def _hash01(i: int, salt: int = 0) -> float:
    """Deterministic quasi-uniform in [0, 1): Knuth's multiplicative
    hash on the write index."""
    x = ((i * 2654435761) ^ (salt * 40503)) & 0xFFFFFFFF
    x = (x * 2246822519 + 3266489917) & 0xFFFFFFFF
    return x / 2 ** 32


def _zipf_key(u: float, keys: int, alpha: float) -> int:
    """Inverse-CDF zipf(alpha) pick over ``keys`` ranks for quantile
    ``u``; key 0 is the most popular rank."""
    weights = [1.0 / (r + 1) ** alpha for r in range(keys)]
    total = sum(weights)
    acc = 0.0
    for k, w in enumerate(weights):
        acc += w / total
        if u < acc:
            return k
    return keys - 1


def _load_round(q: float, load: str, spread: int) -> int:
    """Round for program quantile ``q`` in [0, 1) under the load curve:
    ``uniform`` spreads evenly; ``diurnal`` inverts the CDF of density
    ``1 + sin`` by 30 bisection steps."""
    if load == "uniform" or spread == 1:
        return min(spread - 1, int(q * spread))

    def cdf(x):    # integral of (1 + sin(pi * x)) / norm over [0, 1]
        return (x + (1.0 - math.cos(math.pi * x)) / math.pi) / \
            (1.0 + 2.0 / math.pi)

    lo, hi = 0.0, 1.0
    for _ in range(30):
        mid = (lo + hi) / 2
        if cdf(mid) < q:
            lo = mid
        else:
            hi = mid
    return min(spread - 1, int(lo * spread))


def txn_writes(cfg: TxnConfig, n: int):
    """The effective write list ``[(node, key, round, value), ...]``:
    scripted, or the default skewed program: write i picks its key by
    zipf(``zipf_alpha``) on a hashed quantile, goes to key 0 with
    probability ``hot_key`` in the middle third of the program, lands on
    the ``load`` curve's round, is written by node ``(5 * key + c) % n``
    where ``c`` counts the earlier writes of its (key, round) bucket
    (a bucket of more than n writes is refused: no unique timestamps),
    with value ``1 + (5 * i + 11 * key) % 97``."""
    if cfg.writes:
        return list(cfg.writes)
    t = cfg.txns
    out = []
    bucket: dict = {}
    for i in range(t):
        q = (i + 0.5) / t
        key = _zipf_key(_hash01(i, 1), cfg.keys, cfg.zipf_alpha)
        if (cfg.hot_key > 0 and t // 3 <= i < (2 * t) // 3
                and _hash01(i, 2) < cfg.hot_key):
            key = 0
        rnd = _load_round(q, cfg.load, cfg.spread_rounds)
        c = bucket.get((key, rnd), 0)
        bucket[(key, rnd)] = c + 1
        if c >= n:
            raise ValueError(
                f"the default txn program places {c + 1} writes on "
                f"key {key} at round {rnd} but only n={n} distinct "
                "writers exist — more than n same-(key, round) "
                "writes cannot carry unique (round, owner) "
                "timestamps; lower --txns, raise --spread (or ease "
                "--hot-key/--zipf-alpha), or raise --n")
        node = (5 * key + c) % n
        out.append((node, key, rnd, 1 + (5 * i + 11 * key) % 97))
    return out


def inject_args(cfg: TxnConfig, n: int, device=None) -> tuple:
    """The write program as four padded int32 tensors on ``device``:
    ``(w_node, w_key, w_round, w_val)``, padding rows at ``NO_ROUND``.
    Checks the timestamps' int32 packing and, on the effective list,
    the node ids and the unique (key, round, node) contract."""
    dev = resolve_device(device)
    check_ts_packable(cfg, n)
    writes = txn_writes(cfg, n)
    bad = [w for w in writes if w[0] >= n]
    if bad:
        raise ValueError(f"txn writes reference node ids >= n={n}: "
                         f"{bad}")
    trips = [(k, r, nd) for nd, k, r, _ in writes]
    if len(set(trips)) != len(trips):
        dup = sorted({t for t in trips if trips.count(t) > 1})
        raise ValueError(
            f"txn write program carries duplicate (key, round, node) "
            f"triples {dup[:4]} — two writes would share one "
            "(round, owner) timestamp and fork the LWW winner; "
            "script distinct writers or rounds")
    pad = _pad_pow2(len(writes)) - len(writes)
    fill = (0, 0, NO_ROUND, 0)      # node, key, round, value
    return tuple(_i32([w[j] for w in writes] + [fill[j]] * pad, dev)
                 for j in range(4))


# -- ground truth and the in-place injection (one decomposition) -------

def _write_plan(cfg: TxnConfig, inj: tuple, fault, n: int, origin: int):
    """(applied mask, each write's packed timestamp, each key's winning
    timestamp int32[K]), shared by the injection and the truth."""
    w_node, w_key, w_round, _ = inj
    dev = w_node.device
    alive_fn = alive_at_fn(fault, n, origin, dev)
    eventual = eventual_alive_crdt(fault, n, origin, dev)
    applied = _applied_mask(w_round, w_node, alive_fn, eventual)
    ts = torch.where(applied, pack_ts(w_round, w_node, n), 0)
    best = torch.zeros(cfg.keys, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, w_key.to(torch.int64), ts, "amax")
    return applied, ts, best


def ground_truth(cfg: TxnConfig, inj: tuple, fault, n: int,
                 origin: int) -> torch.Tensor:
    """The row ``[2K]`` every eventually-alive node must reach: per key
    the value and timestamp of the applied write with the largest
    timestamp ((0, 0) for a key never written)."""
    w_key, w_val = inj[1], inj[3]
    applied, ts, best = _write_plan(cfg, inj, fault, n, origin)
    key = w_key.to(torch.int64)
    win = applied & (ts > 0) & (ts == best[key])
    val = torch.zeros(cfg.keys, dtype=torch.int32, device=w_key.device)
    val.scatter_reduce_(0, key, torch.where(win, w_val, 0), "amax")
    return torch.cat([val, best])


def apply_injections(cfg: TxnConfig, val: torch.Tensor, inj: tuple,
                     round_, n: int, origin: int, fault,
                     lo: int = 0) -> torch.Tensor:
    """``val`` with this round's applied writes LWW-joined into their
    owners' entries, IN PLACE: the reference's ``inject_rows`` joined
    into the state by ``merge_lww``, without its dense rows.  Each write
    is joined with its owner's entry (an undefended liar may have left a
    later forged timestamp there, which then stays); the rows no write
    touches are unchanged, exact because a reachable state's entries are
    never below (0, 0), the join's zero row.  A node writes a key at
    most once a round (the unique-timestamp contract), so the entries
    are distinct.  ``val`` holds the rows of the global ids ``[lo, lo +
    len(val))`` (:func:`~gossip_tpu_torch.ops.crdt.apply_injections`)."""
    w_node, w_key, w_round, w_val = inj
    applied, ts, _ = _write_plan(cfg, inj, fault, n, origin)
    fire = ((w_round == int(round_)) & applied & (w_node >= lo)
            & (w_node < lo + val.shape[0]))
    rows = w_node[fire].to(torch.int64) - lo
    vcol = w_key[fire].to(torch.int64)
    tcol = vcol + cfg.keys
    pair = torch.stack([val[rows, vcol], val[rows, tcol]], dim=-1)
    write = torch.stack([w_val[fire], ts[fire]], dim=-1)
    joined = merge_lww(pair, write)
    val[rows, vcol] = joined[:, 0]
    val[rows, tcol] = joined[:, 1]
    return val


# -- readouts ----------------------------------------------------------

def truth_summary(cfg: TxnConfig, truth, n: int) -> dict:
    """Per-key winning values and the unpacked (round, owner) of each
    winner (-1 for keys never written), for reports."""
    truth = truth.detach().cpu().numpy()
    vals = truth[:cfg.keys]
    ts = truth[cfg.keys:]
    rounds = [int((t - 1) // n) if t > 0 else -1 for t in ts]
    owners = [int((t - 1) % n) if t > 0 else -1 for t in ts]
    return {"values": [int(v) for v in vals],
            "ts_round": rounds, "ts_owner": owners,
            "written_keys": int((ts > 0).sum())}
