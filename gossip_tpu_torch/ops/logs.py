"""Replicated kafka-style logs: ordered per-key offset payloads.

The port of the JAX package's ``ops/logs.py`` on one device.  Each node
carries K fixed-capacity per-key logs and a committed-offset vector, one
``int32[N, S]`` row with ``S = K * (C + 1)``:

* columns ``0 .. K*C-1``, the entry planes: column ``k*C + c`` holds the
  value appended at offset ``c`` of key ``k`` (0 = empty; values are
  >= 1);
* columns ``K*C .. K*C+K-1``: key ``k``'s committed count.

Every entry slot is written once, by the one appender of the applied
send at that offset, and committed counts only grow, so the merge is the
elementwise max (:func:`~gossip_tpu_torch.ops.crdt.merge_max`).

Sends ``(node, key, round, value)`` and commits ``(node, key, round,
upto)`` are a program over rounds (:func:`inject_args`).  A send or a
commit is applied under the CRDT payloads' liveness predicate (owner
alive at its round and eventually alive); a key's applied sends take
offsets ``0 .. m-1`` in script order (:func:`send_offsets`), and a
commit commits ``min(upto, truth_len[key])``.  :func:`ground_truth`
builds the truth row from the same operands, so target and trajectory
cannot drift; convergence is the CRDT payloads' integer count.
"""

from __future__ import annotations

import torch

from gossip_tpu_torch.config import GCOUNTER, LogConfig
# one definition each of the padding bucket, the no-injection round and
# the liveness predicates, shared with the CRDT payloads
from gossip_tpu_torch.ops.crdt import (NO_ROUND, _applied_mask, _i32,
                                       _pad_pow2, alive_at_fn,
                                       converged_count, eventual_alive_crdt,
                                       merge_max, pull_merge_crdt)
from gossip_tpu_torch.ops.common import resolve_device

__all__ = ["alive_at_fn", "apply_injections", "committed_of",
           "converged_count", "eventual_alive_crdt", "ground_truth",
           "inject_args", "log_commits", "log_len",
           "log_sends", "merge_max", "payload_count", "pull_merge_log",
           "send_offsets", "state_width", "truth_summary"]


def state_width(cfg: LogConfig) -> int:
    """S = K*C entry slots + K committed columns."""
    return cfg.keys * (cfg.capacity + 1)


def pull_merge_log(rows_all: torch.Tensor, partners: torch.Tensor,
                   sentinel: int, serve=None) -> torch.Tensor:
    """The max of each node's ``k`` sampled peers' log rows (0 for an
    invalid or, with ``serve``, a down partner)."""
    return pull_merge_crdt(GCOUNTER, rows_all, partners, sentinel, serve)


def log_sends(cfg: LogConfig, n: int):
    """The effective send list: scripted, or the default program: key k
    gets 4 sends, send j by node ``(k + 3*j) % n`` at round j with value
    ``1 + (7*k + 3*j) % 23``."""
    if cfg.sends:
        return list(cfg.sends)
    return [(int((k + 3 * j) % n), k, j, 1 + (7 * k + 3 * j) % 23)
            for k in range(cfg.keys) for j in range(4)]


def log_commits(cfg: LogConfig, n: int):
    """The effective commit list: scripted, or the default: node
    ``(k + 1) % n`` commits key k up to 2 entries at round 4."""
    if cfg.commits:
        return list(cfg.commits)
    return [(int((k + 1) % n), k, 4, 2) for k in range(cfg.keys)]


def inject_args(cfg: LogConfig, n: int, device=None) -> tuple:
    """The send and commit programs as eight padded int32 tensors on
    ``device``: ``(s_node, s_key, s_round, s_val, c_node, c_key,
    c_round, c_upto)``."""
    dev = resolve_device(device)
    sends = log_sends(cfg, n)
    commits = log_commits(cfg, n)
    bad = [s for s in sends if s[0] >= n] + \
        [c for c in commits if c[0] >= n]
    if bad:
        raise ValueError(f"log sends/commits reference node ids >= "
                         f"n={n}: {bad}")

    def quad(items):
        pad = _pad_pow2(len(items)) - len(items)
        fill = (0, 0, NO_ROUND, 0)    # node, key, round, value/upto
        return tuple(_i32([it[j] for it in items] + [fill[j]] * pad, dev)
                     for j in range(4))

    return quad(sends) + quad(commits)


def send_offsets(s_key: torch.Tensor, applied: torch.Tensor) -> torch.Tensor:
    """int32[A]: each send's offset in its key, the count of applied
    sends of the same key at an earlier script index."""
    a = s_key.shape[0]
    idx = torch.arange(a, device=s_key.device)
    earlier = idx[None, :] < idx[:, None]
    same_key = s_key[None, :] == s_key[:, None]
    return (earlier & same_key & applied[None, :]).sum(
        dim=1, dtype=torch.int32)


def _send_plan(cfg: LogConfig, inj: tuple, fault, n: int, origin: int):
    """The applied masks, each send's flat slot, the per-key truth
    lengths and each commit's clamped value, shared by the round's
    injection and the truth."""
    s_node, s_key, s_round, _ = inj[:4]
    c_node, c_key, c_round, c_upto = inj[4:]
    dev = s_node.device
    alive_fn = alive_at_fn(fault, n, origin, dev)
    eventual = eventual_alive_crdt(fault, n, origin, dev)
    applied_s = _applied_mask(s_round, s_node, alive_fn, eventual)
    slot = s_key * cfg.capacity + send_offsets(s_key, applied_s)
    truth_len = torch.zeros(cfg.keys, dtype=torch.int32, device=dev)
    truth_len.index_add_(0, s_key.to(torch.int64),
                         applied_s.to(torch.int32))
    applied_c = _applied_mask(c_round, c_node, alive_fn, eventual)
    cval = torch.minimum(c_upto, truth_len[c_key.to(torch.int64)])
    return applied_s, slot, truth_len, applied_c, cval


def _scatter_max(row: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """``row.at[idx].max(vals)`` dropping ``idx`` outside the row, IN
    PLACE on a flat int32 row (values are >= 0, so a dropped or zero
    entry changes nothing)."""
    size = row.shape[0]
    ok = keep & (idx >= 0) & (idx < size)
    row.scatter_reduce_(0, torch.clamp(idx, 0, size - 1).to(torch.int64),
                        torch.where(ok, vals, 0), "amax")
    return row


def ground_truth(cfg: LogConfig, inj: tuple, fault, n: int,
                 origin: int) -> torch.Tensor:
    """The merged row ``[S]`` every eventually-alive node must reach:
    the applied sends at their offsets, and per key the max clamped
    commit."""
    s_val, c_key = inj[3], inj[5]
    dev = s_val.device
    applied_s, slot, _, applied_c, cval = _send_plan(cfg, inj, fault, n,
                                                     origin)
    kc = cfg.keys * cfg.capacity
    ent = _scatter_max(torch.zeros(kc, dtype=torch.int32, device=dev),
                       slot, s_val, applied_s)
    com = _scatter_max(torch.zeros(cfg.keys, dtype=torch.int32, device=dev),
                       c_key, cval, applied_c)
    return torch.cat([ent, com])


def _fired(cfg, inj, round_, n, origin, fault):
    """(send rows, send cols, send values, commit rows, commit cols,
    commit values, send fire, commit fire) of this round."""
    r = int(round_)
    s_node, _, s_round, s_val = inj[:4]
    c_node, c_key, c_round, _ = inj[4:]
    applied_s, slot, _, applied_c, cval = _send_plan(cfg, inj, fault, n,
                                                     origin)
    return (s_node, slot, s_val, (s_round == r) & applied_s,
            c_node, cfg.keys * cfg.capacity + c_key, cval,
            (c_round == r) & applied_c)


def apply_injections(cfg: LogConfig, val: torch.Tensor, inj: tuple,
                     round_, n: int, origin: int, fault,
                     lo: int = 0) -> torch.Tensor:
    """``val`` with this round's applied sends and commits max-merged
    into the appenders' and committers' rows, IN PLACE (the reference's
    ``inject_rows`` merged into the state, without its dense rows).
    ``val`` holds the rows of the global ids ``[lo, lo + len(val))``
    (:func:`~gossip_tpu_torch.ops.crdt.apply_injections`)."""
    s_node, slot, s_val, fire_s, c_node, c_col, cval, fire_c = _fired(
        cfg, inj, round_, n, origin, fault)
    nl, s = val.shape
    flat = val.view(-1)
    for rows, cols, vals, fire in ((s_node, slot, s_val, fire_s),
                                   (c_node, c_col, cval, fire_c)):
        rows = rows.to(torch.int64) - lo
        ok = fire & (cols >= 0) & (cols < s) & (rows >= 0) & (rows < nl)
        idx = (torch.clamp(rows, 0, nl - 1) * s
               + torch.clamp(cols, 0, s - 1))
        flat.scatter_reduce_(0, idx, torch.where(ok, vals, 0), "amax")
    return val


# -- readouts ----------------------------------------------------------

def log_len(cfg: LogConfig, rows: torch.Tensor) -> torch.Tensor:
    """int32[..., K]: the contiguous filled-prefix length of each key's
    log (polls serve the gapless prefix)."""
    ent = rows[..., :cfg.keys * cfg.capacity]
    filled = (ent.reshape(ent.shape[:-1] + (cfg.keys, cfg.capacity)) != 0)
    return torch.cumprod(filled.to(torch.int32), dim=-1).sum(
        dim=-1, dtype=torch.int32)


def committed_of(cfg: LogConfig, rows: torch.Tensor) -> torch.Tensor:
    """int32[..., K]: the committed-count columns."""
    return rows[..., cfg.keys * cfg.capacity:]


def payload_count(cfg: LogConfig, rows: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """int64 0-d: filled entry slots plus committed counts over alive
    rows, exact and with no host read (equal to the reference's float32
    sum while the mass stays below 2^24, as
    :func:`~gossip_tpu_torch.ops.crdt.payload_count`)."""
    a = alive[:, None]
    filled = ((rows[:, :cfg.keys * cfg.capacity] != 0) & a).sum()
    return filled + torch.where(a, committed_of(cfg, rows).to(torch.int64),
                                0).sum()


def truth_summary(cfg: LogConfig, truth: torch.Tensor) -> dict:
    """Per-key acked lengths and committed counts, for reports."""
    truth = truth.detach().cpu()
    ent = truth[:cfg.keys * cfg.capacity].reshape(cfg.keys, cfg.capacity)
    lens = [int(torch.cumprod((row != 0).to(torch.int64), 0).sum())
            for row in ent]
    committed = [int(c) for c in truth[cfg.keys * cfg.capacity:]]
    return {"lens": lens, "committed": committed,
            "total_entries": int(sum(lens))}
