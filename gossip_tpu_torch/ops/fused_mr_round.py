"""The fused multi-rumor pull round and its run loops, on a GPU.

The port of the JAX package's ``ops/pallas_round.py`` (multi-rumor half).
Layout: one 32-bit word per node, bit ``r`` of node ``v``'s word is
rumor ``r`` (up to 32 rumors); node ``v`` sits at row ``v >> 7``, lane
``v & 127`` of an ``[R, 128]`` table, ``R = mr_rows(n)``.  Words of node
ids ``>= n`` (phantoms) are kept zero every round.  The representation is
the single-rumor module's: an int32 tensor holding the reference's uint32
bits, and :class:`~gossip_tpu_torch.ops.fused_round.FusedState` carries
it across rounds.

One round: for every fanout draw ``f``, node ``(i, j)`` takes the draw
word ``rb`` and lane ``m = rb & 127``, and pulls the whole word of
partner ``src[(i - s_m) mod R, m]``, where ``s_m`` is lane ``m``'s row
shift of draw ``f`` and ``src = table & alive`` is the PRE-round table
(every draw reads it while the accumulator grows).  The pulled word is
dropped when ``rb >> 12`` is below the 20-bit drop threshold, kept only
when the partner's cut word equals the node's own, ANDed with the node's
alive word and ORed in.  Random bits come from the port's multi-rumor
Philox stream (:mod:`gossip_tpu_torch.ops.philox`) or are injected in
the reference's ``inject_bits`` layout: ``sbits [F, 8, 128]`` (row 0
used), ``rbits [F, R, 128]``.

Two routes compute that function, bit for bit:

* **value** (the reference's ``_fused_mr_kernel``): one launch of
  ``csrc/fused_mr_round.cu`` per round, partners read by address
  arithmetic.  :func:`fused_multirumor_pull_round` and the run loops
  take it at every size: on an H100 it was faster than the staged route
  at every measured size (10M and 1M nodes x 32 rumors, fanout 1 and 2;
  ``chip_smoke.py``'s ``mr_routes`` phase, times in PERF.md), and it
  holds half the tables;
* **staged** (the reference's ``_fused_mr_round_big``): per fanout draw,
  the rotation :func:`rotate_rows` in plain torch, then one launch of
  ``csrc/mr_gather.cu``.  :func:`fused_mr_round_big` runs one such round;
  the tests and ``chip_smoke.py`` drive it.

On a CUDA tensor each route launches its kernel; on a CPU tensor it runs
the plain version (:func:`fused_mr_round_plain`, :func:`mr_gather_plain`).
Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops.common import (MASK32, bit_tensor, f32_fraction,
                                         from_words, resolve_device,
                                         to_words)
from gossip_tpu_torch.ops.fused_round import (BITS, LANES, FusedState,
                                              drop_threshold_for, n_rows)


def mr_rows(n: int) -> int:
    """Rows (a multiple of 8, as the reference's layout) covering n nodes
    at one word per node."""
    r = -(-n // LANES)
    return max(8, -(-r // 8) * 8)


def _check_rumors(rumors: int):
    if not 1 <= rumors <= BITS:
        raise ValueError(f"the multi-rumor table holds 1 to {BITS} rumors "
                         f"per word; got {rumors}")


def word_pack(seen: torch.Tensor) -> torch.Tensor:
    """bool[n, r <= 32] -> int32[mr_rows(n), 128] one-word-per-node
    table."""
    n, r = seen.shape
    _check_rumors(r)
    weights = 1 << torch.arange(r, dtype=torch.int64, device=seen.device)
    flat = torch.zeros(mr_rows(n) * LANES, dtype=torch.int64,
                       device=seen.device)
    flat[:n] = (seen.to(torch.int64) * weights).sum(dim=1)
    return from_words(flat).reshape(-1, LANES)


def word_unpack(table: torch.Tensor, n: int, rumors: int) -> torch.Tensor:
    """int32[R, 128] -> bool[n, rumors]."""
    flat = to_words(table).reshape(-1)[:n]
    shifts = torch.arange(rumors, dtype=torch.int64, device=table.device)
    return ((flat[:, None] >> shifts) & 1).to(torch.bool)


def rumor_counts(table: torch.Tensor, rumors: int) -> torch.Tensor:
    """int64[rumors]: how many words have bit r set, for each rumor r
    (exact integers; the kernels' fused counters hold the same)."""
    masks = np.left_shift(np.uint32(1), np.arange(rumors, dtype=np.uint32))
    return torch.stack([torch.count_nonzero(table & int(m))
                        for m in masks.view(np.int32)])


def coverage_words(table: torch.Tensor, n: int, rumors: int) -> float:
    """Min-over-rumors infected fraction, ``float32(min count) /
    float32(n)`` (phantom words stay zero).  The reference sums the bits
    in float32, which is exact below 2^24 nodes; the port counts in
    integers."""
    return f32_fraction(int(rumor_counts(table, rumors).min()), n)


def coverage_words_alive(table: torch.Tensor, alive_words: torch.Tensor,
                         rumors: int) -> float:
    """Alive-weighted min-over-rumors fraction (alive words are
    0xFFFFFFFF or 0, so bit 0 counts the alive nodes)."""
    n_alive = int((to_words(alive_words) & 1).sum())
    return min(f32_fraction(int(c), n_alive)
               for c in rumor_counts(table & alive_words, rumors).tolist())


def render_alive_words(alive: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n] -> int32[mr_rows(n), 128]: 0xFFFFFFFF for alive nodes, 0
    for dead and phantom ones."""
    flat = torch.zeros(mr_rows(n) * LANES, dtype=torch.int32,
                       device=alive.device)
    flat[:n] = torch.where(alive, -1, 0).to(torch.int32)
    return flat.reshape(-1, LANES)


def render_cut_words(cut, n: int, device=None) -> torch.Tensor:
    """Partition side mask, one word per node: 0xFFFFFFFF for real nodes
    at or above the cut, 0 below (and for phantoms)."""
    ids = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return render_alive_words(ids >= int(cut), n)


def fused_table_bytes(n: int, rumors: int) -> int:
    """Bytes of one table for this (n, rumors)."""
    rows = n_rows(n) if rumors == 1 else mr_rows(n)
    return rows * LANES * 4


def init_multirumor_state(n: int, rumors: int, origin: int = 0,
                          device=None) -> FusedState:
    """Round 0: rumor r starts at node ``(origin + r) % n``, on
    ``device`` (default CUDA)."""
    _check_rumors(rumors)
    words = {}
    for r in range(rumors):
        node = (origin + r) % n
        words[node] = words.get(node, 0) | 1 << r
    dev = resolve_device(device)
    flat = torch.zeros(mr_rows(n) * LANES, dtype=torch.int32, device=dev)
    flat[torch.tensor(list(words), device=dev)] = from_words(
        torch.tensor(list(words.values()))).to(dev)
    return FusedState(table=flat.reshape(-1, LANES), round=0,
                      msgs=np.float32(0.0))


def draw_mr_round_bits(seed: int, round_: int, rows: int, fanout: int = 1,
                       device=None):
    """The port's multi-rumor Philox bits of one round in the reference's
    ``inject_bits`` layout: ``(sbits int32[F, 8, 128], rbits
    int32[F, rows, 128])``.  Only row 0 of each ``sbits[f]`` is used."""
    k0, k1 = philox.round_key(seed, round_, philox.MR_SALT)
    sbits = torch.zeros(fanout, 8, LANES, dtype=torch.int64, device=device)
    sbits[:, 0] = philox.shift_words(k0, k1, fanout, device)
    rbits = philox.draw_words(k0, k1, rows, fanout, device)
    return from_words(sbits), from_words(rbits)


def _node_keep(rows: int, n: int, device) -> torch.Tensor:
    return torch.arange(rows * LANES, device=device).reshape(rows, LANES) < n


def fused_mr_round_plain(table: torch.Tensor, seed, round_, n: int,
                         fanout: int = 1, inject_bits=None,
                         drop_threshold=0, alive_words=None,
                         cut_words=None) -> torch.Tensor:
    """One round in plain torch: the reference's ``_fused_mr_round_ref``
    with the partner word taken by address arithmetic in place of the
    rotation's rolls.  Without ``inject_bits`` it draws the port's Philox
    stream (:func:`draw_mr_round_bits`)."""
    rows = table.shape[0]
    dev = table.device
    if inject_bits is None:
        inject_bits = draw_mr_round_bits(seed, round_, rows, fanout, dev)
    sbits, rbits = (to_words(bit_tensor(b, dev)) for b in inject_bits)
    t = to_words(table)
    alive = to_words(alive_words) if alive_words is not None else None
    cut = to_words(cut_words) if cut_words is not None else None
    thr = int(drop_threshold) & MASK32
    src = t & alive if alive is not None else t
    row = torch.arange(rows, device=dev)[:, None]

    acc = t
    for f in range(fanout):
        s = sbits[f, 0] % rows
        rb = rbits[f]
        m = rb & (LANES - 1)
        prow = (row - s[m]) % rows         # partner src[(i - s_m) mod R, m]
        partner = torch.where((rb >> 12) >= thr, src[prow, m], 0)
        if cut is not None:
            partner = torch.where(cut[prow, m] == cut, partner, 0)
        if alive is not None:
            partner = partner & alive
        acc = acc | partner
    return from_words(torch.where(_node_keep(rows, n, dev), acc, 0))


def rotate_rows(table: torch.Tensor, shift_words: torch.Tensor):
    """``rot[i, j] = table[(i - s_j) mod R, j]`` with ``s_j =
    shift_words[j] mod R`` (the 32-bit word read unsigned): the
    reference's ``_rotate_rows_xla``, by index arithmetic.  The first
    stage of the staged route, plain torch on either device."""
    rows = table.shape[0]
    s = to_words(shift_words) % rows
    idx = (torch.arange(rows, device=table.device)[:, None] - s) % rows
    return torch.gather(table, 0, idx)


def mr_gather_plain(tin: torch.Tensor, rot: torch.Tensor,
                    rbits: torch.Tensor, n: int, drop_threshold=0,
                    alive_words=None, rot_cut=None,
                    cut_words=None) -> torch.Tensor:
    """One pass of the staged round in plain torch: the reference's
    ``_mr_gather_kernel`` (its whole-table twin in
    ``_fused_mr_round_big``) on this draw's bits ``rbits[R, 128]``."""
    rb = to_words(rbits)
    m = rb & (LANES - 1)
    thr = int(drop_threshold) & MASK32
    partner = torch.where((rb >> 12) >= thr,
                          torch.gather(to_words(rot), 1, m), 0)
    if cut_words is not None:
        partner = torch.where(torch.gather(to_words(rot_cut), 1, m)
                              == to_words(cut_words), partner, 0)
    if alive_words is not None:
        partner = partner & to_words(alive_words)
    keep = _node_keep(tin.shape[0], n, tin.device)
    return from_words(torch.where(keep, to_words(tin) | partner, 0))


def _finish_plain(new, rumors, out, pop):
    """A plain round's result delivered as a kernel delivers it: its
    per-rumor counts added to ``pop``, written to ``out`` when given."""
    if pop is not None:
        pop[:rumors] += rumor_counts(new, rumors).to(pop.dtype)
    return new if out is None else out.copy_(new)


def mr_gather(tin, rot, n: int, f: int, key, drop_threshold=0,
              rumors: int = BITS, rbits=None, alive_words=None,
              rot_cut=None, cut_words=None, out=None, pop=None):
    """Fanout draw ``f`` of the staged round: ``tin | partner`` from the
    pre-rotated ``rot``, on round key ``key``'s stream or on this draw's
    injected ``rbits``.  ``out`` may be ``tin``.  A CUDA tensor launches
    ``csrc/mr_gather.cu``, a CPU tensor runs :func:`mr_gather_plain`."""
    if tin.device.type == "cuda":
        return _kernels.mr_gather(
            tin, rot, n, f, key, int(drop_threshold), rumors, rbits=rbits,
            alive_words=alive_words, rot_cut=rot_cut, cut_words=cut_words,
            out=out, pop=pop)
    if tin.device.type != "cpu":
        raise ValueError(f"no multi-rumor gather for a {tin.device.type} "
                         "tensor; the port runs on cuda or cpu")
    if rbits is None:
        rbits = philox.draw_words(*key, tin.shape[0], f + 1, tin.device)[f]
    new = mr_gather_plain(tin, rot, rbits, n, drop_threshold, alive_words,
                          rot_cut, cut_words)
    return _finish_plain(new, rumors, out, pop)


def fused_mr_round_big(table: torch.Tensor, seed, round_, n: int,
                       fanout: int = 1, inject_bits=None, drop_threshold=0,
                       alive_words=None, cut_words=None, rumors: int = BITS,
                       out: Optional[torch.Tensor] = None,
                       pop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round through the staged route: for each fanout draw, rotate
    the pre-round ``table & alive`` (and the cut words) by that draw's
    lane shifts in plain torch, then one :func:`mr_gather` pass into the
    accumulator (passes ``f >= 1`` in place).  ``out`` (never ``table``,
    whose rotation later passes still read) and ``pop`` (int32[32], the
    last pass adds the per-rumor counts) as in
    :func:`fused_multirumor_pull_round`."""
    _check_round_args(table, n, fanout, rumors, out)
    dev = table.device
    key = philox.round_key(seed, round_, philox.MR_SALT)
    if inject_bits is not None:
        sbits, rbits = (bit_tensor(b, dev) for b in inject_bits)
        shift_words = sbits[:, 0]
    else:
        rbits = None
        shift_words = philox.shift_words(*key, fanout, dev)
    src = table & alive_words if alive_words is not None else table
    acc = table
    for f in range(fanout):
        rot = rotate_rows(src, shift_words[f])
        rot_cut = (rotate_rows(cut_words, shift_words[f])
                   if cut_words is not None else None)
        acc = mr_gather(acc, rot, n, f, key, drop_threshold, rumors,
                        rbits=None if rbits is None else rbits[f],
                        alive_words=alive_words, rot_cut=rot_cut,
                        cut_words=cut_words, out=out,
                        pop=pop if f == fanout - 1 else None)
        out = acc
    return acc


def _check_round_args(table, n, fanout, rumors, out):
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != LANES:
        raise ValueError(f"table must be int32[R, {LANES}], got "
                         f"{table.dtype}{list(table.shape)}")
    if not 0 < n <= table.shape[0] * LANES:
        raise ValueError(f"n={n} does not fit a table of "
                         f"{table.shape[0]} rows")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    _check_rumors(rumors)
    if out is not None and out.data_ptr() == table.data_ptr():
        raise ValueError("out must not be the input table: the round "
                         "reads the pre-round table while it writes")


def check_fused_fits(n: int, rumors: int, device) -> int:
    """Raise ValueError when the card's memory cannot hold a run's tables
    (two table buffers and the alive and cut words); return one table's
    size in bytes.  On the CPU nothing is refused."""
    tb = fused_table_bytes(n, rumors)
    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        if 4 * tb > total:
            raise ValueError(
                f"a run holds {4 * tb} bytes of tables at n={n}, "
                f"rumors={rumors}; {torch.cuda.get_device_name(dev)} has "
                f"{total}")
    return tb


def fused_multirumor_pull_round(table: torch.Tensor, seed, round_, n: int,
                                fanout: int = 1, inject_bits=None,
                                drop_threshold=0, alive_words=None,
                                cut_words=None, rumors: int = BITS,
                                out: Optional[torch.Tensor] = None,
                                pop: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Apply one fused pull round to a one-word-per-node table, through
    the value route (the module doc says why no size takes the staged
    one).

    The reference's ``fused_multirumor_pull_round`` with the additions of
    :func:`~gossip_tpu_torch.ops.fused_round.fused_pull_round`: ``out``
    is the buffer the round writes (never ``table``; allocated when
    None) and ``pop``, an int32[32] tensor, gets the count of each of the
    first ``rumors`` bits of the new table added.  A CUDA table launches
    ``csrc/fused_mr_round.cu``, a CPU table runs
    :func:`fused_mr_round_plain`."""
    _check_round_args(table, n, fanout, rumors, out)
    if table.device.type == "cuda":
        if inject_bits is not None:
            inject_bits = tuple(bit_tensor(b, table.device)
                                for b in inject_bits)
        return _kernels.fused_mr_round(
            table, n, fanout, philox.round_key(seed, round_, philox.MR_SALT),
            int(drop_threshold), rumors, inject_bits=inject_bits,
            alive_words=alive_words, cut_words=cut_words, out=out, pop=pop)
    if table.device.type != "cpu":
        raise ValueError(f"no fused round for a {table.device.type} "
                         "tensor; the port runs on cuda or cpu")
    new = fused_mr_round_plain(table, seed, round_, n, fanout, inject_bits,
                               drop_threshold, alive_words, cut_words)
    return _finish_plain(new, rumors, out, pop)


def fault_masks_word(fault, n: int, origin: int = 0, device=None):
    """(alive_words or None, drop_threshold): the one-word-per-node
    rendering of the static dead set (``models/state.alive_mask``) and
    the 20-bit drop threshold."""
    from gossip_tpu_torch.models.state import alive_mask
    alive = alive_mask(fault, n, origin, resolve_device(device))
    return (None if alive is None else render_alive_words(alive, n),
            drop_threshold_for(fault))


def fused_mr_cov_fn(n: int, rumors: int, fault=None, alive_words=None):
    """``table -> coverage`` for a multi-rumor run: alive-weighted over
    ``alive_words`` exactly when the fault draws deaths."""
    if fault is None or not fault.node_death_rate:
        return lambda t: coverage_words(t, n, rumors)
    if alive_words is None:
        raise ValueError("a run with deaths needs its alive words")
    return lambda t: coverage_words_alive(t, alive_words, rumors)


def _alive_offsets(table, rumors: int, n: int, alive_words):
    """``(total, dead)``: the coverage's denominator, and per rumor the
    bits ``table`` holds at dead nodes.  Dead nodes receive nothing, so
    those bits stay as they are for the whole run, and a round's
    alive-weighted counts are the kernel's counters less them."""
    if alive_words is None:
        return n, [0] * rumors
    return (int((to_words(alive_words) & 1).sum()),
            rumor_counts(table & ~alive_words, rumors).tolist())


def _min_fraction(counts, rumors: int, total: int, dead) -> float:
    """The stop test's coverage from one round's int32[32] counter."""
    return f32_fraction(min(c - d for c, d in zip(counts[:rumors], dead)),
                        total)


def _advance(state: FusedState, n: int, rumors: int, seed: int,
             fanout: int, drop_threshold: int, alive_words, spare, pop):
    """One round of a run loop into ``spare``, its per-rumor counts into
    ``pop``, and ``2*fanout*n`` messages added in float32."""
    table = fused_multirumor_pull_round(
        state.table, seed, state.round, n, fanout,
        drop_threshold=drop_threshold, alive_words=alive_words,
        rumors=rumors, out=spare, pop=pop)
    return FusedState(table=table, round=state.round + 1,
                      msgs=np.float32(state.msgs
                                      + np.float32(2.0 * fanout * n)))


def until_fused_multirumor(n: int, rumors: int, seed: int, fanout: int = 1,
                           target_coverage: float = 0.99,
                           max_rounds: int = 128, origin: int = 0,
                           fault=None, device=None,
                           state: Optional[FusedState] = None):
    """Run rounds until the float32 min-over-rumors coverage reaches
    ``target_coverage`` or the round counter reaches ``max_rounds``: the
    exit state of the reference's ``compiled_until_fused_multirumor``.
    Returns ``(state, coverage)``.  It starts from ``state`` (whose table
    buffer it reuses) or a fresh state at ``origin``.  Each round's kernel
    adds its per-rumor counts to that round's int32[32] device counter,
    which the loop reads once per round.  The first stop test needs the
    starting table's counts: a fresh state holds every rumor at exactly
    one node, so its coverage is ``float32(1) / float32(n)``; a given
    state is counted (:func:`rumor_counts`, milliseconds at 10M nodes).
    Under deaths the round takes the alive words
    (:func:`fault_masks_word`) and the stop test is the alive-weighted
    coverage of the new table, read from the same counter
    (:func:`_alive_offsets`)."""
    dev = resolve_device(device)
    alive, thr = fault_masks_word(fault, n, origin, dev)
    st = (state if state is not None
          else init_multirumor_state(n, rumors, origin, dev))
    cov = (f32_fraction(1, n) if state is None and alive is None
           else fused_mr_cov_fn(n, rumors, fault, alive)(st.table))
    total, dead = _alive_offsets(st.table, rumors, n, alive)
    target = np.float32(target_coverage)
    pops = torch.zeros(max(max_rounds - st.round, 1), BITS,
                       dtype=torch.int32, device=dev)
    spare = torch.empty_like(st.table)
    first = st.round
    while cov < target and st.round < max_rounds:
        slot = pops[st.round - first]
        nxt = _advance(st, n, rumors, seed, fanout, thr, alive, spare, slot)
        spare = st.table
        st = nxt
        cov = _min_fraction(slot.tolist(), rumors, total, dead)
    return st, cov


def curve_fused_multirumor(n: int, rumors: int, seed: int, fanout: int = 1,
                           max_rounds: int = 128, origin: int = 0,
                           fault=None, device=None):
    """Run exactly ``max_rounds`` rounds from a fresh state and record
    the min-over-rumors coverage after each: the reference's
    ``compiled_curve_fused_multirumor`` scan.  Returns ``(state,
    [coverage per round])``; the counters are read once, at the end."""
    dev = resolve_device(device)
    alive, thr = fault_masks_word(fault, n, origin, dev)
    st = init_multirumor_state(n, rumors, origin, dev)
    pops = torch.zeros(max_rounds, BITS, dtype=torch.int32, device=dev)
    spare = torch.empty_like(st.table)
    # under deaths a rumor may start at a dead node (only the origin is
    # pinned alive), whose bit the kernel's counters include
    total, dead = _alive_offsets(st.table, rumors, n, alive)
    for r in range(max_rounds):
        nxt = _advance(st, n, rumors, seed, fanout, thr, alive, spare,
                       pops[r])
        spare = st.table
        st = nxt
    return st, [_min_fraction(c, rumors, total, dead)
                for c in pops.cpu().tolist()]
