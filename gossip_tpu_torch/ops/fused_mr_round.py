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
  ``csrc/fused_mr_round.cu`` per round on a **lane-major** table
  ``int32[128, R]`` (word ``(i, j)`` at ``[j, i]``), where lane ``m``'s
  partners of a block of destination rows are one contiguous run
  (:func:`fused_mr_round_lanes`, whose plain version is
  :func:`fused_mr_round_lanes_plain`).  The run loops transpose the
  table once on entry, keep both ping-pong buffers lane-major, and
  transpose back once on exit, so :class:`FusedState` stays ``[R, 128]``;
  :func:`fused_multirumor_pull_round` keeps the reference's layout and,
  on the card, transposes around one launch.  The loops take this route
  at every size: on an H100 it was faster than the staged route at
  every measured size (10M and 1M nodes x 32 rumors, fanout 1 and 2;
  ``chip_smoke.py``'s ``mr_routes`` phase, times in PERF.md), and it
  holds half the tables;
* **staged** (the reference's ``_fused_mr_round_big``): per fanout draw,
  the rotation :func:`rotate_rows` in plain torch, then one launch of
  ``csrc/mr_gather.cu``.  :func:`fused_mr_round_big` runs one such round;
  the tests and ``chip_smoke.py`` drive it.

On a CUDA tensor each route launches its kernel; on a CPU tensor it runs
the plain version (:func:`fused_mr_round_lanes_plain` in the loops,
:func:`fused_mr_round_plain` in the public round, :func:`mr_gather_plain`).
Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops.common import (MASK32, bit_tensor, f32_fraction,
                                         f32_mean, from_words,
                                         resolve_device, to_words)
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


def to_lanes(table: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``[R, 128]`` -> the lane-major ``[128, R]`` copy (None stays None)."""
    return None if table is None else table.t().contiguous()


def from_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """Lane-major ``[128, R]`` -> the reference's ``[R, 128]`` layout."""
    return lanes.t().contiguous()


def lanes_bits(inject_bits, device):
    """Injected bits in the reference's layout -> the lane-major kernel's:
    ``sbits`` as it is, each draw's ``rbits[f]`` transposed."""
    sbits, rbits = (bit_tensor(b, device) for b in inject_bits)
    return sbits, rbits.transpose(1, 2).contiguous()


def fused_mr_round_lanes_plain(lanes: torch.Tensor, seed, round_, n: int,
                               fanout: int = 1, inject_bits=None,
                               drop_threshold=0, alive_lanes=None,
                               cut_lanes=None) -> torch.Tensor:
    """One round in plain torch on a lane-major table ``int32[128, R]``
    (``lanes[j, i]`` is node ``i * 128 + j``), with ``alive_lanes`` and
    ``cut_lanes`` lane-major too and ``inject_bits`` in the lane-major
    kernel's layout (``sbits [F, 8, 128]``, ``rbits [F, 128, R]``).  For
    each draw, each lane's row of ``src = lanes & alive`` is rolled by
    its shift (``rot[m] = src[m].roll(s_m)``, so ``rot[m][i] =
    src[m][(i - s_m) mod R]``), and node ``(i, j)`` takes ``rot[m][i]``,
    ``m`` its draw's lane, under the coin, cut and alive masks; phantom
    nodes are zeroed.  Without ``inject_bits`` it draws the port's
    multi-rumor Philox stream."""
    rows = lanes.shape[1]
    dev = lanes.device
    if inject_bits is None:
        inject_bits = lanes_bits(draw_mr_round_bits(seed, round_, rows,
                                                    fanout, dev), dev)
    sbits, rbits = (to_words(bit_tensor(b, dev)) for b in inject_bits)
    t = to_words(lanes)
    alive = to_words(alive_lanes) if alive_lanes is not None else None
    cut = to_words(cut_lanes) if cut_lanes is not None else None
    thr = int(drop_threshold) & MASK32
    src = t & alive if alive is not None else t

    def rolled(x, s):
        return torch.stack([x[m].roll(int(s[m])) for m in range(LANES)])

    acc = t
    for f in range(fanout):
        s = sbits[f, 0] % rows
        rb = rbits[f]
        m = rb & (LANES - 1)
        partner = torch.where((rb >> 12) >= thr,
                              torch.gather(rolled(src, s), 0, m), 0)
        if cut is not None:
            partner = torch.where(
                torch.gather(rolled(cut, s), 0, m) == cut, partner, 0)
        if alive is not None:
            partner = partner & alive
        acc = acc | partner
    node = (torch.arange(rows, device=dev)[None, :] * LANES
            + torch.arange(LANES, device=dev)[:, None])
    return from_words(torch.where(node < n, acc, 0))


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


def _check_round_args(table, n, fanout, rumors, out, lane_major=False):
    lanes_dim = 0 if lane_major else 1
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[lanes_dim] != LANES:
        want = f"[{LANES}, R]" if lane_major else f"[R, {LANES}]"
        raise ValueError(f"table must be int32{want}, got "
                         f"{table.dtype}{list(table.shape)}")
    rows = table.shape[1 - lanes_dim]
    if not 0 < n <= rows * LANES:
        raise ValueError(f"n={n} does not fit a table of {rows} rows")
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
    :func:`fused_mr_round_plain`.  On the card it transposes the table,
    the alive and cut words and the injected bits to the kernel's
    lane-major layout and the result back, around one launch: that is
    for checks; the run loops keep their tables lane-major
    (:func:`fused_mr_round_lanes`)."""
    _check_round_args(table, n, fanout, rumors, out)
    if table.device.type == "cuda":
        new = from_lanes(fused_mr_round_lanes(
            to_lanes(table), seed, round_, n, fanout,
            None if inject_bits is None
            else lanes_bits(inject_bits, table.device),
            drop_threshold, to_lanes(alive_words), to_lanes(cut_words),
            rumors, pop=pop))
        return new if out is None else out.copy_(new)
    if table.device.type != "cpu":
        raise ValueError(f"no fused round for a {table.device.type} "
                         "tensor; the port runs on cuda or cpu")
    new = fused_mr_round_plain(table, seed, round_, n, fanout, inject_bits,
                               drop_threshold, alive_words, cut_words)
    return _finish_plain(new, rumors, out, pop)


def fused_mr_round_lanes(lanes: torch.Tensor, seed, round_, n: int,
                         fanout: int = 1, inject_bits=None,
                         drop_threshold=0, alive_lanes=None, cut_lanes=None,
                         rumors: int = BITS,
                         out: Optional[torch.Tensor] = None,
                         pop: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One round on a lane-major table ``int32[128, R]`` (operands and
    injected bits lane-major as in :func:`fused_mr_round_lanes_plain`),
    what the run loops launch: ``out`` and ``pop`` as in
    :func:`fused_multirumor_pull_round`.  A CUDA table launches
    ``csrc/fused_mr_round.cu``, a CPU table runs
    :func:`fused_mr_round_lanes_plain`."""
    _check_round_args(lanes, n, fanout, rumors, out, lane_major=True)
    if lanes.device.type == "cuda":
        if inject_bits is not None:
            inject_bits = tuple(bit_tensor(b, lanes.device)
                                for b in inject_bits)
        return _kernels.fused_mr_round(
            lanes, n, fanout, philox.round_key(seed, round_, philox.MR_SALT),
            int(drop_threshold), rumors, inject_bits=inject_bits,
            alive_lanes=alive_lanes, cut_lanes=cut_lanes, out=out, pop=pop)
    if lanes.device.type != "cpu":
        raise ValueError(f"no fused round for a {lanes.device.type} "
                         "tensor; the port runs on cuda or cpu")
    new = fused_mr_round_lanes_plain(lanes, seed, round_, n, fanout,
                                     inject_bits, drop_threshold,
                                     alive_lanes, cut_lanes)
    return _finish_plain(new, rumors, out, pop)


def fault_masks_word(fault, n: int, origin: int = 0, device=None):
    """(alive_words or None, drop_threshold): the one-word-per-node
    rendering of the static dead set (``models/state.alive_mask``) and
    the 20-bit drop threshold.  A liar program is refused."""
    from gossip_tpu_torch.models.state import alive_mask
    from gossip_tpu_torch.ops.nemesis import check_supported
    check_supported(fault, engine="fused")
    alive = alive_mask(fault, n, origin, resolve_device(device))
    return (None if alive is None else render_alive_words(alive, n),
            drop_threshold_for(fault))


def loop_coverage_words(n: int, rumors: int, alive_words, start):
    """``counts -> coverage`` as the reference's compiled loops compute
    it, where ``counts`` are per-rumor bit counts of a table of the run
    that starts at ``start``: the minimum over the first ``rumors``.
    Without deaths ``float32(min) * float32(1 / n)``
    (:func:`~gossip_tpu_torch.ops.common.f32_mean`: XLA folds the
    division by the static ``n``), one ulp from the eager
    :func:`coverage_words` for some counts.  Under deaths the
    alive-weighted quotient of each count less the bits ``start`` holds
    at dead nodes: dead nodes receive nothing, so those bits stay as they
    are for the whole run."""
    if alive_words is None:
        return lambda counts: f32_mean(min(counts[:rumors]), n)
    total = int((to_words(alive_words) & 1).sum())
    dead = rumor_counts(start & ~alive_words, rumors).tolist()
    return lambda counts: f32_fraction(
        min(c - d for c, d in zip(counts[:rumors], dead)), total)


def _msgs_after(msgs, fanout: int, n: int):
    """A round's ``2*fanout*n`` messages added in float32 (the reference
    adds a weakly typed float to its float32 total)."""
    return np.float32(msgs + np.float32(2.0 * fanout * n))


def until_fused_multirumor(n: int, rumors: int, seed: int, fanout: int = 1,
                           target_coverage: float = 0.99,
                           max_rounds: int = 128, origin: int = 0,
                           fault=None, device=None,
                           state: Optional[FusedState] = None):
    """Run rounds until the float32 min-over-rumors coverage reaches
    ``target_coverage`` or the round counter reaches ``max_rounds``: the
    exit state of the reference's ``compiled_until_fused_multirumor``.
    Returns ``(state, coverage)``.  It starts from ``state`` or a fresh
    state at ``origin``, transposes the table to two lane-major buffers
    for the rounds (:func:`fused_mr_round_lanes`) and back at the end.
    Each round's kernel adds its per-rumor counts to that round's
    int32[32] device counter, which the loop reads once per round; the
    stop test is the compiled loop's (:func:`loop_coverage_words`).  The
    first stop test needs the starting table's counts: a fresh state holds
    every rumor at exactly one node; a given state is counted
    (:func:`rumor_counts`, milliseconds at 10M nodes).  Under deaths the
    round takes the alive words (:func:`fault_masks_word`)."""
    dev = resolve_device(device)
    alive, thr = fault_masks_word(fault, n, origin, dev)
    st = (state if state is not None
          else init_multirumor_state(n, rumors, origin, dev))
    cov_of = loop_coverage_words(n, rumors, alive, st.table)
    cov = cov_of([1] * rumors if state is None and alive is None
                 else rumor_counts(st.table, rumors).tolist())
    target = np.float32(target_coverage)
    pops = torch.zeros(max(max_rounds - st.round, 1), BITS,
                       dtype=torch.int32, device=dev)
    lanes, alive_lanes = to_lanes(st.table), to_lanes(alive)
    spare = torch.empty_like(lanes)
    rnd, msgs = st.round, st.msgs
    while cov < target and rnd < max_rounds:
        slot = pops[rnd - st.round]
        lanes, spare = fused_mr_round_lanes(
            lanes, seed, rnd, n, fanout, drop_threshold=thr,
            alive_lanes=alive_lanes, rumors=rumors, out=spare,
            pop=slot), lanes
        rnd, msgs = rnd + 1, _msgs_after(msgs, fanout, n)
        cov = cov_of(slot.tolist())
    return FusedState(table=from_lanes(lanes), round=rnd, msgs=msgs), cov


def curve_fused_multirumor(n: int, rumors: int, seed: int, fanout: int = 1,
                           max_rounds: int = 128, origin: int = 0,
                           fault=None, device=None):
    """Run exactly ``max_rounds`` rounds from a fresh state and record
    the min-over-rumors coverage after each, as the reference's
    ``compiled_curve_fused_multirumor`` scan computes it
    (:func:`loop_coverage_words`), on the lane-major buffers of
    :func:`until_fused_multirumor`.  Returns ``(state, [coverage per
    round])``; the counters are read once, at the end."""
    dev = resolve_device(device)
    alive, thr = fault_masks_word(fault, n, origin, dev)
    st = init_multirumor_state(n, rumors, origin, dev)
    pops = torch.zeros(max_rounds, BITS, dtype=torch.int32, device=dev)
    # under deaths a rumor may start at a dead node (only the origin is
    # pinned alive), whose bit the kernel's counters include
    cov_of = loop_coverage_words(n, rumors, alive, st.table)
    lanes, alive_lanes = to_lanes(st.table), to_lanes(alive)
    spare = torch.empty_like(lanes)
    msgs = st.msgs
    for r in range(max_rounds):
        lanes, spare = fused_mr_round_lanes(
            lanes, seed, r, n, fanout, drop_threshold=thr,
            alive_lanes=alive_lanes, rumors=rumors, out=spare,
            pop=pops[r]), lanes
        msgs = _msgs_after(msgs, fanout, n)
    return (FusedState(table=from_lanes(lanes), round=max_rounds, msgs=msgs),
            [cov_of(c) for c in pops.cpu().tolist()])
