"""The fused single-rumor pull round and its run loops, on a GPU.

The port of the JAX package's ``ops/pallas_round.py`` (single-rumor
half).  Layout: node ``n`` lives at bit ``n & 31`` of word ``n >> 5``;
words are stored row-major in an ``[R, 128]`` table, ``R = n_rows(n)``.
Phantom nodes (``n`` up to ``R * 4096``) are kept zero every round.

Representation: the table is a ``torch.int32`` tensor holding the bits of
the reference's ``uint32`` table (``np.uint32`` <-> ``.view(np.int32)``);
the CUDA kernel reads the buffer as ``uint32``.  The plain functions
compute in int64 holding values in ``[0, 2^32)``.

One round (:func:`fused_pull_round`): every node pulls ``fanout``
partners.  Destination word ``(i, j)`` takes, for draw ``d`` (bit plane
``k``, fanout draw ``f``), lane ``m = rb & 127`` and bit
``c = (rb >> 7) & 31`` of the draw word ``rb``; the partner word is
``src[(i - s_m) mod R, m]`` where ``s_m`` is lane ``m``'s row shift and
``src = table & alive``.  The pulled bit is dropped when ``rb >> 12`` is
below the 20-bit drop threshold, kept only when both endpoints share a
side of the partition cut, ANDed with the destination's alive bit, and
ORed into plane ``k``.  ``plane_sharing=2`` splits one draw's disjoint
12-bit fields across a plane pair.  Random bits come from the port's
Philox stream (:mod:`gossip_tpu_torch.ops.philox`) or are injected in
the reference's ``inject_bits`` layout.

On a CUDA tensor the round is the hand-written kernel
(``csrc/fused_round.cu`` through :mod:`gossip_tpu_torch.ops._kernels`);
on a CPU tensor it is :func:`fused_pull_round_plain`.  Nothing falls back
from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_tpu_torch.ops import _kernels, philox
from gossip_tpu_torch.ops.common import (bit_tensor, f32_fraction,
                                         f32_mean, from_words,
                                         resolve_device, to_words)

LANES = 128
BITS = 32
NODES_PER_ROW = LANES * BITS            # 4096 nodes per table row
MASK32 = philox.MASK32


def n_rows(n: int) -> int:
    """Rows (a multiple of 8, as the reference's layout) covering n nodes."""
    r = -(-n // NODES_PER_ROW)
    return max(8, -(-r // 8) * 8)


def padded_n(n: int) -> int:
    return n_rows(n) * NODES_PER_ROW


def node_pack(infected: torch.Tensor) -> torch.Tensor:
    """bool[N] -> node-packed int32[R, 128] table (phantoms zero)."""
    n = infected.shape[0]
    rows = n_rows(n)
    flat = torch.zeros(rows * NODES_PER_ROW, dtype=torch.int64,
                       device=infected.device)
    flat[:n] = infected.to(torch.int64)
    weights = torch.arange(BITS, dtype=torch.int64, device=infected.device)
    packed = (flat.reshape(rows * LANES, BITS) << weights).sum(dim=1)
    return from_words(packed).reshape(rows, LANES)


def node_unpack(table: torch.Tensor, n: int) -> torch.Tensor:
    """node-packed int32[R, 128] -> bool[n]."""
    shifts = torch.arange(BITS, dtype=torch.int64, device=table.device)
    bits = (to_words(table).reshape(-1, 1) >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def popcount(table: torch.Tensor) -> int:
    """Set bits in an int32 table (SWAR popcount on int64 words)."""
    x = to_words(table)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & MASK32) >> 24).sum().item())


def coverage_node_packed(table: torch.Tensor, n: int) -> float:
    """Infected fraction over the real n nodes (phantoms are kept zero)."""
    return f32_fraction(popcount(table), n)


def coverage_node_packed_alive(table: torch.Tensor,
                               alive_table: torch.Tensor) -> float:
    """Alive-weighted infected fraction (dead nodes are unreachable, not
    uninformed); phantoms are zero in both tables."""
    return f32_fraction(popcount(table & alive_table),
                        popcount(alive_table))


class FusedState(NamedTuple):
    table: torch.Tensor     # int32[R, 128], the node-packed bitmap's bits
    round: int
    msgs: np.float32        # request + digest accounting, float32 as in JAX


def init_fused_state(n: int, origin: int = 0, device=None) -> FusedState:
    """Round 0: only ``origin`` infected, on ``device`` (default CUDA)."""
    if not 0 <= origin < n:
        raise ValueError(f"origin {origin} out of range for n={n}")
    word = origin >> 5
    table = torch.zeros(n_rows(n) * LANES, dtype=torch.int64)
    table[word] = 1 << (origin & (BITS - 1))
    return FusedState(table=from_words(table).reshape(-1, LANES)
                      .to(resolve_device(device)),
                      round=0, msgs=np.float32(0.0))


def state_from_numpy(table_u32, round_, msgs, device=None) -> FusedState:
    """The port's state from the reference's ``FusedState`` as numpy
    arrays (``uint32[R, 128]`` table, int32 round, float32 msgs)."""
    table = np.ascontiguousarray(table_u32, dtype=np.uint32)
    if table.ndim != 2 or table.shape[1] != LANES:
        raise ValueError(f"table must be uint32[R, {LANES}], "
                         f"got shape {table.shape}")
    return FusedState(table=torch.from_numpy(table.view(np.int32).copy())
                      .to(resolve_device(device)),
                      round=int(round_), msgs=np.float32(msgs))


def state_to_numpy(state: FusedState):
    """(uint32[R, 128] table, int32 round, float32 msgs): the reference's
    ``FusedState`` fields as numpy values."""
    table = state.table.detach().cpu().contiguous().numpy().view(np.uint32)
    return table, np.int32(state.round), np.float32(state.msgs)


def drop_threshold_for(fault) -> int:
    """The 20-bit drop threshold, round(drop_prob * 2^20)."""
    drop_prob = 0.0 if fault is None else fault.drop_prob
    return int(round(drop_prob * (1 << 20))) if drop_prob else 0


def render_cut_bits(cut, n: int, device=None) -> torch.Tensor:
    """Partition side mask, node-packed: bit ``b`` of word ``w`` is 1 iff
    node ``32w + b`` sits at or above the cut (phantom bits 0)."""
    ids = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return node_pack(ids >= int(cut))


def fault_masks_node_packed(fault, n: int, origin: int = 0, device=None):
    """(alive_table or None, drop_threshold): the node-packed rendering
    of the static dead set (``models/state.alive_mask``, the threefry
    draw ``bernoulli(key(seed ^ 0x5157))`` with the origin pinned
    alive) and the 20-bit drop threshold.  A liar program is refused."""
    from gossip_tpu_torch.models.state import alive_mask
    from gossip_tpu_torch.ops.nemesis import check_supported
    check_supported(fault, engine="fused")
    alive = alive_mask(fault, n, origin, resolve_device(device))
    return (None if alive is None else node_pack(alive),
            drop_threshold_for(fault))


def loop_coverage(n: int, alive_table, start: torch.Tensor):
    """``count -> coverage`` as the reference's compiled loops (their
    while-loop condition and scan body) compute it, where ``count`` is a
    popcount of a table of the run that starts at ``start``.  Without
    deaths that is ``float32(count) * float32(1 / n)``
    (:func:`~gossip_tpu_torch.ops.common.f32_mean`: XLA folds the
    division by the static ``n``), one ulp from the eager
    :func:`coverage_node_packed` for some counts; under deaths the
    alive-weighted quotient of the count less the bits ``start`` holds
    at dead nodes, which no round changes."""
    if alive_table is None:
        return lambda count: f32_mean(count, n)
    total = popcount(alive_table)
    dead = popcount(start & ~alive_table)
    return lambda count: f32_fraction(count - dead, total)


def phantom_keep(rows: int, n: int, device=None) -> torch.Tensor:
    """int64[rows, 128] keep-mask zeroing phantom words and the tail
    word's phantom bits."""
    n_valid_words = -(-n // BITS)
    tail = n % BITS
    word_id = torch.arange(rows * LANES, dtype=torch.int64,
                           device=device).reshape(rows, LANES)
    keep = torch.where(word_id < n_valid_words - (1 if tail else 0),
                       MASK32, 0)
    if tail:
        keep = torch.where(word_id == n_valid_words - 1, (1 << tail) - 1,
                           keep)
    return keep


def draw_count(fanout: int, plane_sharing: int) -> int:
    """Draw words per table word per round."""
    return fanout * BITS // plane_sharing


def draw_round_bits(seed: int, round_: int, rows: int, fanout: int = 1,
                    plane_sharing: int = 1, device=None):
    """The port's Philox bits of one round in the reference's
    ``inject_bits`` layout: ``(sbits int32[8, 128], rbits
    int32[32*fanout/plane_sharing, rows, 128])``, int32 holding the
    uint32 bits.  Only row 0 of ``sbits`` is used; rows 1-7 are zero."""
    k0, k1 = philox.round_key(seed, round_)
    sbits = torch.zeros(8, LANES, dtype=torch.int64, device=device)
    sbits[0] = philox.shift_words(k0, k1, 1, device)[0]
    rbits = philox.draw_words(k0, k1, rows, draw_count(fanout, plane_sharing),
                              device)
    return from_words(sbits), from_words(rbits)


def fused_pull_round_plain(table: torch.Tensor, seed, round_, n: int,
                           fanout: int = 1, inject_bits=None,
                           drop_threshold=0, alive_table=None,
                           plane_sharing: int = 1,
                           cut_words=None) -> torch.Tensor:
    """One round in plain torch: the reference's ``_fused_round_ref``
    with the partner word taken by address arithmetic in place of the
    rotation's rolls.  Without ``inject_bits`` it draws the port's Philox
    stream (:func:`draw_round_bits`)."""
    rows = table.shape[0]
    dev = table.device
    if inject_bits is None:
        inject_bits = draw_round_bits(seed, round_, rows, fanout,
                                      plane_sharing, dev)
    sbits, rbits = (to_words(bit_tensor(b, dev)) for b in inject_bits)
    t = to_words(table)
    alive = to_words(alive_table) if alive_table is not None else None
    cut = to_words(cut_words) if cut_words is not None else None
    thr = int(drop_threshold) & MASK32

    # partner word of lane m for destination row i: src[(i - s_m) mod R, m]
    s = sbits[0] % rows
    src_rows = (torch.arange(rows, device=dev)[:, None] - s[None, :]) % rows
    lanes = torch.arange(LANES, device=dev)[None, :]
    rot = (t & alive if alive is not None else t)[src_rows, lanes]
    rot_cut = cut[src_rows, lanes] if cut is not None else None

    acc = t.clone()
    for k in range(0, BITS, plane_sharing):
        for f in range(fanout):
            rb = rbits[(k // plane_sharing) * fanout + f]
            keep = (rb >> 12) >= thr
            for j in range(plane_sharing):
                m = (rb >> (12 * j)) & (LANES - 1)
                c = (rb >> (12 * j + 7)) & (BITS - 1)
                bit = (torch.gather(rot, 1, m) >> c) & 1
                bit = torch.where(keep, bit, 0)
                if cut is not None:
                    pside = (torch.gather(rot_cut, 1, m) >> c) & 1
                    dside = (cut >> (k + j)) & 1
                    bit = torch.where(pside == dside, bit, 0)
                if alive is not None:
                    bit = bit & ((alive >> (k + j)) & 1)
                acc = acc | (bit << (k + j))
    return from_words(acc & phantom_keep(rows, n, dev))


def _check_sharing(plane_sharing: int, drop_threshold, cut_words):
    """The reference's ``plane_sharing`` refusals (``fused_pull_round``):
    a pair split leaves no bits for the drop coin or the side gather, and
    a tensor threshold cannot be proven zero, so it is refused too."""
    if plane_sharing not in (1, 2):
        raise ValueError(f"plane_sharing must be 1 or 2, "
                         f"got {plane_sharing}")
    concrete_zero = (isinstance(drop_threshold, (int, float))
                     and not drop_threshold)
    if plane_sharing > 1 and (not concrete_zero or cut_words is not None):
        raise ValueError(
            "plane_sharing=2 splits the draw's bit-fields across a "
            "plane pair and leaves no room for the 20-bit drop coin "
            "(concrete or traced) or the partition side gather; use "
            "plane_sharing=1 with drop_prob/partition faults")


def fused_pull_round(table: torch.Tensor, seed, round_, n: int,
                     fanout: int = 1, inject_bits=None, drop_threshold=0,
                     alive_table=None, plane_sharing: int = 1,
                     cut_words=None, out: Optional[torch.Tensor] = None,
                     pop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one fused pull round to a node-packed table.

    The reference's ``fused_pull_round`` with two additions for a GPU
    grid: ``out`` is the buffer the round writes (never ``table`` itself:
    other blocks still read the pre-round table; allocated when None),
    and ``pop``, an int32[1] tensor, has the popcount of the new table
    added to it.  ``inject_bits`` takes the reference's layout (int32
    tensors or uint32 numpy arrays with the same bits).  A CUDA table
    runs the CUDA kernel, a CPU table the plain version."""
    _check_sharing(plane_sharing, drop_threshold, cut_words)
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != LANES:
        raise ValueError(f"table must be int32[R, {LANES}], got "
                         f"{table.dtype}{list(table.shape)}")
    if not 0 < n <= table.shape[0] * NODES_PER_ROW:
        raise ValueError(f"n={n} does not fit a table of "
                         f"{table.shape[0]} rows")
    if table.device.type == "cuda":
        if inject_bits is not None:
            inject_bits = tuple(bit_tensor(b, table.device)
                                for b in inject_bits)
        return _kernels.fused_round(
            table, n, fanout, philox.round_key(seed, round_),
            int(drop_threshold), plane_sharing, inject_bits=inject_bits,
            alive_table=alive_table, cut_words=cut_words, out=out, pop=pop)
    if table.device.type != "cpu":
        raise ValueError(f"no fused round for a {table.device.type} "
                         "tensor; the port runs on cuda or cpu")
    new = fused_pull_round_plain(table, seed, round_, n, fanout,
                                 inject_bits, drop_threshold, alive_table,
                                 plane_sharing, cut_words)
    if pop is not None:
        pop += popcount(new)
    if out is None:
        return new
    return out.copy_(new)


def _advance(state: FusedState, n: int, seed: int, fanout: int,
             drop_threshold: int, alive_table, spare: torch.Tensor,
             pop: torch.Tensor) -> FusedState:
    """One round of a run loop: write ``spare``, count its bits into
    ``pop``, and account ``2*fanout*n`` messages in float32 (the
    reference adds a weakly typed float to its float32 total; dead and
    dropped pulls count, as there)."""
    table = fused_pull_round(state.table, seed, state.round, n, fanout,
                             drop_threshold=drop_threshold,
                             alive_table=alive_table, out=spare, pop=pop)
    return FusedState(table=table, round=state.round + 1,
                      msgs=np.float32(state.msgs
                                      + np.float32(2.0 * fanout * n)))


def until_fused(n: int, seed: int, fanout: int = 1,
                target_coverage: float = 0.99, max_rounds: int = 128,
                origin: int = 0, fault=None, device=None,
                state: Optional[FusedState] = None):
    """Run rounds until the float32 coverage reaches ``target_coverage``
    or the round counter reaches ``max_rounds``: the exit state of the
    reference's ``compiled_until_fused`` while-loop.  Returns
    ``(state, coverage)``.  It starts from ``state`` (for example one
    carried over by :func:`state_from_numpy`), whose table buffer it
    reuses for later rounds as the reference's loop donates its input,
    or from a fresh state at ``origin``.

    The stop test is read on the host: each round's kernel adds its
    table's popcount to that round's 4-byte device counter, and the
    loop reads it once per round (one device-to-host copy and
    synchronize per round).  Its coverage is the compiled loop's
    (:func:`loop_coverage`), for the starting table too.  Under deaths
    the round takes the alive table (:func:`fault_masks_node_packed`)
    and the stop test is the alive-weighted coverage of the new table,
    read from the same counter: dead nodes receive nothing, so the bits a
    carried-over table holds at dead nodes stay as they are, and the
    alive count is the counter less that constant."""
    dev = resolve_device(device)
    alive, thr = fault_masks_node_packed(fault, n, origin, dev)
    st = state if state is not None else init_fused_state(n, origin, dev)
    cov_of = loop_coverage(n, alive, st.table)
    target = np.float32(target_coverage)
    pops = torch.zeros(max(max_rounds - st.round, 1), dtype=torch.int32,
                       device=dev)
    spare = torch.empty_like(st.table)
    first = st.round
    cov = cov_of(popcount(st.table))
    while cov < target and st.round < max_rounds:
        slot = pops[st.round - first:st.round - first + 1]
        nxt = _advance(st, n, seed, fanout, thr, alive, spare, slot)
        spare = st.table
        st = nxt
        cov = cov_of(int(slot.item()))
    return st, cov


def curve_fused(n: int, seed: int, fanout: int = 1, max_rounds: int = 128,
                origin: int = 0, fault=None, device=None):
    """Run exactly ``max_rounds`` rounds from a fresh state and record
    the coverage after each: the reference's ``compiled_curve_fused``
    scan.  Returns ``(state, [coverage per round])``; the counters are
    read once, at the end."""
    dev = resolve_device(device)
    alive, thr = fault_masks_node_packed(fault, n, origin, dev)
    st = init_fused_state(n, origin, dev)
    pops = torch.zeros(max_rounds, dtype=torch.int32, device=dev)
    spare = torch.empty_like(st.table)
    for r in range(max_rounds):
        nxt = _advance(st, n, seed, fanout, thr, alive, spare,
                       pops[r:r + 1])
        spare = st.table
        st = nxt
    # a fresh run's table stays inside the alive set (the origin is
    # pinned alive, dead destinations receive nothing), so the round's
    # popcount is the alive-weighted count under deaths too
    cov_of = loop_coverage(n, alive, st.table)
    return st, [cov_of(int(c)) for c in pops.cpu().tolist()]
