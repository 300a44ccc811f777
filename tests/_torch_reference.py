"""Shared by the port's tests: the bit-preserving conversions between the
JAX package's uint32 arrays and the port's int32 tensors, and the JAX
package's fused loops (one rumor and several) replayed on the port's
Philox bits, with their stop tests evaluated under ``jax.jit`` as the
reference's compiled loops evaluate them (XLA folds the coverage's
division by the static ``n`` into a product with ``float32(1 / n)``)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gossip_tpu.ops import pallas_round as J
from gossip_tpu_torch.config import FaultConfig
from gossip_tpu_torch.ops import crdt as CR
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR

CPU = torch.device("cpu")


def as_port(a):
    """uint32 numpy -> the port's int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32).copy())


def as_u32(t):
    """The port's int32 tensor -> uint32 numpy with the same bits."""
    return t.numpy().view(np.uint32)


def jax_replay(n, seed, fanout, target, max_rounds, drop_prob,
               death_rate=0.0):
    """The reference loop (compiled_until_fused's while_loop semantics,
    its condition jitted) stepped on the host, each round through the JAX
    package's round on the port's Philox bits; with ``death_rate`` the
    reference's alive table (fault seed 0) and alive-weighted coverage.
    Returns the table after every round and the final (round, msgs,
    coverage), the coverage as the loop's condition computed it."""
    fault = FaultConfig(drop_prob=drop_prob, node_death_rate=death_rate)
    alive, thr = J.fault_masks_node_packed(fault, n)
    cov_fn = jax.jit(J.fused_cov_fn(n, fault))
    st = J.init_fused_state(n)
    table, msgs = st.table, st.msgs
    tables, cov = [], cov_fn(table)
    rounds = 0
    while bool(cov < jnp.float32(target)) and rounds < max_rounds:
        sb, rb = FR.draw_round_bits(seed, rounds, table.shape[0], fanout,
                                    device=CPU)
        table = J.fused_pull_round(table, seed, rounds, n, fanout,
                                   interpret=True,
                                   inject_bits=(as_u32(sb), as_u32(rb)),
                                   drop_threshold=thr, alive_table=alive)
        msgs = msgs + 2.0 * fanout * n
        cov = cov_fn(table)
        rounds += 1
        tables.append(np.asarray(table))
    return tables, rounds, np.float32(msgs), float(cov)


def jax_mr_replay(n, rumors, seed, fanout, target, max_rounds, drop_prob,
                  death_rate=0.0, origin=0):
    """The reference multi-rumor loop (compiled_until_fused_multirumor's
    while_loop semantics, its condition jitted) stepped on the host, each
    round through the JAX package's round on the port's multi-rumor
    Philox bits; with ``death_rate`` the reference's alive words (fault
    seed 0) and alive-weighted coverage.  Returns the table after every
    round and the final (round, msgs, coverage), the coverage as the
    loop's condition computed it."""
    fault = FaultConfig(drop_prob=drop_prob, node_death_rate=death_rate)
    alive, thr = J.fault_masks_word(fault, n, origin)
    cov_fn = jax.jit(J.fused_mr_cov_fn(n, rumors, fault, origin))
    st = J.init_multirumor_state(n, rumors, origin)
    table, msgs = st.table, st.msgs
    tables, cov = [], cov_fn(table)
    rounds = 0
    while bool(cov < jnp.float32(target)) and rounds < max_rounds:
        sb, rb = MR.draw_mr_round_bits(seed, rounds, table.shape[0], fanout,
                                       device=CPU)
        table = J.fused_multirumor_pull_round(
            table, seed, rounds, n, fanout, interpret=True,
            inject_bits=(as_u32(sb), as_u32(rb)), drop_threshold=thr,
            alive_words=alive)
        msgs = msgs + 2.0 * fanout * n
        cov = cov_fn(table)
        rounds += 1
        tables.append(np.asarray(table))
    return tables, rounds, np.float32(msgs), float(cov)


def report_coverage(table, n, rumors=1):
    """The coverage the reference's run report gives a final table of a
    run without deaths: its eager recount, ``float32(count) /
    float32(n)`` (``gossip_tpu/backend.py``), not the loop's product."""
    if rumors == 1:
        return float(J.coverage_node_packed(jnp.asarray(table), n))
    return float(J.coverage_words(jnp.asarray(table), n, rumors))


def config_pair(cls_name, **kw):
    """The same config in both packages (``cls_name`` in
    ``gossip_tpu.config`` and ``gossip_tpu_torch.config``)."""
    from gossip_tpu import config as JC
    from gossip_tpu_torch import config as TC
    return getattr(JC, cls_name)(**kw), getattr(TC, cls_name)(**kw)


def fault_pair(churn=None, byz=None, **kw):
    """The same ``FaultConfig`` in both packages; ``churn`` and ``byz``
    are keyword dicts of ``ChurnConfig`` and ``ByzConfig``.  None for
    ``None``."""
    if churn is None and byz is None and not kw:
        return None, None
    from gossip_tpu import config as JC
    from gossip_tpu_torch import config as TC
    out = []
    for M in (JC, TC):
        out.append(M.FaultConfig(
            churn=None if churn is None else M.ChurnConfig(**churn),
            byz=None if byz is None else M.ByzConfig(**byz), **kw))
    return tuple(out)


def forced_blocks(rows: int):
    """Force the payload rounds' exchange and converged count to blocks
    of ``rows`` rows (the byte budget picks far larger ones at a test's
    size); the rounds take their block size when they are made."""
    return mock.patch.object(CR, "block_rows_for", lambda width, k: rows)


def payload_state_equal(js, ts) -> bool:
    """A CRDT or log state of the reference (``val``, ``round``,
    ``base_key``, ``msgs``) and of the port, bitwise."""
    from gossip_tpu_torch.ops import threefry
    jv = np.asarray(js.val)
    tv = ts.val.cpu().numpy()
    if jv.dtype == np.uint32:
        tv = tv.view(np.uint32)
    return bool(
        jv.dtype == tv.dtype and np.array_equal(jv, tv)
        and int(js.round) == ts.round
        and np.array_equal(threefry.key_to_words(ts.base_key),
                           np.asarray(jax.random.key_data(js.base_key)))
        and np.float32(js.msgs) == np.float32(ts.msgs.item()))
