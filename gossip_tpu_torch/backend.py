"""``run_simulation``: the port's backend.

The port of the JAX package's ``backend.run_simulation`` (``run_jax`` and
``_run_fused``).  On one device:

* ``engine='fused'``: pull gossip on the implicit complete graph, one CUDA
  kernel launch per round: one rumor on the node-packed bitmap
  (:mod:`gossip_tpu_torch.ops.fused_round`) or up to 32 on one word per
  node (:mod:`gossip_tpu_torch.ops.fused_mr_round`), with the static fault
  masks (deaths and drops) in the kernel;
* ``engine='xla'``: the threefry-keyed engine, bitwise equal to the JAX
  package's XLA path: pull and anti-entropy without a curve on the
  bit-packed rounds (:mod:`gossip_tpu_torch.models.si_packed`,
  ``meta.engine = "bit-packed"``), the other SI runs on the bool rounds
  (:mod:`gossip_tpu_torch.runtime.simulator`), SWIM failure detection
  (:mod:`gossip_tpu_torch.models.swim`) and rumor mongering
  (:mod:`gossip_tpu_torch.models.rumor`) on their own rounds;
* ``engine='auto'``: fused where :func:`fused_ineligible_reason` is None
  and the device is CUDA, where the hand-written kernel runs, else xla:
  the reference's rule, whose ``auto`` takes the fused route only where
  its Pallas kernel runs.  On the CPU ``auto`` is the xla engine, bitwise
  the reference's CPU run; an explicit ``engine='fused'`` there runs the
  kernels' plain versions (an extension: the reference refuses fused off
  its TPU).  A fault program (``fault.churn``) runs on the xla engine;
  ``fused`` refuses it on one device, as the reference's single-device
  fused routing does.

With ``mesh_cfg.n_devices = K > 1`` the SI modes, SWIM and rumor
mongering run on the node-sharded drivers over ``torch.distributed``
(:mod:`gossip_tpu_torch.parallel`, the reference's ``n_dev > 1``
branch): bit-packed for pull and anti-entropy without a curve, dense
otherwise, SWIM and rumor mongering on their own sharded rounds, on
``engine='xla'`` or ``'auto'``.  ``mesh_cfg.exchange='sparse'`` takes
pull and anti-entropy to the all_to_all exchange
(:mod:`gossip_tpu_torch.parallel.sharded_sparse`: the stratified draw on
the complete graph, capacity-capped buckets on a table), and ``'halo'``
flood, pull, push and push-pull on a banded table to the ``ppermute``
exchange (:mod:`gossip_tpu_torch.parallel.halo`); what either cannot
run is refused in the reference's words, never run on another exchange.
The process group is NCCL with a card a rank, gloo on the CPU or on one
card shared by the ranks (``mesh_cfg.shared_card``); more ranks than
cards are refused.  ``engine='fused'`` with K > 1 shards rumor planes
instead (:mod:`gossip_tpu_torch.parallel.sharded_fused`, the reference's
``_run_fused`` with ``n_dev > 1``): W planes of 32 rumors, W/K a rank,
every rank launching the fused multi-rumor kernel on its planes with the
same partner stream, one scalar reduction a round; it runs more than 32
rumors, static deaths and drops, and the whole fault program
(:func:`planes_report`).  ``auto`` with K > 1 keeps the node-sharded
drivers, as the reference's does.

:func:`run_ensemble` runs a seed ensemble, the reference's
``run_ensemble``: one batch of seeds on the XLA engine
(:mod:`gossip_tpu_torch.parallel.sweep`), optionally sharded over the
ranks of a group.

A ``log_cfg`` runs the replicated-log workload
(:func:`run_log_workload`, the reference's ``run_log_workload``) and a
``txn_cfg`` the LWW-register transactions (:func:`run_txn_workload`) on
the xla engine, on one device: with a ``mesh_cfg`` they are refused in
the reference's words (the payloads shard through the library API,
:mod:`gossip_tpu_torch.parallel.sharded_log` and
:mod:`~gossip_tpu_torch.parallel.sharded_register`, and the ``log`` and
``txn`` commands' ``--devices``).

The report carries the reference's ``RunReport`` fields and ``meta``
keys, plus the device, every kernel's launches and, for the SI modes,
the exact count behind the coverage
(``coverage_count`` over ``coverage_total``, the float32 rule of
:mod:`gossip_tpu_torch.ops.common`).  Whatever the port
does not run yet is refused with a ``ValueError`` that names the slice it
waits for, never run some other way.

The run is on the CUDA device unless the caller passes ``device="cpu"``,
which runs the plain versions; with no card and no explicit device it
raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (FaultConfig, MeshConfig, ProtocolConfig,
                                     RunConfig, TopologyConfig)
from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.ops import fused_mr_round as MR
from gossip_tpu_torch.ops import fused_round as FR
from gossip_tpu_torch.ops import nemesis as NE
from gossip_tpu_torch.ops.common import resolve_device, to_words
from gossip_tpu_torch.utils.timing import steady_timed, timing_meta


@dataclasses.dataclass
class RunReport:
    """One simulation's outcome (JSON-serializable), with the fields of
    the JAX package's report."""

    backend: str
    mode: str
    n: int
    rounds: int
    coverage: float
    msgs: float
    wall_s: float
    curve: Optional[List[float]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _curve_summary(covs, msgs, target):
    """(rounds_to_target, final_cov, final_msgs, curve) from per-round
    series; -1 when the target was never reached."""
    hit = [i for i, c in enumerate(covs) if c >= target]
    return ((hit[0] + 1) if hit else -1, float(covs[-1]), float(msgs[-1]),
            [float(c) for c in covs])


def fused_ineligible_reason(proto: ProtocolConfig, topo: TopologyConfig,
                            run: RunConfig, fault: Optional[FaultConfig],
                            n_dev: int = 1,
                            plane_stack: bool = False) -> Optional[str]:
    """Why the fused route cannot run the configuration, or None if it
    can: the reference's list, in its order and words.  More than 32
    rumors are allowed exactly where the run shards rumor planes
    (``n_dev > 1``), and a fault program where it runs on the planes
    (``n_dev > 1``, or ``plane_stack``: a caller that takes the plane
    drivers whatever K is, as ``churn-sweep --engine fused`` does).
    Configuration reasons only; the device is resolved afterwards."""
    if proto.mode != C.PULL:
        return (f"engine='fused' implements pull rounds only "
                f"(got mode {proto.mode!r})")
    if topo.family != C.COMPLETE:
        return ("engine='fused' runs on the implicit complete "
                f"topology only (got family {topo.family!r})")
    if fault is not None and fault.dead_nodes:
        return ("engine='fused' does not implement scripted dead_nodes/"
                "fail_round; use engine='auto' (or node_death_rate for "
                "random static deaths)")
    if (fault is not None and fault.churn is not None and n_dev == 1
            and not plane_stack):
        # the reference's words, less the plane surface the port does
        # not have yet (the plane checkpoints' --checkpoint)
        return ("engine='fused' routing does not run churn "
                "schedules single-device; use engine='auto' (XLA "
                "kernels run the full nemesis scenario catalog — "
                "docs/ROBUSTNESS.md), or the plane-sharded fused "
                "surfaces (--devices > 1, churn-sweep --engine fused), "
                "which run events + partitions + ramps as runtime "
                "operands")
    if n_dev == 1 and proto.rumors > FR.BITS:
        return (f"engine='fused' packs <= {FR.BITS} rumors per word "
                f"on one device (got rumors={proto.rumors}); "
                "shard rumor planes with --devices")
    if topo.n >= 1 << 31:
        return (f"n={topo.n}: node ids and the round's popcount counter "
                "are 32-bit; n must stay below 2^31")
    return None


def _refusal(proto, run, fault, mesh_cfg, log_cfg, txn_cfg):
    """Why no engine of the port runs this request yet, or None."""
    if run.engine == "native":
        return ("engine='native' is the JAX package's go-native event "
                "core; the port's engines are auto|xla|fused")
    if log_cfg is not None and txn_cfg is not None:
        return ("a request carries at most one payload workload; pick "
                "'log' or 'txn'")
    # the reference's words: the payloads shard through the library API
    # (parallel/sharded_crdt, sharded_log, sharded_register) and the
    # payload commands' --devices
    if txn_cfg is not None and mesh_cfg is not None:
        return ("the txn workload over RPC is single-process "
                "single-device; shard the node mesh via the library API "
                "(parallel/sharded_register)")
    if log_cfg is not None and mesh_cfg is not None:
        return ("the log workload over RPC is single-process "
                "single-device; shard the node mesh via the library API "
                "(parallel/sharded_log)")
    n_dev = 1 if mesh_cfg is None else mesh_cfg.n_devices
    exchange = "dense" if mesh_cfg is None else mesh_cfg.exchange
    if exchange != "dense":
        # the reference's words: never the dense path in its place
        if n_dev == 1:
            return (f"exchange={exchange!r} is a cross-shard pattern; it "
                    "needs n_devices > 1 (single-device runs have no "
                    "exchange)")
        if proto.mode in (C.SWIM, C.RUMOR):
            return (f"exchange={exchange!r} is not implemented for "
                    f"{proto.mode}; swim and rumor shard via the dense "
                    "kernels (pmax / psum_scatter + all_gather)")
        if run.engine == "fused":
            return (f"exchange={exchange!r} requests a cross-shard digest "
                    "pattern; engine='fused' shards rumor planes with zero "
                    "per-round ICI and implements no exchange — use "
                    "engine='auto' for sparse/halo runs")
    return None


def swim_scenario(proto: ProtocolConfig, n: int,
                  fault: Optional[FaultConfig]):
    """``(dead_nodes, fail_round, default_scenario)`` of a SWIM run: the
    fault's scripted deaths, or without any (no ``dead_nodes``, no churn
    event) node ``1 % S`` failing at round 2.  The metric's targets must
    be node ids below ``n`` and, on the fixed window, inside it."""
    from gossip_tpu_torch.models.swim import detection_targets
    churn = NE.get(fault)
    scripted = fault is not None and (
        bool(fault.dead_nodes) or (churn is not None and churn.events))
    if scripted:
        dead, fail_round = fault.dead_nodes, fault.fail_round
    else:
        dead, fail_round = (1 % proto.swim_subjects,), 2
    targets = detection_targets(dead, fault)
    bad = [d for d in targets if d >= n]
    if bad:
        raise ValueError(f"dead_nodes {bad} out of range for n={n}")
    if not proto.swim_rotate:
        outside = [d for d in targets if d >= proto.swim_subjects]
        if outside:
            raise ValueError(
                f"dead/churn-dead nodes {outside} are outside the fixed "
                f"subject window 0..{proto.swim_subjects - 1}; enable "
                "--swim-rotate for full-membership detection")
    return dead, fail_round, not scripted


def swim_scenario_meta(proto: ProtocolConfig, n: int,
                       fault: Optional[FaultConfig]):
    """``(dead_nodes, fail_round, meta)``: :func:`swim_scenario` and the
    meta keys that name it."""
    from gossip_tpu_torch.models.swim import detection_targets
    dead, fail_round, default_scenario = swim_scenario(proto, n, fault)
    return dead, fail_round, {
        "metric": "detection_fraction",
        "dead_subjects": list(detection_targets(dead, fault)),
        "fail_round": fail_round, "default_scenario": default_scenario}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in _kernels.ROUND_KERNELS}


def _run_fused(proto: ProtocolConfig, topo: TopologyConfig, run: RunConfig,
               fault: Optional[FaultConfig], want_curve: bool,
               dev: torch.device) -> RunReport:
    """The fused pull loop to ``run.target_coverage`` (with several
    rumors: the minimum over rumors) or ``run.max_rounds`` (``want_curve``:
    exactly ``max_rounds`` rounds, with the coverage after each)."""
    n = topo.n
    multi = proto.rumors > 1
    table_bytes = (MR.check_fused_fits(n, proto.rumors, dev)
                   if multi else MR.fused_table_bytes(n, 1))
    t0 = time.perf_counter()
    build_s = 0.0
    if dev.type == "cuda":
        _kernels.build_all()
        build_s = time.perf_counter() - t0
    launches0 = _launch_counts()
    kw = dict(seed=run.seed, fanout=proto.fanout, max_rounds=run.max_rounds,
              origin=run.origin, fault=fault, device=dev)
    if multi:
        until_fn = functools.partial(MR.until_fused_multirumor,
                                     rumors=proto.rumors)
        curve_fn = functools.partial(MR.curve_fused_multirumor,
                                     rumors=proto.rumors)
    else:
        until_fn, curve_fn = FR.until_fused, FR.curve_fused
    if want_curve:
        (final, covs), steady = steady_timed(dev, curve_fn, n, **kw)
        rounds, cov, msgs, curve = _curve_summary(
            covs, [float(final.msgs)], run.target_coverage)
        host_reads = 1
    else:
        (final, cov), steady = steady_timed(
            dev, until_fn, n, target_coverage=run.target_coverage, **kw)
        # the report's coverage is the reference's eager one: without
        # deaths the quotient, where the loop's stop test multiplied by
        # float32(1 / n) as the compiled loop does; under deaths the same
        if fault is None or not fault.node_death_rate:
            cov = (MR.coverage_words(final.table, n, proto.rumors) if multi
                   else FR.coverage_node_packed(final.table, n))
        hit = cov >= float(np.float32(run.target_coverage))
        rounds, msgs, curve = (final.round if hit else -1), \
            float(final.msgs), None
        host_reads = final.round
    wall = time.perf_counter() - t0
    launches1 = _launch_counts()
    # the exact count behind the coverage (_count_meta), alive nodes only
    if multi:
        alive, _ = MR.fault_masks_word(fault, n, run.origin, dev)
        table = final.table if alive is None else final.table & alive
        count = int(MR.rumor_counts(table, proto.rumors).min())
        total = n if alive is None else int((to_words(alive) & 1).sum())
    else:
        alive, _ = FR.fault_masks_node_packed(fault, n, run.origin, dev)
        count = FR.popcount(final.table if alive is None
                            else final.table & alive)
        total = n if alive is None else FR.popcount(alive)
    return RunReport(
        backend=f"torch-{dev.type}", mode=proto.mode, n=n, rounds=rounds,
        coverage=cov, msgs=msgs, wall_s=round(wall, 4), curve=curve,
        meta={"clock": "rounds", "devices": 1,
              "msgs_counts": "transmissions",
              "engine": "fused-cuda" if dev.type == "cuda" else "fused-plain",
              "layout": ("one 32-rumor word per node" if multi
                         else "node-packed bitmap"),
              "route": "value" if multi else None,
              "table_bytes": table_bytes,
              "device": _device_name(dev),
              "launches": {k: launches1[k] - launches0[k]
                           for k in launches1},
              "host_reads": host_reads,
              "coverage_count": count, "coverage_total": total,
              **timing_meta(build_s, steady, wall)})


def _run_swim(proto: ProtocolConfig, tc: TopologyConfig, run: RunConfig,
              fault: Optional[FaultConfig], want_curve: bool, topo,
              dev: torch.device, group=None):
    """SWIM on the XLA engine: ``(rounds, detection, msgs, curve, meta,
    steady_s, rounds_run)`` with the reference's meta keys.  ``rounds`` is
    the round the detection reached the target, else -1.  With a ``group``: this
    rank's run of the sharded round."""
    from gossip_tpu_torch.models.swim import (effective_diss,
                                              resolve_epoch_rounds,
                                              suggested_suspect_rounds)
    from gossip_tpu_torch.runtime.simulator import (simulate_swim_curve,
                                                    simulate_swim_until)
    dead, fail_round, meta = swim_scenario_meta(proto, tc.n, fault)
    meta.update({"clock": "rounds",
                 "suggested_suspect_rounds":
                     suggested_suspect_rounds(tc.n, proto.fanout),
                 "devices": 1 if group is None else group.size,
                 # the lowering that ran: pack without a lane width is sort
                 "swim_diss_effective": effective_diss(proto.swim_diss,
                                                       run.max_rounds),
                 "swim_rng": proto.swim_rng})
    if proto.swim_rotate:
        meta["subject_window"] = "rotating"
        meta["epoch_rounds"] = resolve_epoch_rounds(proto, tc.n)
    kw = dict(dead_nodes=dead, fail_round=fail_round, fault=fault,
              topo=None if tc.family == C.COMPLETE else topo,
              seed=run.seed, device=dev, group=group)
    if want_curve:
        (fracs, final), steady = steady_timed(
            dev, simulate_swim_curve, proto, tc.n, run.max_rounds, **kw)
        hit = [i for i, f in enumerate(fracs) if f >= run.target_coverage]
        rounds = (hit[0] + 1) if hit else -1
        det = float(fracs[-1])
        peak = float(max(fracs))
        curve = [float(f) for f in fracs]
    else:
        (r, det, peak, final), steady = steady_timed(
            dev, simulate_swim_until, proto, tc.n, run.max_rounds,
            run.target_coverage, **kw)
        rounds = r if det >= float(np.float32(run.target_coverage)) else -1
        curve = None
    if proto.swim_rotate:
        # the window may have left the dead node's epoch by the end
        meta["peak_detection"] = peak
    return (rounds, det, float(final.msgs.item()), curve, meta, steady,
            final.round)


def _run_rumor(proto: ProtocolConfig, run: RunConfig,
               fault: Optional[FaultConfig], want_curve: bool, topo,
               dev: torch.device, group=None):
    """Rumor mongering on the XLA engine: ``(rounds, coverage, msgs,
    curve, meta, steady_s, rounds_run)``; ``rounds`` counts the rounds to
    extinction (no pair hot), -1 if a pair was still hot at
    ``max_rounds``.  With a ``group``: this rank's run of the sharded
    round."""
    from gossip_tpu_torch.models.rumor import (hot_fraction,
                                               simulate_curve_rumor,
                                               simulate_until_rumor)
    from gossip_tpu_torch.ops.common import f32_mean
    from gossip_tpu_torch.parallel import sharded_rumor as SR
    if group is None:
        args = (proto, topo, run, fault, dev)
        curve_fn, until_fn = simulate_curve_rumor, simulate_until_rumor
    else:
        args = (proto, topo, run, group, fault)
        curve_fn = SR.simulate_curve_rumor_sharded
        until_fn = SR.simulate_until_rumor_sharded
    if want_curve:
        (covs, hots, msgs, final), steady = steady_timed(dev, curve_fn,
                                                         *args)
        _, cov, msgs_f, curve = _curve_summary(covs, msgs,
                                               run.target_coverage)
        extinct = np.nonzero(hots == 0.0)[0]
        rounds = int(extinct[0]) + 1 if len(extinct) else -1
        residue = 1.0 - float(covs[-1])
        hot_left = float(hots[-1])
    else:
        (rounds, cov, residue, msgs_f, final), steady = steady_timed(
            dev, until_fn, *args)
        curve = None
        if group is None:
            hot_left = hot_fraction(final.hot)
        else:
            # the real rows' share (padding rows never hold a hot pair)
            held = group.all_reduce_sum(final.hot.any(dim=1).sum())
            hot_left = f32_mean(int(held), topo.n)
        rounds = rounds if hot_left == 0.0 else -1
    meta = {"clock": "rounds", "devices": 1 if group is None else group.size,
            "msgs_counts": "transmissions", "rounds_semantics": "extinction",
            "variant": proto.rumor_variant, "rumor_k": proto.rumor_k,
            "residue": round(residue, 6), "hot_fraction_final": hot_left,
            "terminated": hot_left == 0.0}
    return rounds, cov, msgs_f, curve, meta, steady, final.round


def _count_meta(seen, proto: ProtocolConfig, fault: Optional[FaultConfig],
                run: RunConfig, packed: bool = False) -> Dict[str, int]:
    """The exact count behind the report's coverage: the holders of the
    least-held rumor (``coverage_count``) over the nodes counted
    (``coverage_total``), the float32 rule's inputs
    (:mod:`gossip_tpu_torch.ops.common`)."""
    alive = NE.metric_alive(fault, seen.shape[0], run.origin, seen.device)
    if packed:
        from gossip_tpu_torch.ops.bitpack import coverage_count_packed
        count, total = coverage_count_packed(seen, proto.rumors, alive)
    else:
        from gossip_tpu_torch.models.si import coverage_count
        count, total = coverage_count(seen, alive)
    return {"coverage_count": count, "coverage_total": total}


def _run_xla(proto: ProtocolConfig, tc: TopologyConfig, run: RunConfig,
             fault: Optional[FaultConfig], want_curve: bool,
             dev: torch.device) -> RunReport:
    """The XLA engine: SWIM and rumor mongering on their own rounds,
    bit-packed pull / anti-entropy without a curve, the bool rounds
    otherwise."""
    from gossip_tpu_torch.topology import generators as G
    t0 = time.perf_counter()
    topo = G.build(tc, dev)
    topo_build_s = time.perf_counter() - t0
    launches0 = _launch_counts()
    base = {"clock": "rounds", "devices": 1,
            "msgs_counts": "transmissions"}
    t0 = time.perf_counter()
    if proto.mode == C.SWIM:
        rounds, cov, msgs, curve, meta, steady, _ = _run_swim(
            proto, tc, run, fault, want_curve, topo, dev)
    elif proto.mode == C.RUMOR:
        rounds, cov, msgs, curve, meta, steady, _ = _run_rumor(
            proto, run, fault, want_curve, topo, dev)
    elif proto.mode in (C.PULL, C.ANTI_ENTROPY) and not want_curve:
        from gossip_tpu_torch.models.si_packed import simulate_until_packed
        (rounds, cov, msgs, final), steady = steady_timed(
            dev, simulate_until_packed, proto, topo, run, fault, dev)
        curve = None
        meta = {**base, "engine": "bit-packed",
                **_count_meta(final.seen, proto, fault, run, packed=True)}
    elif want_curve:
        from gossip_tpu_torch.runtime.simulator import simulate_curve
        res, steady = steady_timed(dev, simulate_curve, proto, topo, run,
                                   fault, dev)
        rounds, cov = res.rounds_to_target, res.final_coverage
        msgs, curve = float(res.msgs[-1]), [float(c) for c in res.coverage]
        meta = {**base, **_count_meta(res.state.seen, proto, fault, run)}
    else:
        from gossip_tpu_torch.runtime.simulator import simulate_until
        res, steady = steady_timed(dev, simulate_until, proto, topo, run,
                                   fault, dev)
        rounds, cov, msgs, curve = res.rounds, res.coverage, res.msgs, None
        meta = {**base, **_count_meta(res.state.seen, proto, fault, run)}
    wall = time.perf_counter() - t0
    launches1 = _launch_counts()
    meta.update({"device": _device_name(dev),
                 "launches": {k: launches1[k] - launches0[k]
                              for k in launches1},
                 **timing_meta(0.0, steady, wall),
                 "topo_build_s": round(topo_build_s, 4)})
    return RunReport(backend=f"torch-{dev.type}", mode=proto.mode, n=tc.n,
                     rounds=rounds, coverage=cov, msgs=msgs,
                     wall_s=round(wall, 4), curve=curve, meta=meta)


def check_exchange(proto: ProtocolConfig, tc: TopologyConfig,
                   fault: Optional[FaultConfig], k: int,
                   exchange: str) -> None:
    """Refuse, before any rank starts and in the reference's words, a
    sparse or halo run that its drivers cannot take on ``k`` ranks (the
    halo's band is checked on the table, in the ranks)."""
    from gossip_tpu_torch.parallel import halo as HL
    from gossip_tpu_torch.parallel import sharded_sparse as SS
    if exchange == "sparse" and tc.family == C.COMPLETE:
        SS.check_sparse(proto, tc.n, k, fault)
    elif exchange == "sparse":
        SS.check_topo_sparse(proto, False, fault)
    elif exchange == "halo":
        HL.check_halo(proto, tc.n, tc.family == C.COMPLETE, k)


def _exchange_run(proto: ProtocolConfig, tc: TopologyConfig, run: RunConfig,
                  fault: Optional[FaultConfig], want_curve: bool, topo,
                  group, exchange: str):
    """This rank's run of the sparse or halo drivers: ``(rounds,
    coverage, msgs, curve, final_state, meta, steady_s)`` with the
    reference's meta keys (the exchange, its bytes a round or band, and
    for an explicit table the bucket cap and the dropped requests)."""
    from gossip_tpu_torch.parallel import halo as HL
    from gossip_tpu_torch.parallel import sharded_sparse as SS
    dev = group.device
    meta: Dict[str, Any] = {"exchange": exchange}
    if exchange == "halo":
        fn = HL.simulate_curve_halo if want_curve else HL.simulate_until_halo
        out, steady = steady_timed(dev, fn, proto, topo, run, group, fault)
        meta["band"] = out[-1]
    elif tc.family == C.COMPLETE:
        fn = (SS.simulate_curve_sparse if want_curve
              else SS.simulate_until_sparse)
        out, steady = steady_timed(dev, fn, proto, tc.n, run, group, fault)
    else:
        fn = (SS.simulate_curve_topo_sparse if want_curve
              else SS.simulate_until_topo_sparse)
        (*out, ovf), steady = steady_timed(dev, fn, proto, topo, run, group,
                                           fault)
        meta.update({"overflow_dropped_requests": float(
            ovf[-1] if want_curve else ovf), "bucket_cap": out[-1].cap})
    if exchange == "sparse":
        smeta = out[-1]
        # for anti-entropy with period > 1 every figure is per exchange
        # round (the whole exchange skips the quiet rounds)
        meta["ici_bytes_per_round"] = {
            "sparse": smeta.sparse_bytes,
            "dense_equivalent": smeta.dense_bytes,
            "reverse_exchange_only": smeta.reverse_bytes}
    if want_curve:
        covs, msgs_t, final = out[:3]
        rounds, cov, msgs, curve = _curve_summary(covs, msgs_t,
                                                  run.target_coverage)
    else:
        (rounds, cov, msgs, final), curve = out[:4], None
    return rounds, cov, msgs, curve, final, meta, steady


def sharded_report(proto: ProtocolConfig, tc: TopologyConfig,
                   run: RunConfig, fault: Optional[FaultConfig],
                   want_curve: bool, group,
                   exchange: str = "dense") -> RunReport:
    """One rank's run of the node-sharded drivers: the sparse or halo
    exchange where ``exchange`` asks for it, else the bit-packed
    while-loop for pull and anti-entropy without a curve and the dense
    drivers otherwise (the reference's ``n_dev > 1`` routing).  Every
    rank returns the same report; ``meta`` adds the process group's
    backend, each collective's device time, every rank's peak allocated
    memory on a card and every rank's kernel launches."""
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded as SH
    from gossip_tpu_torch.parallel import sharded_packed as SP
    from gossip_tpu_torch.topology import generators as G
    dev = group.device
    t0 = time.perf_counter()
    topo = G.build(tc, dev)
    topo_build_s = time.perf_counter() - t0
    # the sparse exchange's state is packed words; the halo's is bool
    packed = exchange == "sparse" or (
        exchange == "dense" and proto.mode in (C.PULL, C.ANTI_ENTROPY)
        and not want_curve)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    group.collective_ms(reset=True)
    launches0 = _launch_counts()
    meta = {"clock": "rounds", "devices": group.size,
            "msgs_counts": "transmissions"}
    t0 = time.perf_counter()
    final = None
    if proto.mode == C.SWIM:
        rounds, cov, msgs, curve, meta, steady, rounds_run = _run_swim(
            proto, tc, run, fault, want_curve, topo, dev, group)
    elif proto.mode == C.RUMOR:
        rounds, cov, msgs, curve, meta, steady, rounds_run = _run_rumor(
            proto, run, fault, want_curve, topo, dev, group)
    elif exchange != "dense":
        rounds, cov, msgs, curve, final, xmeta, steady = _exchange_run(
            proto, tc, run, fault, want_curve, topo, group, exchange)
        meta.update(xmeta)
    elif packed:
        (rounds, cov, msgs, final), steady = steady_timed(
            dev, SP.simulate_until_packed_sharded, proto, topo, run, group,
            fault)
        curve = None
        meta["engine"] = "bit-packed"
    elif want_curve:
        (covs, msgs_t, final), steady = steady_timed(
            dev, SH.simulate_curve_sharded, proto, topo, run, group, fault)
        rounds, cov, msgs, curve = _curve_summary(covs, msgs_t,
                                                  run.target_coverage)
    else:
        (rounds, cov, msgs, final), steady = steady_timed(
            dev, SH.simulate_until_sharded, proto, topo, run, group, fault)
        curve = None
    wall = time.perf_counter() - t0
    if final is not None:
        counter = SH.Coverage(fault, tc.n, run.origin, group,
                              proto.rumors if packed else None)
        meta.update({"coverage_count": counter.count(final.seen),
                     "coverage_total": counter.total})
        rounds_run = final.round
    collectives = {name: {**c, "ms_per_round": c["ms"] / max(rounds_run,
                                                              1)}
                   for name, c in group.collective_ms().items()}
    meta.update({"process_group": group.backend,
                 "device": _device_name(dev),
                 "collective_ms": collectives,
                 "rank_peak_mem_bytes": GR.peak_memory(group),
                 "rank_launches": _rank_launches(group, launches0),
                 **timing_meta(0.0, steady, wall),
                 "topo_build_s": round(topo_build_s, 4)})
    return RunReport(backend=f"torch-{dev.type}", mode=proto.mode, n=tc.n,
                     rounds=rounds, coverage=cov, msgs=msgs,
                     wall_s=round(wall, 4), curve=curve, meta=meta)


def _rank_launches(group, launches0: Dict[str, int]) -> List[Dict[str, int]]:
    """Every rank's kernel launches since ``launches0``, in rank order."""
    now = _launch_counts()
    mine = torch.tensor([[now[k] - launches0[k] for k in now]],
                        dtype=torch.int64, device=group.device)
    return [dict(zip(now, row)) for row in group.all_gather(mine).tolist()]


def planes_report(proto: ProtocolConfig, tc: TopologyConfig,
                  run: RunConfig, fault: Optional[FaultConfig],
                  want_curve: bool, group) -> RunReport:
    """One rank's run of the fused rumor planes
    (:mod:`gossip_tpu_torch.parallel.sharded_fused`): to the target, or
    exactly ``max_rounds`` rounds with the curve.  Every rank returns the
    same report, with the reference's meta keys (``engine``, ``layout``,
    the table bytes a plane, ``ici_bytes_per_round`` 0.0: no digest
    crosses ranks) and the port's: the process group, each collective's
    time, every rank's peak allocated memory on a card and every rank's
    kernel launches, and the wall's parts (``init_build_s``, the state's
    and operands' build)."""
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sharded_fused as SF
    dev = group.device
    n = tc.n
    table_bytes = MR.check_fused_fits(n, FR.BITS, dev)
    t0 = time.perf_counter()
    build_s = 0.0
    if dev.type == "cuda":
        _kernels.build_all()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
    group.collective_ms(reset=True)
    launches0 = _launch_counts()
    timing: Dict[str, float] = {}
    args = (n, proto.rumors, run, group, proto.fanout, fault, timing)
    if want_curve:
        covs, _ = SF.simulate_curve_sharded_fused(*args)
        # the closed form 2 * fanout * n a round over the whole curve
        rounds, cov, msgs, curve = _curve_summary(
            covs, [2.0 * proto.fanout * n * run.max_rounds],
            run.target_coverage)
        rounds_run = run.max_rounds
    else:
        rounds_run, cov, msgs, _ = SF.simulate_until_sharded_fused(*args)
        hit = cov >= float(np.float32(run.target_coverage))
        rounds, curve = (rounds_run if hit else -1), None
    wall = time.perf_counter() - t0
    collectives = {name: {**c, "ms_per_round": c["ms"] / max(rounds_run, 1)}
                   for name, c in group.collective_ms().items()}
    w = SF.plane_count(proto.rumors, group.size)
    return RunReport(
        backend=f"torch-{dev.type}", mode=proto.mode, n=n, rounds=rounds,
        coverage=cov, msgs=msgs, wall_s=round(wall, 4), curve=curve,
        meta={"clock": "rounds", "devices": group.size,
              "msgs_counts": "transmissions",
              "engine": ("fused-cuda-planes" if dev.type == "cuda"
                         else "fused-plain-planes"),
              "layout": f"{w} rumor planes x one 32-rumor word per node",
              "table_bytes_per_plane": table_bytes,
              "ici_bytes_per_round": 0.0,
              "process_group": group.backend,
              "device": _device_name(dev),
              "collective_ms": collectives,
              "rank_peak_mem_bytes": GR.peak_memory(group),
              "rank_launches": _rank_launches(group, launches0),
              **timing_meta(build_s, timing["steady_s"], wall),
              "init_build_s": round(timing["init_build_s"], 4)})


def run_sharded(proto: ProtocolConfig, tc: TopologyConfig, run: RunConfig,
                fault: Optional[FaultConfig], mesh_cfg: MeshConfig,
                want_curve: bool = False, device=None) -> RunReport:
    """The run on ``mesh_cfg.n_devices`` ranks, the fused rumor planes
    (:func:`planes_report`) for ``engine='fused'`` and the node-sharded
    drivers (:func:`sharded_report`) otherwise: inside a process group
    that is up (``torchrun``) as this rank; otherwise it spawns the ranks
    (:func:`~gossip_tpu_torch.parallel.group.launch`) and returns rank
    0's report."""
    import torch.distributed as dist

    from gossip_tpu_torch.parallel import group as GR
    k = mesh_cfg.n_devices
    if run.engine == "fused":
        fn, kw = planes_report, {}
    else:
        check_exchange(proto, tc, fault, k, mesh_cfg.exchange)
        fn, kw = sharded_report, {"exchange": mesh_cfg.exchange}
    if dist.is_available() and dist.is_initialized():
        group = GR.current(device)
        if group.size != k:
            raise ValueError(f"the process group has {group.size} ranks; "
                             f"the mesh asks for {k}")
        return fn(proto, tc, run, fault, want_curve, group=group, **kw)
    return GR.launch(fn, k, proto, tc, run, fault, want_curve,
                     device=device, shared_card=mesh_cfg.shared_card,
                     **kw)[0]


def _run_payload_workload(mode: str, model, proto: ProtocolConfig,
                          tc: TopologyConfig, run: RunConfig, cfg,
                          fault: Optional[FaultConfig], want_curve: bool,
                          dev: torch.device) -> RunReport:
    """A payload workload on the XLA engine through ``model``'s
    ``check_<mode>_mode``, ``simulate_curve_<mode>`` and
    ``simulate_until_<mode>``: ``coverage`` is the final convergence,
    ``meta.truth`` the loop's truth summary."""
    from gossip_tpu_torch.topology import generators as G
    getattr(model, f"check_{mode}_mode")(proto)
    if run.engine not in ("auto", "xla"):
        raise ValueError(f"engine={run.engine!r} cannot run the {mode} "
                         "workload (XLA pull kernels only)")
    topo = G.build(tc, dev)
    t0 = time.perf_counter()
    if want_curve:
        (conv, msgs, _, truth), steady = steady_timed(
            dev, getattr(model, f"simulate_curve_{mode}"), cfg, proto, topo,
            run, fault, device=dev)
        rounds, cv, msgs_f, curve = _curve_summary(conv, msgs,
                                                   run.target_coverage)
    else:
        (rounds, cv, msgs_f, _, truth), steady = steady_timed(
            dev, getattr(model, f"simulate_until_{mode}"), cfg, proto, topo,
            run, fault, device=dev)
        curve = None
    wall = time.perf_counter() - t0
    return RunReport(
        backend=f"torch-{dev.type}", mode=mode, n=tc.n, rounds=rounds,
        coverage=cv, msgs=msgs_f, wall_s=round(wall, 4), curve=curve,
        meta={"clock": "rounds", "devices": 1,
              "msgs_counts": "transmissions", "engine": f"{mode}-xla",
              "workload": mode, "truth": truth,
              "device": _device_name(dev),
              **timing_meta(0.0, steady, wall)})


def run_log_workload(proto: ProtocolConfig, tc: TopologyConfig,
                     run: RunConfig, log_cfg, fault: Optional[FaultConfig],
                     want_curve: bool, dev: torch.device) -> RunReport:
    """The replicated-log workload (:mod:`gossip_tpu_torch.models.log`)
    on the XLA engine: ``coverage`` is the final ``log_conv``, and
    ``meta.truth`` the acked-appends truth."""
    from gossip_tpu_torch.models import log
    return _run_payload_workload("log", log, proto, tc, run, log_cfg, fault,
                                 want_curve, dev)


def run_txn_workload(proto: ProtocolConfig, tc: TopologyConfig,
                     run: RunConfig, txn_cfg, fault: Optional[FaultConfig],
                     want_curve: bool, dev: torch.device) -> RunReport:
    """The LWW-register transaction workload
    (:mod:`gossip_tpu_torch.models.register`) on the XLA engine:
    ``coverage`` is the final ``txn_conv``, and ``meta.truth`` the
    acked-writes LWW truth.  Without ``defend``, as the reference's."""
    from gossip_tpu_torch.models import register
    return _run_payload_workload("txn", register, proto, tc, run, txn_cfg,
                                 fault, want_curve, dev)


def run_ensemble(proto: ProtocolConfig, tc: TopologyConfig, run: RunConfig,
                 fault: Optional[FaultConfig] = None, seeds=None,
                 count: Optional[int] = None, group=None, device=None):
    """A seed ensemble (:mod:`gossip_tpu_torch.parallel.sweep`), the mode
    dispatch of the reference's ``run_ensemble``: SI modes, rumor
    mongering (residue and extinction distributions) and SWIM (the
    detection-latency distribution of one scenario).  Pass ``seeds``, or
    ``count`` (seeds ``run.seed + i``).  ``group``: each rank runs its
    slice of the seeds (value-invariant), on ``group.device``; else on
    ``device`` (default CUDA).  Returns ``(ensemble result, the
    mode's report keys)``."""
    from gossip_tpu_torch.parallel import sweep as SWP
    from gossip_tpu_torch.topology import generators as G
    if run.engine == "fused":
        # the reference's words
        raise ValueError("ensembles run the threefry XLA kernels; "
                         "engine='fused' is single-run only")
    if seeds is None and count is not None:
        seeds = [run.seed + i for i in range(int(count))]
    seeds = list(seeds) if seeds else None
    if not seeds:
        raise ValueError("need at least one seed (pass seeds or count)")
    dev = group.device if group is not None else resolve_device(device)
    extra: Dict[str, Any] = {}
    if proto.mode == C.RUMOR:
        ens = SWP.ensemble_rumor_curves(proto, G.build(tc, dev), run, seeds,
                                        fault, group=group, device=dev)
    elif proto.mode == C.SWIM:
        dead, fail_round, extra = swim_scenario_meta(proto, tc.n, fault)
        topo = None if tc.family == C.COMPLETE else G.build(tc, dev)
        ens = SWP.ensemble_swim_curves(proto, tc.n, run, seeds,
                                       dead_nodes=dead,
                                       fail_round=fail_round, fault=fault,
                                       topo=topo, group=group, device=dev)
        if proto.swim_rotate:
            # the headline is each seed's peak (the solo drivers')
            peaks = ens.curves.max(axis=1)
            extra["subject_window"] = "rotating"
            extra["peak_detection_mean"] = float(peaks.mean())
            extra["peak_detection_min"] = float(peaks.min())
    else:
        ens = SWP.ensemble_curves(proto, G.build(tc, dev), run, seeds,
                                  fault, group=group, device=dev)
    return ens, extra


def run_simulation(proto: ProtocolConfig, topo: TopologyConfig,
                   run: RunConfig, fault: Optional[FaultConfig] = None,
                   want_curve: bool = False, device=None,
                   mesh_cfg: Optional[MeshConfig] = None,
                   log_cfg=None, txn_cfg=None) -> RunReport:
    """Run one simulation with ``run.engine`` (module doc): on one
    device, or with ``mesh_cfg.n_devices > 1`` on the fused rumor planes
    or the node-sharded drivers (:func:`run_sharded`).  ``meta`` names what ran: ``engine``
    (``fused-cuda`` / ``fused-plain`` for the fused route, ``bit-packed``
    for the packed XLA rounds, absent for the bool rounds, as in the
    reference), ``engine_auto`` when ``auto`` picked the fused route (on
    a CUDA device only),
    every kernel's launches, and the wall's parts."""
    reason = _refusal(proto, run, fault, mesh_cfg, log_cfg, txn_cfg)
    if reason is not None:
        raise ValueError(reason)
    NE.validate_events(fault, topo.n)
    if txn_cfg is not None:
        return run_txn_workload(proto, topo, run, txn_cfg, fault,
                                want_curve, resolve_device(device))
    if log_cfg is not None:
        return run_log_workload(proto, topo, run, log_cfg, fault,
                                want_curve, resolve_device(device))
    if mesh_cfg is not None and mesh_cfg.n_devices > 1:
        if run.engine == "fused":
            reason = fused_ineligible_reason(proto, topo, run, fault,
                                             mesh_cfg.n_devices)
            if reason is not None:
                raise ValueError(reason)
        return run_sharded(proto, topo, run, fault, mesh_cfg, want_curve,
                           device)
    fused_reason = fused_ineligible_reason(proto, topo, run, fault)
    if run.engine == "fused" and fused_reason is not None:
        raise ValueError(fused_reason)
    dev = resolve_device(device)
    if run.engine == "fused" or (run.engine == "auto" and fused_reason is None
                                 and dev.type == "cuda"):
        rep = _run_fused(proto, topo, run, fault, want_curve, dev)
        if run.engine == "auto":
            rep.meta["engine_auto"] = "fused"
        return rep
    return _run_xla(proto, topo, run, fault, want_curve, dev)
