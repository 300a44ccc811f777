"""Command line of the port: ``python -m gossip_tpu_torch
run|grid|churn-sweep|crdt|log|txn``.

The port of the JAX package's ``run``, ``grid``, ``churn-sweep``,
``crdt``, ``log`` and ``txn`` commands::

    python -m gossip_tpu_torch run --mode pull --n 10000000 [--engine E] \\
        [--family F] [--k K] [--p P] [--degree-cap D] [--rumors R]
        [--fanout F] [--period T] [--seed S] [--origin O] [--target C]
        [--max-rounds M] [--drop P] [--death D] [--curve]
        [--rumor-k K] [--rumor-variant feedback|blind]
        [--swim-subjects S] [--swim-proxies K] [--swim-suspect-rounds T]
        [--swim-rotate] [--swim-epoch-rounds E]
        [--swim-diss scatter|sort|pack] [--swim-rng split|packed]
        [--dead-nodes ID...] [--fail-round R]
        [--churn-event NODE:DIE[:REC]]... [--partition START:END:CUT]...
        [--drop-ramp START:END:P0:P1] [--save-curve PATH]
        [--devices K [--exchange dense|sparse|halo] [--share-card]]
        [--ensemble S] [--device cpu]
    python -m gossip_tpu_torch grid [--modes M...] [--fanouts F...] \\
        [--drops P...] [--periods T...] [--seeds S...] [--n N | --ns N...]
        [--rumors R...] [--family F | --families F...] [--k K] [--p P]
        [--degree-cap D] [--target C] [--max-rounds M] [--seed S]
        [--death D] [--curve] [--devices K | --pod-mesh S N]
        [--share-card] [--device cpu]
    python -m gossip_tpu_torch churn-sweep --scenario SPEC... \\
        [--engine xla|fused] [--n N] [--family F] [--k K] [--p P]
        [--mode M] [--fanout F] [--rumors R] [--period T] [--target C]
        [--max-rounds M] [--seed S] [--drop P] [--death D] [--curve]
        [--devices K] [--share-card] [--device cpu]
    python -m gossip_tpu_torch crdt --type gcounter|pncounter|gset|orset \\
        [--n N] [--fanout F] [--family F] [--k K] [--p P] [--target C]
        [--max-rounds M] [--seed S] [--origin O] [--drop P] [--death D]
        [--add NODE:ROUND:AMOUNT]... [--set-add ELEM:ROUND]...
        [--set-remove ELEM:ROUND]... [--elements E] [churn flags]
        [--byz NODE:ROUND:KIND[:ARG]]... [--byz-quorum Q] [--defend]
        [--curve] [--save-curve PATH] [--devices K [--share-card]]
        [--device cpu]
    python -m gossip_tpu_torch log [--n N] [--keys K] [--capacity C] \\
        [--send NODE:KEY:ROUND:VALUE]... [--commit NODE:KEY:ROUND:UPTO]...
        [the crdt command's topology, run and churn flags] [--curve]
        [--save-curve PATH] [--devices K [--share-card]] [--device cpu]
    python -m gossip_tpu_torch txn [--n N] [--keys K] [--txns T] \\
        [--zipf-alpha A] [--hot-key H] [--load uniform|diurnal]
        [--spread S] [--write NODE:KEY:ROUND:VALUE]...
        [the crdt command's topology, run, churn and byz flags]
        [--curve] [--save-curve PATH] [--devices K [--share-card]]
        [--device cpu]

``--mode`` is one of the five SI modes, ``swim`` or ``rumor``, and
``--engine`` one of ``auto|xla|fused`` (default ``auto``:
``backend.run_simulation``'s rule, the fused kernel on a card where it is
eligible, the xla engine otherwise and on the CPU).  The flags, their defaults and their parse
are the JAX command's (``--drop-prob`` is another name for ``--drop``;
``--swim-suspect-rounds 0`` is ``suggested_suspect_rounds(n, fanout)``
for SWIM and 4 otherwise).  The topology and the fault take ``--seed``
as their seeds too, as the JAX command sets them.  The three churn flags
build a fault program (``ChurnConfig``), which runs on the xla engine
(``auto`` takes it; ``fused`` refuses it on one device).  ``--devices K``
above 1 runs K ranks (``backend.run_sharded``): NCCL with a card a rank,
gloo with ``--device cpu`` or ``--share-card`` (K ranks on one card).
With ``--engine fused`` they shard rumor planes (pull on the complete
graph, any number of rumors, static deaths and drops and the whole fault
program; ``parallel/sharded_fused.py``); otherwise the SI modes run on
the node-sharded drivers, SWIM and rumor mongering on their own sharded
rounds, with ``--exchange sparse`` (pull and anti-entropy, all_to_all)
or ``halo`` (banded tables, ppermute) in place of the dense all_gather.
``run --ensemble S`` (S above 1) runs the seeds ``--seed + i`` as one
batch (``backend.run_ensemble``, :mod:`gossip_tpu_torch.parallel.sweep`)
and prints the reference's ensemble report; ``--devices K`` shards the
seed axis (the exchange must stay dense), and ``--engine fused`` is
refused.  ``grid`` runs the cartesian product of its lists as one batch
a mode bucket (one line a point), or with ``--devices K`` one batch
sharded over the config axis, or with ``--pod-mesh S N`` configs over S
and nodes over N ranks.  ``churn-sweep`` runs its ``--scenario``
programs as one batch (``--engine xla``, ``--devices`` sharding the
scenarios) or through the fused rumor planes (``--engine fused``,
``--devices`` sharding the planes).  Each adds the port's keys to the
reference's report: the device, the walls, the peak memory and the
kernel launches (every rank's, with the collectives' time, on ranks).

``run``, ``crdt``, ``log`` and ``txn`` first call
``parallel.multislice.maybe_init_distributed``: started by ``torchrun``
(``MASTER_ADDR``, ``RANK`` and ``WORLD_SIZE`` set) or with
``GOSSIP_TPU_MULTIHOST=1``, the process joins the launcher's group
(gloo with ``--device cpu`` or ``--share-card``, else NCCL on
``cuda:LOCAL_RANK``) and ``--devices K`` runs as its rank, on one host
or several; otherwise nothing happens.  ``--save-curve PATH``
writes the curve as the reference's JSONL, the report as its meta line.
It prints the report's JSON on one line, as the JAX command does.  Any
other flag or value is refused with exit code 2, and so is a run the
backend refuses (with its reason on stderr).  Without ``--device cpu``
the run needs a CUDA device.

``crdt``, ``log`` and ``txn`` (:mod:`gossip_tpu_torch.models.crdt`,
:mod:`gossip_tpu_torch.models.log`,
:mod:`gossip_tpu_torch.models.register`) take the JAX commands' flags and
print their reports' fields in their order (``backend`` the port's
name; ``engine`` the reference's: ``crdt-xla`` on one device,
``crdt-sharded`` on the mesh, and so on), then the device, the steady
wall and, on a card, the peak of allocated device memory.  ``--devices
K`` above 1 runs K ranks of the node-sharded payload drivers
(:mod:`gossip_tpu_torch.parallel.sharded_crdt`, ``sharded_log``,
``sharded_register``), as ``run`` does: NCCL with a card a rank, gloo
with ``--device cpu`` or ``--share-card``, or inside a ``torchrun``
group as the launched rank; the report adds the process group, each
collective's time and every rank's peak memory.  The JAX commands'
``--compile-cache`` / ``--no-compile-cache`` configure its XLA
executable store, which the port does not have: they are not taken,
and ``compile_cache`` is null.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (ByzConfig, ChurnConfig, CrdtConfig,
                                     FaultConfig, LogConfig, MeshConfig,
                                     ProtocolConfig, RunConfig,
                                     TopologyConfig, TxnConfig)


PAYLOAD_COMMANDS = ("crdt", "log", "txn")


def _parse_churn(a) -> Optional[ChurnConfig]:
    """``--churn-event`` / ``--partition`` / ``--drop-ramp`` -> a
    :class:`ChurnConfig`, or None without any (the JAX command's parse;
    the checks of the fields live in ``ChurnConfig``)."""
    def fields(s, what, lens):
        parts = s.split(":")
        if len(parts) not in lens:
            raise ValueError(
                f"--{what} takes {'|'.join(map(str, sorted(lens)))} "
                f"colon-separated fields, got {s!r}")
        return parts

    events = []
    for s in (getattr(a, "churn_event", None) or ()):
        parts = fields(s, "churn-event", {2, 3})
        if len(parts) == 2:
            parts.append("-1")
        events.append(tuple(int(x) for x in parts))
    partitions = [tuple(int(x) for x in fields(s, "partition", {3}))
                  for s in (getattr(a, "partition", None) or ())]
    ramp = None
    if getattr(a, "drop_ramp", None):
        f = fields(a.drop_ramp, "drop-ramp", {4})
        ramp = (int(f[0]), int(f[1]), float(f[2]), float(f[3]))
    if not (events or partitions or ramp):
        return None
    return ChurnConfig(events=tuple(events), partitions=tuple(partitions),
                       ramp=ramp)


def _parse_byz(a):
    """``--byz NODE:ROUND:KIND[:ARG]`` (and ``--byz-quorum``) -> a
    :class:`ByzConfig`, or None (the JAX command's parse; the checks of
    the fields live in ``ByzConfig``)."""
    specs = getattr(a, "byz", None) or ()
    if not specs:
        return None
    liars = []
    for s in specs:
        p = s.split(":")
        if len(p) not in (3, 4):
            raise ValueError("--byz takes NODE:ROUND:KIND[:ARG] "
                             f"colon-separated fields, got {s!r}")
        liars.append((int(p[0]), int(p[1]), p[2],
                      int(p[3]) if len(p) == 4 else 0))
    return ByzConfig(liars=tuple(liars), quorum=getattr(a, "byz_quorum", 2))


def _colon_ints(specs, what: str, arity: int) -> tuple:
    """Repeatable ``A:B:...`` flags -> tuples of ints."""
    out = []
    for s in specs or ():
        p = s.split(":")
        if len(p) != arity:
            raise ValueError(f"--{what} takes {arity} colon-separated "
                             f"fields, got {s!r}")
        out.append(tuple(int(x) for x in p))
    return tuple(out)


def _payload_setup(a, byz=None):
    """(proto, topology config, run, fault) of a payload command."""
    churn = _parse_churn(a)
    fault = None
    if a.drop > 0 or a.death > 0 or churn is not None or byz is not None:
        fault = FaultConfig(node_death_rate=a.death, drop_prob=a.drop,
                            seed=a.seed, churn=churn, byz=byz)
    tc = TopologyConfig(family=a.family, n=a.n, k=a.k, p=a.p, seed=a.seed)
    run = RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                    seed=a.seed, origin=a.origin)
    return ProtocolConfig(mode=C.PULL, fanout=a.fanout), tc, run, fault


def _loop(mode: str, sharded: bool, want_curve: bool):
    """The payload's curve or until loop, on one device or sharded."""
    if sharded:
        from gossip_tpu_torch.parallel import (sharded_crdt, sharded_log,
                                               sharded_register)
        mod = {"crdt": sharded_crdt, "log": sharded_log,
               "txn": sharded_register}[mode]
    else:
        from gossip_tpu_torch.models import crdt, log, register
        mod = {"crdt": crdt, "log": log, "txn": register}[mode]
    kind = "curve" if want_curve else "until"
    return getattr(mod, f"simulate_{kind}_{mode}"
                   + ("_sharded" if sharded else ""))


def _payload_rank(mode, cfg, proto, tc, run, fault, want_curve, kw,
                  keep_state, group):
    """One rank of a sharded payload command: ``(loop result, wall,
    the port's report keys)``, every rank's kernel launches among them,
    the final state dropped unless ``keep_state`` (it stays this rank's
    rows)."""
    from gossip_tpu_torch.backend import _launch_counts, _rank_launches
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.topology import generators as G
    dev = group.device
    topo = G.build(tc, dev)
    group.collective_ms(reset=True)
    launches0 = _launch_counts()
    result, wall, extra = _timed(dev, _loop(mode, True, want_curve), cfg,
                                 proto, topo, run, group, fault, **kw)
    rounds = run.max_rounds if want_curve else result[0]
    extra.update({
        "process_group": group.backend,
        "collective_ms": {k: {**c, "ms_per_round": c["ms"] / max(rounds, 1)}
                          for k, c in group.collective_ms().items()},
        "rank_peak_mem_bytes": GR.peak_memory(group),
        "rank_launches": _rank_launches(group, launches0)})
    if not keep_state:
        result = tuple(None if hasattr(x, "val") else x for x in result)
    return result, wall, extra


def _payload_loop(a, mode: str, cfg, fault_byz=None, keep_state=True,
                  **kw):
    """Run a payload command's loop: on one device, or with ``--devices
    K`` above 1 on K ranks of the sharded drivers (NCCL with a card a
    rank, gloo with ``--device cpu`` or ``--share-card``; inside a
    process group that is up, as this rank).  Returns ``(fault,
    want_curve, result, wall, the port's report keys)``; a sharded
    result's final state is every rank's rows in rank order, padded,
    kept only with ``keep_state``."""
    from gossip_tpu_torch.ops.common import resolve_device
    from gossip_tpu_torch.topology import generators as G
    proto, tc, run, fault = _payload_setup(a, fault_byz)
    want_curve = a.curve or bool(a.save_curve)
    if a.devices <= 1:
        dev = resolve_device(a.device)
        result, wall, extra = _timed(dev, _loop(mode, False, want_curve),
                                     cfg, proto, G.build(tc, dev), run,
                                     fault, device=dev, **kw)
        return fault, want_curve, result, wall, extra
    import torch.distributed as dist

    from gossip_tpu_torch.parallel import group as GR
    args = (mode, cfg, proto, tc, run, fault, want_curve, kw, keep_state)
    if dist.is_available() and dist.is_initialized():
        group = GR.current(a.device)
        if group.size != a.devices:
            raise ValueError(f"the process group has {group.size} ranks; "
                             f"--devices asks for {a.devices}")
        ranks = [_payload_rank(*args, group=group)]
    else:
        ranks = GR.launch(_payload_rank, a.devices, *args, device=a.device,
                          shared_card=a.share_card)
    result, wall, extra = ranks[0]
    if keep_state and len(ranks) == a.devices:
        import torch
        i = next(j for j, x in enumerate(result) if hasattr(x, "val"))
        val = torch.cat([r[0][i].val for r in ranks])
        result = result[:i] + (result[i]._replace(val=val),) + result[i + 1:]
    return fault, want_curve, result, wall, extra


def _summary(a, want_curve, result):
    """(rounds, convergence, msgs) of a payload loop's result: the until
    loop's, or the curve's first round at the target (-1 if never) and
    its last values."""
    if not want_curve:
        return result[0], result[1], result[2]
    conv, msgs = result[0], result[1]
    hit = [i for i, c in enumerate(conv) if c >= a.target]
    return (hit[0] + 1) if hit else -1, float(conv[-1]), float(msgs[-1])


def _timed(dev, fn, *args, **kwargs):
    """(result, wall seconds, the port's report keys) of one payload
    loop: the device, the steady wall and, on a card, the peak of
    allocated memory."""
    import time

    import torch

    from gossip_tpu_torch.utils.timing import steady_timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result, steady = steady_timed(dev, fn, *args, **kwargs)
    wall = time.perf_counter() - t0
    return result, wall, {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "steady_wall_s": round(steady, 4),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def _finish(a, out, result, want_curve, extra):
    """``--save-curve`` (the reference's JSONL, the report as its meta),
    ``--curve``, then the port's keys: ``(report, loop result)``."""
    conv = result[0] if want_curve else ()
    if a.save_curve:
        from gossip_tpu_torch.utils.metrics import dump_curve_jsonl
        dump_curve_jsonl(a.save_curve, [float(c) for c in conv],
                         meta=dict(out))
    if a.curve:
        out["curve"] = [float(c) for c in conv]
    out.update(extra)
    return out, result


def _engine(a, mode: str) -> str:
    """The reference's ``engine`` of a payload report."""
    return f"{mode}-sharded" if a.devices > 1 else f"{mode}-xla"


def _backend_device(extra) -> str:
    return "cpu" if extra["device"] == "cpu" else "cuda"


def run_crdt(a, keep_state: bool = True):
    """A CRDT payload run (the JAX command's ``crdt``): value convergence
    judged integer-exact against the ground-truth merge on the
    eventual-alive set.  Returns ``(report, loop result)``."""
    cfg = CrdtConfig(kind=a.type, elements=a.elements,
                     adds=_colon_ints(a.add, "add", 3),
                     set_adds=_colon_ints(a.set_add, "set-add", 2),
                     set_removes=_colon_ints(a.set_remove, "set-remove", 2))
    byz = _parse_byz(a)
    fault, want_curve, result, wall, extra = _payload_loop(
        a, "crdt", cfg, byz, keep_state, defend=a.defend)
    rounds, vc, msgs = _summary(a, want_curve, result)
    out = {"backend": f"torch-{_backend_device(extra)}", "mode": "crdt",
           "type": a.type, "n": a.n, "rounds": rounds, "value_conv": vc,
           "converged": vc >= a.target, "truth_value": result[-1],
           "msgs": msgs, "wall_s": round(wall, 4), "devices": a.devices,
           "engine": _engine(a, "crdt"), "compile_cache": None}
    if fault is not None and fault.churn is not None:
        out["fault_program"] = True
    if byz is not None:
        out["byz_program"] = True
        out["defended"] = bool(a.defend)
    return _finish(a, out, result, want_curve, extra)


def run_log(a, keep_state: bool = True):
    """A replicated-log run (the JAX command's ``log``): convergence
    judged integer-exact against the acked-appends truth on the
    eventual-alive set.  Returns ``(report, loop result)``."""
    cfg = LogConfig(keys=a.keys, capacity=a.capacity,
                    sends=_colon_ints(a.send, "send", 4),
                    commits=_colon_ints(a.commit, "commit", 4))
    fault, want_curve, result, wall, extra = _payload_loop(
        a, "log", cfg, None, keep_state)
    rounds, lc, msgs = _summary(a, want_curve, result)
    out = {"backend": f"torch-{_backend_device(extra)}", "mode": "log",
           "n": a.n, "keys": a.keys, "capacity": a.capacity,
           "rounds": rounds, "log_conv": lc, "converged": lc >= a.target,
           "truth": result[-1], "msgs": msgs, "wall_s": round(wall, 4),
           "devices": a.devices, "engine": _engine(a, "log"),
           "compile_cache": None}
    if fault is not None and fault.churn is not None:
        out["fault_program"] = True
    return _finish(a, out, result, want_curve, extra)


def run_txn(a, keep_state: bool = True):
    """An LWW-register transaction run (the JAX command's ``txn``):
    convergence judged integer-exact against the acked-writes LWW truth
    on the eventual-alive set.  Returns ``(report, loop result)``."""
    cfg = TxnConfig(keys=a.keys, txns=a.txns, zipf_alpha=a.zipf_alpha,
                    hot_key=a.hot_key, load=a.load, spread_rounds=a.spread,
                    writes=_colon_ints(a.write, "write", 4))
    byz = _parse_byz(a)
    fault, want_curve, result, wall, extra = _payload_loop(
        a, "txn", cfg, byz, keep_state, defend=a.defend)
    rounds, tcv, msgs = _summary(a, want_curve, result)
    out = {"backend": f"torch-{_backend_device(extra)}", "mode": "txn",
           "n": a.n, "keys": a.keys, "rounds": rounds, "txn_conv": tcv,
           "converged": tcv >= a.target, "truth": result[-1],
           "msgs": msgs, "wall_s": round(wall, 4), "devices": a.devices,
           "engine": _engine(a, "txn"), "zipf_alpha": a.zipf_alpha,
           "hot_key": a.hot_key, "load": a.load, "compile_cache": None}
    if fault is not None and fault.churn is not None:
        out["fault_program"] = True
    if byz is not None:
        out["byz_program"] = True
        out["defended"] = bool(a.defend)
    return _finish(a, out, result, want_curve, extra)


def _add_payload_flags(p, conv: str) -> None:
    """The flags the JAX package's payload commands share."""
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--fanout", type=int, default=2)
    p.add_argument("--family", default=C.COMPLETE, choices=C.FAMILIES)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--p", type=float, default=0.01)
    p.add_argument("--target", type=float, default=1.0,
                   help=f"{conv} target (default 1.0: every eventual-alive "
                        "node equals the ground truth exactly)")
    p.add_argument("--max-rounds", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--origin", type=int, default=0)
    p.add_argument("--devices", type=int, default=1,
                   help="node-dim mesh size (one rank a device: NCCL with a "
                        "card a rank, gloo with --device cpu)")
    p.add_argument("--share-card", action="store_true",
                   help="run the --devices ranks on one card under gloo "
                        "(a test mode: NCCL takes one card a rank)")
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--death", type=float, default=0.0)


def _add_byz_flags(p) -> None:
    """The liar-program flags of the ``crdt`` and ``txn`` commands."""
    p.add_argument("--byz", action="append", default=None,
                   metavar="NODE:ROUND:KIND[:ARG]",
                   help="scripted byzantine liar: from ROUND on, NODE "
                        "serves forged state of KIND (corrupt | replay | "
                        "equivocate | inflate); repeatable")
    p.add_argument("--byz-quorum", type=int, default=2,
                   help="independent-witness count q for defended set "
                        "bit admission (1-3; needs fanout >= q)")
    p.add_argument("--defend", action="store_true",
                   help="the defended admission (owner-column guards, "
                        "quorum echo, owner-provenance timestamps); off = "
                        "the undefended control arm")


def _add_tail_flags(p, conv: str) -> None:
    """Churn, curve, cache and device flags of the payload commands."""
    p.add_argument("--churn-event", action="append", default=None,
                   metavar="NODE:DIE[:REC]",
                   help="nemesis crash/recover churn (repeatable)")
    p.add_argument("--partition", action="append", default=None,
                   metavar="START:END:CUT",
                   help="nemesis partition window (repeatable)")
    p.add_argument("--drop-ramp", default=None, metavar="START:END:P0:P1",
                   help="nemesis drop-rate ramp")
    p.add_argument("--curve", action="store_true",
                   help=f"include the per-round {conv} curve")
    p.add_argument("--save-curve", default=None, metavar="PATH",
                   help=f"write the {conv} curve as JSONL")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs on the CPU (default: cuda, which must "
                        "be present)")


def run_payload(argv):
    """``(report, loop result)`` of a ``crdt``, ``log`` or ``txn``
    command line, parsed, run and reported as :func:`main` does, without
    printing; the result holds the loop's final state (with ``--devices``
    above 1, every rank's rows in rank order, padded)."""
    a = build_parser().parse_args(argv)
    if a.cmd not in PAYLOAD_COMMANDS:
        raise ValueError(f"{a.cmd!r} is not a payload command")
    return a.fn(a)


def run_configs(a):
    """``(proto, topology config, run, fault)`` of the ``run`` command's
    arguments ``a``."""
    churn = _parse_churn(a)
    fault = None
    if a.drop > 0 or a.death > 0 or a.dead_nodes or churn is not None:
        fault = FaultConfig(node_death_rate=a.death, drop_prob=a.drop,
                            seed=a.seed, dead_nodes=tuple(a.dead_nodes or ()),
                            fail_round=a.fail_round, churn=churn)
    t = a.swim_suspect_rounds
    if not t and a.mode == C.SWIM:
        from gossip_tpu_torch.models.swim import suggested_suspect_rounds
        t = suggested_suspect_rounds(a.n, a.fanout)
    return (
        ProtocolConfig(mode=a.mode, fanout=a.fanout, rumors=a.rumors,
                       period=a.period, swim_subjects=a.swim_subjects,
                       swim_proxies=a.swim_proxies,
                       swim_suspect_rounds=t or 4,
                       swim_rotate=a.swim_rotate,
                       swim_epoch_rounds=a.swim_epoch_rounds,
                       swim_diss=a.swim_diss, swim_rng=a.swim_rng,
                       rumor_k=a.rumor_k, rumor_variant=a.rumor_variant),
        TopologyConfig(family=a.family, n=a.n, k=a.k, p=a.p,
                       degree_cap=a.degree_cap, seed=a.seed),
        RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                  seed=a.seed, origin=a.origin, engine=a.engine),
        fault)


def _on_ranks(a, fn, *args, spawn_one: bool = False):
    """``fn(*args, group=...)``'s results, rank 0's first: in this process
    without a group (``--devices`` 1, unless ``spawn_one``), as this rank
    of a process group that is up, or on ``--devices`` spawned ranks
    (NCCL with a card a rank, gloo with ``--device cpu`` or
    ``--share-card``)."""
    import torch.distributed as dist

    from gossip_tpu_torch.parallel import group as GR
    if a.devices <= 1 and not spawn_one:
        return [fn(*args, group=None)]
    if dist.is_available() and dist.is_initialized():
        group = GR.current(a.device)
        if group.size != a.devices:
            raise ValueError(f"the process group has {group.size} ranks; "
                             f"--devices asks for {a.devices}")
        return [fn(*args, group=group)]
    return GR.launch(fn, a.devices, *args, device=a.device,
                     shared_card=a.share_card)


def _measured(dev, group, fn, /, *args, **kwargs):
    """``(fn's result, the port's report keys)``: the device, the wall
    and steady seconds, and the peak allocated memory and kernel
    launches (every rank's, with the process group's backend and each
    collective's time, under a ``group``)."""
    import time

    import torch

    from gossip_tpu_torch.backend import (_device_name, _launch_counts,
                                          _rank_launches)
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.utils.timing import steady_timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if group is not None:
        group.collective_ms(reset=True)
    launches0 = _launch_counts()
    t0 = time.perf_counter()
    result, steady = steady_timed(dev, fn, *args, **kwargs)
    keys = {"device": _device_name(dev),
            "wall_s": round(time.perf_counter() - t0, 4),
            "steady_wall_s": round(steady, 4)}
    if group is None:
        now = _launch_counts()
        keys.update({"peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else None),
                     "launches": {k: now[k] - launches0[k] for k in now}})
    else:
        keys.update({"process_group": group.backend,
                     "collective_ms": group.collective_ms(),
                     "rank_peak_mem_bytes": GR.peak_memory(group),
                     "rank_launches": _rank_launches(group, launches0)})
    return result, keys


def _rank_device(a, group):
    from gossip_tpu_torch.ops.common import resolve_device
    return group.device if group is not None else resolve_device(a.device)


def _ensemble_rank(a, group=None):
    """One rank's share of ``run --ensemble``: ``(result, the mode's
    report keys, the port's keys)``."""
    from gossip_tpu_torch.backend import run_ensemble
    dev = _rank_device(a, group)
    proto, tc, run, fault = run_configs(a)
    (ens, extra), keys = _measured(dev, group, run_ensemble, proto, tc, run,
                                   fault, count=a.ensemble, group=group,
                                   device=dev)
    return ens, extra, keys


def cmd_ensemble(a) -> int:
    """``run --ensemble S``: S seeds (``--seed + i``) as one batch, the
    reference's report (the ensemble's summary and the mode's keys),
    then the port's keys; ``--devices K`` shards the seed axis."""
    if a.devices > 1 and a.exchange != "dense":
        # the reference's words
        print("error: --ensemble shards the SEED axis; "
              "--exchange does not apply (drop it)", file=sys.stderr)
        return 2
    ens, extra, keys = _on_ranks(a, _ensemble_rank, a)[0]
    out = {"ensemble": ens.summary(), "mode": a.mode, "n": a.n,
           "backend": f"torch-{'cpu' if keys['device'] == 'cpu' else 'cuda'}",
           **extra}
    if a.save_curve:
        # the per-round band over seeds: mean, min and max
        import numpy as np

        from gossip_tpu_torch.utils.metrics import dump_curve_jsonl
        dump_curve_jsonl(a.save_curve, ens.curves.mean(axis=0),
                         meta={**out, "band_min": np.round(
                             ens.curves.min(axis=0), 6).tolist(),
                             "band_max": np.round(
                                 ens.curves.max(axis=0), 6).tolist()})
    if a.curve:
        out["curve_mean"] = [float(c) for c in ens.curves.mean(axis=0)]
    out.update({"devices": a.devices, **getattr(ens, "meta", {}), **keys})
    print(json.dumps(out))
    return 0


def cmd_run(a) -> int:
    if a.ensemble > 1:
        return cmd_ensemble(a)
    from gossip_tpu_torch.backend import run_simulation
    mesh = (MeshConfig(n_devices=a.devices, exchange=a.exchange,
                       shared_card=a.share_card) if a.devices > 1 else None)
    want_curve = a.curve or bool(a.save_curve)
    report = run_simulation(*run_configs(a), want_curve=want_curve,
                            device=a.device, mesh_cfg=mesh)
    out = report.to_dict()
    if a.save_curve:
        from gossip_tpu_torch.utils.metrics import dump_curve_jsonl
        meta = dict(out)
        dump_curve_jsonl(a.save_curve, meta.pop("curve"), meta=meta)
        if not a.curve:          # the curve went to the file
            out["curve"] = None
    print(json.dumps(out))
    return 0


def grid_points(a):
    """``(points, [(family, n)])`` of a ``grid`` command line: the
    cartesian product of its lists, the reference's order, topo_idx t
    the pair ``t``."""
    from gossip_tpu_torch.parallel.sweep import SweepPoint
    families = a.families or [a.family]
    ns = a.ns or [a.n]
    fam_n = [(f, n) for f in families for n in ns]
    points = [
        SweepPoint(mode=m, fanout=f, drop_prob=d,
                   period=(p if m == C.ANTI_ENTROPY else 1), seed=s,
                   topo_idx=t, rumors=r)
        for t in range(len(fam_n))
        for m in a.modes for f in a.fanouts for d in a.drops
        for p in (a.periods if C.ANTI_ENTROPY in a.modes else [1])
        for s in a.seeds for r in a.rumors]
    # periods multiply only anti-entropy points; dedupe the rest
    return list(dict.fromkeys(points)), fam_n


def _grid_rank(a, group=None):
    """One rank's run of ``grid``: ``(result, the port's keys)``."""
    from gossip_tpu_torch.parallel import sweep as SWP
    from gossip_tpu_torch.topology import generators as G
    points, fam_n = grid_points(a)
    run = RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                    seed=a.seed)
    fault = (FaultConfig(node_death_rate=a.death, seed=a.seed)
             if a.death > 0 else None)
    if a.pod_mesh:
        from gossip_tpu_torch.parallel.multislice import make_hybrid_mesh
        mesh = make_hybrid_mesh(*a.pod_mesh, device=a.device)
        dev = mesh.inner.device
    else:
        dev = _rank_device(a, group)
    topos = [G.build(TopologyConfig(family=f, n=n, k=a.k, p=a.p,
                                    degree_cap=a.degree_cap, seed=a.seed),
                     dev) for f, n in fam_n]
    topo = topos if len(topos) > 1 else topos[0]
    if a.pod_mesh:
        return _measured(dev, mesh.inner, SWP.config_sweep_curves_2d,
                         points, topo, run, mesh, fault=fault)
    if group is not None:
        return _measured(dev, group, SWP.config_sweep_curves, points, topo,
                         run, fault=fault, group=group)
    # one device: a batch a mode bucket, so a pure bucket never pays
    # the other half
    return _measured(dev, None, SWP.config_sweep_curves_partitioned, points,
                     topo, run, fault=fault, device=dev)


def cmd_grid(a) -> int:
    """``grid``: the cartesian product of ``--modes``, ``--fanouts``,
    ``--drops``, ``--periods``, ``--seeds``, ``--rumors`` and the
    ``--families`` x ``--ns`` topologies as one batch
    (:func:`~gossip_tpu_torch.parallel.sweep.config_sweep_curves`); one
    JSON line a point, the reference's.  ``--devices K`` shards the
    config axis; ``--pod-mesh S N`` shards configs over S and every
    config's nodes over N ranks."""
    if any(r < 1 for r in a.rumors):
        print("error: --rumors values must be >= 1", file=sys.stderr)
        return 2
    if a.pod_mesh:
        a.devices = a.pod_mesh[0] * a.pod_mesh[1]
    res, _ = _on_ranks(a, _grid_rank, a, spawn_one=bool(a.pod_mesh))[0]
    points, fam_n = grid_points(a)
    for i, summary in enumerate(res.summaries()):
        fam, n = fam_n[points[i].topo_idx]
        summary["n"] = n
        summary["family"] = fam
        if a.curve:
            summary["curve"] = [float(c) for c in res.curves[i]]
        print(json.dumps(summary), flush=True)
    return 0


def parse_scenario(spec: str) -> ChurnConfig:
    """One ``--scenario`` spec -> a :class:`ChurnConfig`: ';'-separated
    ``event=NODE:DIE[:REC]`` / ``partition=START:END:CUT`` /
    ``ramp=START:END:P0:P1`` items, parsed as ``run``'s churn flags are
    (the reference's ``_parse_scenario``)."""
    events, partitions, ramp = [], [], None
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        key, _, val = item.partition("=")
        if key == "event":
            events.append(val)
        elif key == "partition":
            partitions.append(val)
        elif key == "ramp":
            if ramp is not None:
                raise ValueError(
                    f"scenario {spec!r} has more than one ramp")
            ramp = val
        else:
            raise ValueError(
                f"unknown scenario field {key!r} in {spec!r} "
                "(use event= / partition= / ramp=)")
    ch = _parse_churn(argparse.Namespace(
        churn_event=events or None, partition=partitions or None,
        drop_ramp=ramp))
    if ch is None:
        raise ValueError(f"scenario {spec!r} scripts no faults")
    return ch


def churn_sweep_configs(a):
    """``(proto, topology config, run, faults)`` of a ``churn-sweep``
    command line."""
    proto = ProtocolConfig(mode=a.mode, fanout=a.fanout, rumors=a.rumors,
                           period=a.period)
    tc = TopologyConfig(family=a.family, n=a.n, k=a.k, p=a.p, seed=a.seed)
    run = RunConfig(target_coverage=a.target, max_rounds=a.max_rounds,
                    seed=a.seed)
    faults = [FaultConfig(node_death_rate=a.death, drop_prob=a.drop,
                          seed=a.seed, churn=parse_scenario(s))
              for s in a.scenario]
    return proto, tc, run, faults


def _churn_rank(a, group=None):
    """One rank's run of ``churn-sweep``: ``(result, the port's
    keys)``."""
    from gossip_tpu_torch.parallel import group as GR
    from gossip_tpu_torch.parallel import sweep as SWP
    from gossip_tpu_torch.topology import generators as G
    proto, tc, run, faults = churn_sweep_configs(a)
    dev = _rank_device(a, group)
    if a.engine == "fused":
        if group is None:          # one rank: a one-rank plane mesh
            with GR.local(dev) as one:
                return _measured(dev, one, SWP.fused_churn_sweep_curves,
                                 tc.n, proto.rumors, run, faults, one,
                                 proto.fanout)
        return _measured(dev, group, SWP.fused_churn_sweep_curves, tc.n,
                         proto.rumors, run, faults, group, proto.fanout)
    return _measured(dev, group, SWP.churn_sweep_curves, proto,
                     G.build(tc, dev), run, faults, group=group, device=dev)


def cmd_churn_sweep(a) -> int:
    """``churn-sweep``: K fault programs (``--scenario``, repeated) over
    one configuration.  ``--engine xla``: one batch
    (:func:`~gossip_tpu_torch.parallel.sweep.churn_sweep_curves`),
    ``--devices`` sharding the scenario axis; ``--engine fused``: the
    fused rumor planes, one scenario after another, ``--devices``
    sharding the plane axis.  The reference's report, then the port's
    keys."""
    from gossip_tpu_torch.backend import fused_ineligible_reason
    proto, tc, run, faults = churn_sweep_configs(a)
    if a.engine == "fused":
        reason = fused_ineligible_reason(proto, tc, run, faults[0],
                                         a.devices, plane_stack=True)
        if reason is not None:
            print(f"error: {reason}", file=sys.stderr)
            return 2
    elif a.devices > 1 and len(faults) % a.devices:
        print(f"error: {len(faults)} scenarios do not divide over "
              f"{a.devices} devices", file=sys.stderr)
        return 2
    res, keys = _on_ranks(a, _churn_rank, a)[0]
    out = {"churn_sweep": res.summaries(), "n": tc.n, "mode": a.mode,
           "engine": a.engine, "scenarios": len(faults),
           "target": run.target_coverage}
    if a.curve:
        out["curves"] = [[round(float(c), 6) for c in row]
                         for row in res.curves]
    out.update({"devices": a.devices, **getattr(res, "meta", {}), **keys})
    print(json.dumps(out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser; each command sets ``fn``."""
    ap = argparse.ArgumentParser(
        prog="gossip_tpu_torch",
        description="gossip simulation on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one simulation")
    p.add_argument("--mode", default=C.PUSH, choices=C.MODES)
    p.add_argument("--rumor-k", type=int, default=2,
                   help="rumor mongering: remove a rumor after this many "
                        "unnecessary (feedback) or total (blind) pushes")
    p.add_argument("--rumor-variant", default="feedback",
                   choices=C.RUMOR_VARIANTS)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--engine", default="auto", choices=("auto", "xla",
                                                        "fused"))
    p.add_argument("--family", default=C.COMPLETE, choices=C.FAMILIES)
    p.add_argument("--k", type=int, default=4,
                   help="ring/WS neighbors; BA attachment edges")
    p.add_argument("--p", type=float, default=0.01,
                   help="ER edge prob / WS rewire prob")
    p.add_argument("--degree-cap", type=int, default=None)
    p.add_argument("--fanout", type=int, default=1)
    p.add_argument("--rumors", type=int, default=1,
                   help="concurrent rumors (fused: up to 32 on one device, "
                        "one word per node; any number over --devices)")
    p.add_argument("--period", type=int, default=1,
                   help="anti-entropy exchange period (rounds)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--origin", type=int, default=0)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--max-rounds", type=int, default=256)
    p.add_argument("--drop", "--drop-prob", type=float, default=0.0,
                   help="per-message drop probability per round")
    p.add_argument("--death", type=float, default=0.0,
                   help="fraction of nodes statically dead")
    p.add_argument("--swim-subjects", type=int, default=8)
    p.add_argument("--swim-proxies", type=int, default=3)
    p.add_argument("--swim-suspect-rounds", type=int, default=0,
                   help="0 = use suggested_suspect_rounds(n)")
    p.add_argument("--swim-rotate", action="store_true",
                   help="rotate the subject window over all n nodes "
                        "(full-membership failure detection)")
    p.add_argument("--swim-epoch-rounds", type=int, default=0,
                   help="rounds per rotating-window epoch (0 = auto)")
    p.add_argument("--swim-diss", choices=("scatter", "sort", "pack"),
                   default="sort",
                   help="dissemination lowering (equal results)")
    p.add_argument("--swim-rng", choices=("split", "packed"),
                   default="split",
                   help="per-round draws: one threefry chain per quantity "
                        "(split) or one multi-word draw per node (packed)")
    p.add_argument("--dead-nodes", nargs="*", type=int, default=None,
                   metavar="ID",
                   help="node ids that fail at --fail-round (swim scenario; "
                        "default: node 1%%S fails at round 2)")
    p.add_argument("--fail-round", type=int, default=0)
    p.add_argument("--churn-event", action="append", default=None,
                   metavar="NODE:DIE[:REC]",
                   help="scripted crash/recover churn: NODE dies at round "
                        "DIE and recovers at round REC (omit REC or pass "
                        "-1 for a permanent crash); repeatable")
    p.add_argument("--partition", action="append", default=None,
                   metavar="START:END:CUT",
                   help="network partition window: for rounds [START, END) "
                        "every message crossing node-id CUT is lost; "
                        "repeatable, windows must not overlap")
    p.add_argument("--drop-ramp", default=None, metavar="START:END:P0:P1",
                   help="drop-rate ramp: link drop probability moves "
                        "linearly P0 -> P1 over rounds [START, END), then "
                        "holds P1")
    p.add_argument("--curve", action="store_true",
                   help="run exactly max_rounds rounds and include the "
                        "per-round coverage curve")
    p.add_argument("--save-curve", default=None, metavar="PATH",
                   help="write the coverage curve as JSONL (implies --curve)")
    p.add_argument("--devices", type=int, default=1,
                   help="mesh size (one rank a device: NCCL with a card a "
                        "rank, gloo with --device cpu): node-dim sharding, "
                        "or rumor planes with --engine fused")
    p.add_argument("--exchange", default="dense",
                   choices=("dense", "sparse", "halo"),
                   help="cross-shard pattern: dense all_gather (any), "
                        "sparse all_to_all (complete topology, "
                        "pull/antientropy, O(messages)), halo ppermute "
                        "(band-limited topologies, O(band))")
    p.add_argument("--share-card", action="store_true",
                   help="run the --devices ranks on one card under gloo "
                        "(a test mode: NCCL takes one card a rank)")
    p.add_argument("--ensemble", type=int, default=0, metavar="S",
                   help="run S seeds (--seed + i) as one batch and report "
                        "the distribution (SI modes, rumor, swim)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda, which "
                        "must be present)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("grid", help="batched config sweep: cartesian "
                       "product of modes/fanouts/drops/seeds as one batch")
    p.add_argument("--modes", nargs="+", default=["push", "pull", "pushpull"],
                   choices=(C.PUSH, C.PULL, C.PUSH_PULL, C.ANTI_ENTROPY))
    p.add_argument("--fanouts", nargs="+", type=int, default=[1, 2])
    p.add_argument("--drops", nargs="+", type=float, default=[0.0])
    p.add_argument("--periods", nargs="+", type=int, default=[2],
                   help="anti-entropy cadences (ignored for other modes)")
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--ns", nargs="+", type=int, default=None,
                   help="sweep several graph sizes in one batch (overrides "
                        "--n; smaller graphs pad with inert phantom rows, "
                        "or on the complete graph bound each point's draw "
                        "by its own n)")
    p.add_argument("--rumors", nargs="+", type=int, default=[1],
                   help="rumor counts to sweep (phantom columns pad to the "
                        "max; the pod mesh takes one value)")
    p.add_argument("--family", default=C.COMPLETE, choices=C.FAMILIES)
    p.add_argument("--families", nargs="+", default=None,
                   choices=tuple(f for f in C.FAMILIES if f != C.COMPLETE),
                   help="sweep several explicit families as one stacked "
                        "table (overrides --family)")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--p", type=float, default=0.01)
    p.add_argument("--degree-cap", type=int, default=None)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--max-rounds", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--death", type=float, default=0.0)
    p.add_argument("--curve", action="store_true")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the config axis over this many ranks")
    p.add_argument("--pod-mesh", nargs=2, type=int, default=None,
                   metavar=("SWEEP", "NODES"),
                   help="2-D mesh: configs over SWEEP ranks, each config's "
                        "nodes over NODES ranks")
    p.add_argument("--share-card", action="store_true",
                   help="run the ranks on one card under gloo (a test "
                        "mode: NCCL takes one card a rank)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda)")
    p.set_defaults(fn=cmd_grid)

    p = sub.add_parser("churn-sweep", help="run K fault programs (churn/"
                       "partition/drop-ramp) over one configuration and "
                       "report per-scenario convergence and dropped totals")
    p.add_argument("--scenario", action="append", required=True,
                   metavar="SPEC",
                   help="one fault program: ';'-separated "
                        "event=NODE:DIE[:REC] / partition=START:END:CUT / "
                        "ramp=START:END:P0:P1 items; repeat per scenario")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--family", default=C.COMPLETE, choices=C.FAMILIES)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--p", type=float, default=0.01)
    p.add_argument("--mode", default=C.PUSH_PULL,
                   choices=(C.PUSH, C.PULL, C.PUSH_PULL, C.FLOOD,
                            C.ANTI_ENTROPY))
    p.add_argument("--fanout", type=int, default=2)
    p.add_argument("--rumors", type=int, default=1)
    p.add_argument("--period", type=int, default=1)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--max-rounds", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drop", type=float, default=0.0,
                   help="base link drop probability (the drop table "
                        "outside any ramp)")
    p.add_argument("--death", type=float, default=0.0,
                   help="static death rate (shared by every scenario)")
    p.add_argument("--curve", action="store_true")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the scenario axis (xla) or the rumor-plane "
                        "axis (fused) over this many ranks")
    p.add_argument("--engine", default="xla", choices=("xla", "fused"),
                   help="xla: the K scenarios as one batch; fused: the "
                        "fused rumor planes, one scenario after another "
                        "(--mode pull, complete family)")
    p.add_argument("--share-card", action="store_true",
                   help="run the ranks on one card under gloo (a test "
                        "mode: NCCL takes one card a rank)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda)")
    p.set_defaults(fn=cmd_churn_sweep)

    p = sub.add_parser("crdt", help="run a commutative-merge CRDT payload "
                       "(counters, sets) on the pull exchange")
    p.add_argument("--type", default=C.GCOUNTER,
                   choices=(C.GCOUNTER, C.PNCOUNTER, C.GSET, C.ORSET))
    _add_payload_flags(p, "value-convergence")
    p.add_argument("--add", action="append", default=None,
                   metavar="NODE:ROUND:AMOUNT",
                   help="scripted counter add (repeatable; default "
                        "program: node j adds 1 + j%%7 at round 0)")
    p.add_argument("--set-add", action="append", default=None,
                   metavar="ELEM:ROUND",
                   help="scripted set add at the element's owner node "
                        "(repeatable; default: every element at round 0)")
    p.add_argument("--set-remove", action="append", default=None,
                   metavar="ELEM:ROUND",
                   help="scripted orset remove (tombstone; repeatable)")
    p.add_argument("--elements", type=int, default=64,
                   help="set element universe size E")
    _add_byz_flags(p)
    _add_tail_flags(p, "value-convergence")
    p.set_defaults(fn=run_crdt)

    p = sub.add_parser("log", help="run a replicated kafka-style log on "
                       "the pull exchange")
    _add_payload_flags(p, "log-convergence")
    p.add_argument("--keys", type=int, default=4,
                   help="number of per-key logs K")
    p.add_argument("--capacity", type=int, default=16,
                   help="ring slots per key C")
    p.add_argument("--send", action="append", default=None,
                   metavar="NODE:KEY:ROUND:VALUE",
                   help="scripted append (repeatable; default program: 4 "
                        "sends per key, rounds 0-3)")
    p.add_argument("--commit", action="append", default=None,
                   metavar="NODE:KEY:ROUND:UPTO",
                   help="scripted commit (repeatable; default: one commit "
                        "per key at round 4)")
    _add_tail_flags(p, "log-convergence")
    p.set_defaults(fn=run_log)

    p = sub.add_parser("txn", help="run totally-available transactions "
                       "over LWW registers (the Maelstrom txn-rw-register "
                       "shape) on the pull exchange")
    _add_payload_flags(p, "txn-convergence")
    p.add_argument("--keys", type=int, default=8,
                   help="register universe K")
    p.add_argument("--txns", type=int, default=16,
                   help="default-program write count T (the skewed "
                        "closed-form traffic generator)")
    p.add_argument("--zipf-alpha", type=float, default=1.1,
                   help="key-popularity skew (> 0; 1.0 = classic zipf)")
    p.add_argument("--hot-key", type=float, default=0.0,
                   help="hot-key storm: probability mass redirected onto "
                        "key 0 during the middle third of the program")
    p.add_argument("--load", default="uniform", choices=C.TXN_LOADS,
                   help="writes-over-rounds shape: uniform, or diurnal "
                        "(1 + sin density, one peak mid-window)")
    p.add_argument("--spread", type=int, default=8,
                   help="rounds the default write program spans")
    p.add_argument("--write", action="append", default=None,
                   metavar="NODE:KEY:ROUND:VALUE",
                   help="scripted write (repeatable; values >= 1; at most "
                        "one write per (key, round, node); overrides the "
                        "default program)")
    _add_byz_flags(p)
    _add_tail_flags(p, "txn-convergence")
    p.set_defaults(fn=run_txn)
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    joined = False
    try:
        # multi-host runs: join the launcher's process group first (a
        # no-op without its variables)
        from gossip_tpu_torch.parallel.multislice import \
            maybe_init_distributed
        joined = maybe_init_distributed(
            "gloo" if a.device == "cpu" or a.share_card else None)
        if a.cmd in PAYLOAD_COMMANDS:
            print(json.dumps(a.fn(a, keep_state=False)[0]))
            return 0
        return a.fn(a)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
