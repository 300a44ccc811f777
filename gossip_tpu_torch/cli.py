"""Command line of the port: ``python -m gossip_tpu_torch
run|sweep|grid|churn-sweep|crdt|log|txn|plan|scale-run|serve|route|
fleet-status|maelstrom|maelstrom-check``.

The port of every command of the JAX package but ``staticcheck``::

    python -m gossip_tpu_torch run [--backend jax-tpu|go-native] \\
        --mode pull --n 10000000 [--engine auto|fused|xla|native] \\
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
        [--ensemble S] [--checkpoint PATH [--checkpoint-every E]
        [--resume]] [--parity-check] [--device cpu]
    python -m gossip_tpu_torch sweep [--scale F] [--only NAME...] \\
        [--devices K] [--curve] [--swim-diss scatter|sort|pack]
        [--share-card] [--device cpu]
    python -m gossip_tpu_torch run --plan FILE [--checkpoint PATH
        [--resume]] [--share-card] [--device cpu]
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
    python -m gossip_tpu_torch plan [--n N] [--rumors R] [--fanout F] \\
        [--engine packed|dense|fused] [--max-rounds M] [--seed S]
        [--origin O] [--chips C] [--hbm-gb G] [--slices S]
        [--host-ram-gb G] [--segment-every E] [--reserve F] [--death D]
        [--drop P] [--fault-seed S] [--scenario SPEC] [--out FILE]
        [--validate FILE]
    python -m gossip_tpu_torch scale-run --plan FILE [--checkpoint PATH] \\
        [--resume] [--check-bitwise] [--measure-memory] [--no-overlap]
        [--share-card] [--device cpu]
    python -m gossip_tpu_torch serve [--port P] [--workers W] \\
        [--no-batching] [--batch-tick-ms T] [--batch-max B]
        [--batch-queue Q] [--devices K [--share-card]] [--device cpu]
    python -m gossip_tpu_torch route [--replicas N] [--port P] \\
        [--workers W] [--probe-interval-ms T] [--down-after D]
        [--up-after U] [--max-inflight M] [--no-batching]
        [--devices-per-replica K] [--device cpu]
    python -m gossip_tpu_torch fleet-status HOST:PORT [--watch] \\
        [--interval S] [--timeout S] [--json] [--out PATH]
    python -m gossip_tpu_torch maelstrom [--workload W] \\
        [--gossip-interval S]
    python -m gossip_tpu_torch maelstrom-check [--n N] [--ops K] \\
        [--rate R] [--latency S] [--topology line|grid] [--partition]
        [--seed S] [--router python|native]
        [--workload broadcast|counter|kafka|txn] [--gossip-interval S]
        [--assert-msgs-per-op T] [--assert-latency-ms MS]

``--mode`` is one of the five SI modes, ``swim`` or ``rumor``, and
``--engine`` one of ``auto|xla|fused`` (``native`` with ``--backend
go-native`` only; default ``auto``:
``backend.run_simulation``'s rule, the fused kernel on a card where it is
eligible, the xla engine otherwise and on the CPU).  The flags, their defaults and their parse
are the JAX command's (``--drop-prob`` is another name for ``--drop``;
``plan``'s ``--hbm-gb`` defaults to one H100's memory,
``planner/budget.H100_HBM_BYTES`` = 85,017,493,504 bytes, and its
``--host-ram-gb`` to the card machine's host RAM,
``planner/budget.HOST_RAM_BYTES`` = 108,447,924,224 bytes, where the
JAX command's are a TPU chip's 16 GiB and a 64 GiB host;
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

``run --checkpoint PATH`` runs exactly ``--max-rounds`` rounds in
segments of ``--checkpoint-every`` (default 50), an atomic npz in the
JAX package's format after each (:mod:`gossip_tpu_torch.utils.checkpoint`),
and ``--resume`` continues the file's run to ``--max-rounds`` rounds in
all, bitwise the run that was not interrupted, whichever package wrote
the file.  The reference's five checkpointed drivers: the SI rounds on
one device (``engine`` ``si-xla``), the packed node-sharded rounds
(``--devices K``, pull and anti-entropy: ``sharded-packed``), the fused
rumor planes (``--engine fused``, any ``--devices``, K = 1 a one-rank
group: ``fused-pallas-planes``; with ``--device cpu`` the planes run the
kernel's plain version, the port's fused routes' declared extension),
SWIM (``swim-xla`` / ``swim-sharded``) and rumor mongering
(``rumor-xla`` / ``rumor-sharded``).  The file stamps the run's
configuration and fault-program fingerprints, and a resume refuses a
file that is missing or corrupt, or that another configuration, program
or curve request wrote, in the reference's words.  The output line is
the reference's, less its ``backend`` key's value: the port's
``torch-cuda`` / ``torch-cpu``, as its other reports name it; its
``compile_cache`` is null.

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

``run --backend go-native`` runs the reference node's event-driven
model (``backend.run_gonative``: flood only, on the host, on the C++
event core of ``native/eventsim.cpp``, built with ``g++`` into the
kernels' store; ``--engine native`` raises its node cap from 20,000 to
1,000,000) and prints the reference's report.  ``run --mode flood
--parity-check`` runs the same topology through the flood rounds on
``--device`` and the event core, and prints the reference's
``curve_gap``, ``hop_bound_violation`` and ``fixed_point_gap`` with both
reports.  ``sweep`` runs the five ``BASELINE.json`` rows (the reference's
flags, plus ``--device`` and ``--share-card``; ``--devices`` defaults to
the cards of the machine, or 1 with ``--device cpu``; row 5, 10M nodes x
8 rumors, takes ``engine='auto'``, the fused multi-rumor kernel on a
card, and runs on K ranks with ``--devices K``), one line a row with the
reference's keys.  ``maelstrom`` runs the protocol node on stdio and
``maelstrom-check`` a workload against real node processes
(:mod:`gossip_tpu_torch.runtime`): every workload on the Python router,
broadcast also on the C++ router (``native/router.cpp``), exit 1 when
the invariant or a gate fails.  Without ``g++`` the event core and the
router are an error (exit 2), not the reference's fallback to Python.

``plan`` (:mod:`gossip_tpu_torch.planner.budget`) prints the JAX
command's plan document, byte for byte for the packed and dense engines
(the fused engine's adds the port's ``lane_major_pingpong`` term), or
its one-line refusal naming the binding constraint with exit code 2;
``--validate FILE`` checks a plan file.  ``scale-run --plan FILE`` and
``run --plan FILE`` execute a plan through the streamed driver
(:mod:`gossip_tpu_torch.planner.stream`), word-plane tiles streamed
host to card per checkpoint segment, and print the JAX command's line
with ``plan_fingerprint`` (exit 1 when ``--check-bitwise`` finds a
difference); ``--share-card`` runs a plan's ranks on one card.  ``run
--plan`` refuses every run-shape flag changed from its default, in the
reference's words.  Without ``--device cpu`` they need a CUDA device.

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
collective's time and every rank's peak memory.

The run's records (the reference's): ``GOSSIP_TELEMETRY=PATH`` opens
the run ledger (:mod:`gossip_tpu_torch.utils.telemetry`) for every
command, whose lines are the provenance, one ``kernel_build`` a CUDA
library built or loaded, one ``driver_timing`` a timed driver call,
the round metrics of an instrumented driver
(:mod:`gossip_tpu_torch.ops.round_metrics`, ``GOSSIP_ROUND_METRICS=0``
turns them off), a checkpoint's flight record and the streamed
planner's ``scale_*`` and ``budget_xcheck`` events; under ``--devices
K`` rank 0 writes.  ``run --profile LOGDIR`` captures the run with
``torch.profiler`` into a Chrome trace under LOGDIR (on a card, with
its CUDA kernels; a capture without them fails the command) and adds
``profile_logdir`` to the line.  ``--compile-cache DIR`` and
``--no-compile-cache`` (on ``run``, ``grid``, ``churn-sweep``,
``crdt``, ``log``, ``txn`` and ``scale-run``, the reference's commands
that the port has) name the port's only build cache, the store of the
kernels' ``nvcc`` libraries (``ops/_kernels``): DIR defaults to
``$GOSSIP_COMPILE_CACHE``, else ``gossip_tpu_torch/_build/``, and
``--no-compile-cache`` (or an empty DIR) builds into a fresh temporary
directory removed at exit, so ``build_s`` is a cold build.  The
reference's ``compile_cache`` key (``run``'s single-run and checkpointed
lines, ``crdt``, ``log``, ``txn``; not ``--ensemble``'s) is the
directory, or null with the cache off.  The reference's XLA
``xla_compile`` event becomes ``kernel_build``; its ``JitCompileMonitor``
has no counterpart, since nothing is compiled again at run time.

``serve``, ``route`` and ``fleet-status`` (:mod:`gossip_tpu_torch.rpc`)
take the JAX commands' flags, defaults and exit codes, plus ``--device``
on ``serve`` and ``route``: ``serve`` starts the sidecar (admission
batching on unless ``--no-batching``) and prints ``{"serving": true,
"port": ...}``; ``route`` spawns ``--replicas`` sidecars (each with the
command's ``--device``) behind the failover router and prints
``{"routing": true, ...}``, or exits 1 when not every replica was
admitted within 60 s; ``fleet-status HOST:PORT`` renders a router's or a
replica's ``Metrics`` reply and exits 0 (healthy), 1 (degraded) or 2
(unreachable).  They need the ``grpc`` package (without it, an
ImportError naming it).  ``serve --devices K`` (a power of two) runs each
tick's megabatch on K spawned ranks that split its request axis (gloo
on the CPU, NCCL with a card a rank; ``--share-card`` puts the K ranks
on one card under gloo, a test mode) and refuses more ranks than cards
without ``--share-card`` (exit 2); ``route --devices-per-replica K``
spawns each replica with ``--devices K`` (and ``--share-card`` where the
host has fewer cards than K) and tears the fleet down when a replica
reports a narrower mesh.  The reference's ``--coordinator``,
``--num-processes``, ``--process-id`` (one replica over several
processes) are refused above one process (not ported yet), and its
``route --replica-platform`` (the replicas' JAX platform pin) has no
counterpart: the replicas take ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from gossip_tpu_torch import config as C
from gossip_tpu_torch.config import (ByzConfig, ChurnConfig, CrdtConfig,
                                     FaultConfig, FleetConfig, LogConfig,
                                     MeshConfig, ProtocolConfig, RunConfig,
                                     ServingConfig, TopologyConfig,
                                     TxnConfig)


PAYLOAD_COMMANDS = ("crdt", "log", "txn")
# commands that never join a launcher's process group
SINGLE_PROCESS_COMMANDS = ("plan", "serve", "route", "fleet-status",
                           "maelstrom", "maelstrom-check")
# commands on the host alone, started at once: no run ledger, no kernel
# store flags (the protocol node imports no torch)
HOST_COMMANDS = ("maelstrom", "maelstrom-check")


def _add_cache_flags(p) -> None:
    """The reference's two build-cache flags (module doc); the default
    is read when the command runs."""
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="the kernels' nvcc library store (default "
                        "$GOSSIP_COMPILE_CACHE, else "
                        "gossip_tpu_torch/_build/)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="build the kernels into a fresh temporary "
                        "directory (a cold nvcc build)")


def _enable_compile_cache(a) -> None:
    """Point the kernel store at the command's choice (module doc)."""
    if not hasattr(a, "no_compile_cache"):
        return
    from gossip_tpu_torch.ops import _kernels
    if a.compile_cache is None:
        a.compile_cache = os.environ.get(_kernels.CACHE_ENV,
                                         str(_kernels.BUILD_DIR))
    if a.no_compile_cache or not a.compile_cache:
        a.no_compile_cache = True
        _kernels.use_fresh_build_dir()
    else:
        _kernels.set_build_dir(a.compile_cache)


def _cache_stamp(a):
    """The report's ``compile_cache``: the store's directory, or None with
    the cache off."""
    if not hasattr(a, "no_compile_cache") or a.no_compile_cache or \
            not a.compile_cache:
        return None
    return a.compile_cache


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
           "engine": _engine(a, "crdt"), "compile_cache": _cache_stamp(a)}
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
           "compile_cache": _cache_stamp(a)}
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
           "hot_key": a.hot_key, "load": a.load,
           "compile_cache": _cache_stamp(a)}
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
    if a.profile:
        out["profile_logdir"] = a.profile
    print(json.dumps(out))
    return 0


def cmd_run(a) -> int:
    if a.plan:
        # the plan file IS the run configuration; a run-shape flag changed
        # from its default would be silently discarded, so it is refused
        # (the reference's words)
        changed = [f"--{k.replace('_', '-')}"
                   for k, d in a.plan_guard_defaults.items()
                   if getattr(a, k) != d]
        if a.ensemble > 1 or a.parity_check or a.curve or a.save_curve:
            return _refuse("--plan executes the streamed scale driver; "
                           "drop --ensemble/--parity-check/--curve/"
                           "--save-curve")
        if changed:
            return _refuse("--plan takes the run shape from the plan "
                           f"file; drop {' '.join(sorted(changed))} "
                           "(regenerate the plan with `gossip_tpu plan` "
                           "to change them)")
        return run_plan_file(a.plan, checkpoint=a.checkpoint,
                             resume=a.resume, device=a.device,
                             share_card=a.share_card)
    from gossip_tpu_torch.utils.trace import trace
    if a.parity_check and a.ensemble > 1:
        # the reference's words
        return _refuse("--parity-check and --ensemble are separate run "
                       "shapes; pick one")
    if a.ensemble > 1:
        if a.backend != "jax-tpu":
            return _refuse("--ensemble needs the jax-tpu backend")
        with trace(a.profile, a.device or "cuda"):
            return cmd_ensemble(a)
    mesh = (MeshConfig(n_devices=a.devices, exchange=a.exchange,
                       shared_card=a.share_card) if a.devices > 1 else None)
    if a.parity_check:
        return cmd_parity_check(a, mesh)
    if a.resume and not a.checkpoint:
        print("error: --resume needs --checkpoint PATH (the file to "
              "continue from)", file=sys.stderr)
        return 2
    if a.checkpoint:
        if a.backend != "jax-tpu":
            return _refuse("--checkpoint drives the jax-tpu engines only")
        with trace(a.profile, a.device or "cuda"):
            return cmd_run_checkpointed(a)
    from gossip_tpu_torch.backend import dispatch
    want_curve = a.curve or bool(a.save_curve)
    proto, tc, run, fault = run_configs(a)
    with trace(a.profile, a.device or "cuda"):
        report = dispatch(a.backend, proto, tc, run, fault, mesh,
                          want_curve=want_curve, device=a.device)
    out = report.to_dict()
    out["compile_cache"] = _cache_stamp(a)
    if a.profile:
        out["profile_logdir"] = a.profile
    if a.save_curve:
        from gossip_tpu_torch.utils.metrics import dump_curve_jsonl
        meta = dict(out)
        dump_curve_jsonl(a.save_curve, meta.pop("curve"), meta=meta)
        if not a.curve:          # the curve went to the file
            out["curve"] = None
    print(json.dumps(out))
    return 0


def _refuse(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def cmd_parity_check(a, mesh) -> int:
    """``run --mode flood --parity-check``: the reference's backend parity
    check.  The same topology through the port's flood rounds (on
    ``--device``, the card by default) and the go-native event core (its
    C++ engine, ``engine='native'`` above 20,000 nodes), then the
    contract's three numbers: ``curve_gap`` (0 on race-free graphs),
    ``hop_bound_violation`` (0 always: races only slow the event sim)
    and ``fixed_point_gap`` (0 always: the same final coverage), with
    both reports, their curves left out."""
    import dataclasses

    from gossip_tpu_torch.backend import (_GONATIVE_MAX_NODES, run_gonative,
                                          run_simulation)
    from gossip_tpu_torch.utils.metrics import curve_gap
    from gossip_tpu_torch.utils.trace import trace
    # the reference's refusals, in its words
    if a.mode != C.FLOOD or a.backend != "jax-tpu":
        return _refuse("--parity-check compares the jax-tpu flood rounds "
                       "against go-native hop depths; use --backend "
                       "jax-tpu --mode flood")
    proto, tc, run, fault = run_configs(a)
    if fault is not None:
        return _refuse("--parity-check needs a fault-free run (go-native "
                       "takes no FaultConfig)")
    if a.curve or a.save_curve or a.checkpoint:
        return _refuse("--parity-check is a self-contained artifact run; "
                       "drop --curve/--save-curve/--checkpoint")
    with trace(a.profile, a.device or "cuda"):
        rep = run_simulation(proto, tc, run, None, want_curve=True,
                             device=a.device, mesh_cfg=mesh)
        ref = run_gonative(proto, tc, dataclasses.replace(
            run, engine="native" if tc.n > _GONATIVE_MAX_NODES else "auto"),
            want_curve=True)
    if rep.rounds < 0:
        # the event sim always runs to quiescence: a flood run cut off by
        # --max-rounds would report a fixed_point_gap that reads as a
        # divergence of the backends
        return _refuse("the jax flood run did not reach --target within "
                       f"--max-rounds={run.max_rounds}; raise --max-rounds "
                       "past the graph diameter so the parity fixed point "
                       "is the converged state")
    m = min(len(rep.curve), len(ref.curve))
    bound = max((ref.curve[t] - rep.curve[t] for t in range(m)),
                default=0.0)
    out = {"curve_gap": curve_gap(rep.curve, ref.curve),
           "hop_bound_violation": max(0.0, bound),
           "fixed_point_gap": abs(rep.coverage - ref.coverage),
           "n": tc.n, "family": a.family,
           "compile_cache": _cache_stamp(a),
           "jax": {**rep.to_dict(), "curve": None},
           "gonative": {**ref.to_dict(), "curve": None}}
    if a.profile:
        out["profile_logdir"] = a.profile
    print(json.dumps(out))
    return 0


def _resume_checks(a, fingerprint, fault_fp, want_curve):
    """The reference's refusals of a ``--resume``: ``(exit code or None,
    the saved meta's extra)``."""
    from gossip_tpu_torch.utils.checkpoint import load_meta
    if not os.path.exists(a.checkpoint):
        return _refuse(f"--resume: no checkpoint at {a.checkpoint}"), None
    try:
        extra = load_meta(a.checkpoint).get("extra", {})
    except ValueError as e:
        return _refuse(f"--resume: {e}"), None
    saved = extra.get("config")
    if saved is not None:
        # checkpoints of the reference's first format lack these keys;
        # they were all written by its single-device XLA driver
        saved = {"devices": 1, "exchange": "dense", "engine": "xla",
                 **saved}
    want = json.loads(json.dumps(fingerprint))
    if saved is not None and saved != want:
        diff = [k for k in want if want[k] != saved.get(k)]
        return _refuse("--resume config mismatch vs the checkpoint "
                       f"(differs in: {', '.join(diff)}); rerun with the "
                       "flags the checkpoint was written with"), None
    saved_fp = extra.get("fault_program")
    if fault_fp is not None and saved_fp is None:
        return _refuse(
            "--resume under a fault program, but the "
            "checkpoint carries no fault-program fingerprint (it "
            "was written without a churn schedule, or by a "
            "pre-crash-safety build); a resumed run cannot prove "
            "it continues the SAME schedule — restart without "
            "--resume or drop the churn flags"), None
    if saved_fp is not None and fault_fp is None:
        return _refuse(
            "the checkpoint was written under a fault "
            "program but this resume scripts none; rerun with "
            "the churn flags the checkpoint was written with"), None
    if fault_fp is not None and saved_fp != fault_fp:
        return _refuse(
            "--resume fault-program mismatch vs the "
            "checkpoint (schedule digest "
            f"{saved_fp[:12]}... != {fault_fp[:12]}...); a "
            "different churn/partition/ramp program would fork "
            "the trajectory — rerun with the schedule the "
            "checkpoint was written with"), None
    saved_curve = extra.get("curve")
    if want_curve and saved_curve is None:
        return _refuse(
            "--resume with --curve/--save-curve, but the "
            "checkpoint has no curve history (it was written "
            "without curve capture); drop the curve flags or "
            "restart without --resume"), None
    if saved_curve is not None and not want_curve:
        return _refuse(
            "the checkpoint carries a curve history; add "
            "--curve or --save-curve to continue it (refusing to "
            "silently drop it)"), None
    return None, extra


def _checkpointed_rank(a, kind, resume, curve_prefix, lost_prefix,
                       extra_meta, group=None):
    """One rank's (or the one process's) checkpointed run of ``kind``:
    ``(rounds, coverage, msgs, curve, report extras, the port's keys)``:
    the device, the load's and the run's milliseconds, each save's
    :func:`~gossip_tpu_torch.utils.checkpoint.run_with_checkpoints`
    record, and the kernel launches (every rank's, under a group).  On
    resume each rank reads the file and takes its share."""
    import time

    import numpy as np
    import torch

    from gossip_tpu_torch.backend import (_launch_counts, _rank_launches,
                                          swim_scenario)
    from gossip_tpu_torch.topology import generators as G
    from gossip_tpu_torch.utils.checkpoint import load_state
    proto, tc, run, fault = run_configs(a)
    dev = _rank_device(a, group)
    t0 = time.perf_counter()
    state = load_state(a.checkpoint, device="cpu") if resume else None
    load_ms = (time.perf_counter() - t0) * 1e3
    stats = []
    launches0 = _launch_counts()
    t0 = time.perf_counter()
    kw = dict(every=a.checkpoint_every, resume_state=state,
              want_curve=a.curve or bool(a.save_curve),
              curve_prefix=curve_prefix, extra_meta=extra_meta, stats=stats)
    extra = {}
    if kind == "swim":
        from gossip_tpu_torch.runtime.simulator import checkpointed_swim
        dead, fail_round, extra["default_scenario"] = swim_scenario(
            proto, tc.n, fault)
        topo = None if tc.family == C.COMPLETE else G.build(tc, dev)
        final, cov, curve = checkpointed_swim(
            proto, tc.n, run, a.checkpoint, dead_nodes=dead,
            fail_round=fail_round, fault=fault, topo=topo, group=group,
            device=dev, **kw)
        extra = {"metric": "detection_fraction", **extra}
        if proto.swim_rotate and curve:
            # the best in-window detection (the window may have left the
            # dead node's epoch)
            extra["peak_detection"] = float(max(curve))
    elif kind == "rumor":
        from gossip_tpu_torch.models.rumor import checkpointed_rumor
        final, cov, residue, curve = checkpointed_rumor(
            proto, G.build(tc, dev), run, a.checkpoint, fault=fault,
            group=group, lost_prefix=lost_prefix, device=dev, **kw)
        hot = final.hot.any().to(torch.int64).reshape(1)
        if group is not None:
            hot = group.all_reduce_sum(hot)
        extra = {"residue": residue, "extinct": not bool(hot[0])}
        if curve:
            dead_at = np.nonzero(np.asarray(curve["hot"]) == 0.0)[0]
            extra["extinction_round"] = (int(dead_at[0]) + 1
                                         if len(dead_at) else -1)
    elif kind == "fused":
        from gossip_tpu_torch.parallel.sharded_fused import \
            checkpointed_fused_planes
        final, cov, curve = checkpointed_fused_planes(
            tc.n, proto.rumors, run, group, a.checkpoint,
            fanout=proto.fanout, fault=fault, **kw)
    elif kind == "packed":
        from gossip_tpu_torch.parallel.sharded_packed import \
            checkpointed_packed_sharded
        final, cov, curve = checkpointed_packed_sharded(
            proto, G.build(tc, dev), run, group, a.checkpoint, fault=fault,
            lost_prefix=lost_prefix, **kw)
    else:
        from gossip_tpu_torch.runtime.simulator import checkpointed_si
        final, cov, curve = checkpointed_si(
            proto, G.build(tc, dev), run, a.checkpoint, fault=fault,
            lost_prefix=lost_prefix, device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    port = {"device": dev.type, "load_ms": load_ms if resume else None,
            "run_ms": (time.perf_counter() - t0) * 1e3, "saves": stats}
    if group is None:
        now = _launch_counts()
        port["launches"] = {k: now[k] - launches0[k] for k in now}
    else:
        port["rank_launches"] = _rank_launches(group, launches0)
    return int(final.round), cov, float(final.msgs), curve, extra, port


def cmd_run_checkpointed(a) -> int:
    """``run --checkpoint``: the reference's ``_cmd_run_checkpointed``
    (module doc): prints :func:`run_checkpointed`'s line."""
    code, out, _ = run_checkpointed(a)
    if out is not None:
        print(json.dumps(out))
    return code


def run_checkpointed(a):
    """``(exit code, the reference's output line or None, the port's
    keys)`` of ``run --checkpoint``.  Refusals go to stderr, checked
    here before any rank starts; every rank of a sharded run reads the
    file itself on resume.  The port's keys (rank 0's: its device, load
    and run milliseconds, save records, launches) are not printed."""
    import dataclasses

    from gossip_tpu_torch.backend import fused_ineligible_reason
    from gossip_tpu_torch.ops import nemesis as NE
    from gossip_tpu_torch.utils.checkpoint import load_meta
    proto, tc, run, fault = run_configs(a)
    n_dev = a.devices
    exchange = "dense" if n_dev <= 1 else a.exchange
    want_curve = a.curve or bool(a.save_curve)
    fused = run.engine == "fused"
    if fused:
        # the checkpointed fused driver is always the plane stack
        reason = fused_ineligible_reason(proto, tc, run, fault, n_dev,
                                         plane_stack=True)
        if reason is not None:
            return _refuse(reason), None, None
    elif n_dev > 1 and a.mode not in (C.SWIM, C.RUMOR):
        from gossip_tpu_torch.parallel.sharded_packed import \
            sharded_checkpoint_ineligible_reason
        reason = sharded_checkpoint_ineligible_reason(proto, exchange)
        if reason is not None:
            return _refuse(reason), None, None
    fingerprint = {"proto": dataclasses.asdict(proto),
                   "tc": dataclasses.asdict(tc),
                   "fault": None if fault is None
                   else dataclasses.asdict(fault),
                   "seed": run.seed, "origin": run.origin,
                   "devices": n_dev, "exchange": exchange,
                   "engine": "fused" if fused else "xla"}
    fault_fp = NE.schedule_fingerprint(fault, tc.n, run.origin)
    curve_prefix, lost_prefix = (), 0.0
    if a.resume:
        code, saved = _resume_checks(a, fingerprint, fault_fp, want_curve)
        if code is not None:
            return code, None, None
        lost_prefix = float(saved.get("dropped", 0.0))
        saved_curve = saved.get("curve")
        curve_prefix = (saved_curve if isinstance(saved_curve, dict)
                        else tuple(saved_curve or ()))
    extra_meta = {"config": fingerprint}
    if fault_fp is not None:
        extra_meta["fault_program"] = fault_fp
    if a.mode in (C.SWIM, C.RUMOR):
        kind = a.mode
        label = f"{a.mode}-sharded" if n_dev > 1 else f"{a.mode}-xla"
    elif fused:
        kind, label = "fused", "fused-pallas-planes"
    elif n_dev > 1:
        kind, label = "packed", "sharded-packed"
    else:
        kind, label = "si", "si-xla"
    args = (a, kind, a.resume, curve_prefix, lost_prefix, extra_meta)
    import torch.distributed as dist
    if kind == "fused" and n_dev <= 1 and not (dist.is_available()
                                               and dist.is_initialized()):
        # one device: the planes on a one-rank group in this process
        from gossip_tpu_torch.ops.common import resolve_device
        from gossip_tpu_torch.parallel import group as GR
        with GR.local(resolve_device(a.device)) as one:
            res = _checkpointed_rank(*args, group=one)
    else:
        res = _on_ranks(a, _checkpointed_rank, *args,
                        spawn_one=kind == "fused")[0]
    rounds, cov, msgs, curve, extra, port = res
    out = {"backend": f"torch-{port['device']}", "mode": a.mode, "n": tc.n,
           "rounds": rounds, "coverage": cov, "msgs": msgs,
           "checkpoint": a.checkpoint,
           "checkpoint_every": a.checkpoint_every, "resumed": a.resume,
           "engine": label, "devices": n_dev,
           "compile_cache": _cache_stamp(a)}
    if NE.get(fault) is not None:
        final_extra = load_meta(a.checkpoint).get("extra", {})
        if "dropped" in final_extra:
            out["dropped"] = final_extra["dropped"]
        out["fault_program"] = fault_fp
    out.update(extra)
    if a.profile:
        out["profile_logdir"] = a.profile
    curve_list = curve["coverage"] if isinstance(curve, dict) else curve
    if a.save_curve:
        from gossip_tpu_torch.utils.metrics import dump_curve_jsonl
        save_meta = dict(out)
        if isinstance(curve, dict):
            save_meta["hot_curve"] = list(curve["hot"])
        dump_curve_jsonl(a.save_curve, list(curve_list), meta=save_meta)
    if a.curve:
        out["curve"] = list(curve_list)
        if isinstance(curve, dict):
            out["hot_curve"] = list(curve["hot"])
    return 0, out, port


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


# The five BASELINE.json configurations, scalable for CPU runs (the
# reference's rows, each with its revision).
def baseline_configs(scale: float, devices: int, shared_card: bool = False):
    def sn(n):                       # scaled node count
        return max(64, int(n * scale))
    n2 = sn(10_000)
    n3 = sn(100_000)
    n4 = sn(1_000_000)
    n5 = sn(10_000_000)
    return [
        dict(name="push-complete-64-goref", backend="jax-tpu",
             proto=ProtocolConfig(mode="push", fanout=1),
             tc=TopologyConfig(family="complete", n=64),
             run=RunConfig(max_rounds=64, engine="auto"),
             compare_gonative=True),
        dict(name="pushpull-er-10k", backend="jax-tpu",
             proto=ProtocolConfig(mode="pushpull", fanout=1),
             tc=TopologyConfig(family="erdos_renyi", n=n2,
                               p=min(1.0, 0.01 * 10_000 / n2)),
             run=RunConfig(max_rounds=64, engine="auto")),
        dict(name="antientropy-ws-100k", backend="jax-tpu",
             proto=ProtocolConfig(mode="antientropy", fanout=1, period=2),
             tc=TopologyConfig(family="watts_strogatz", n=n3, k=6, p=0.1),
             run=RunConfig(max_rounds=256, engine="auto")),
        dict(name="swim-powerlaw-1m", backend="jax-tpu",
             proto=ProtocolConfig(mode="swim", fanout=2, swim_proxies=3,
                                  swim_subjects=8, swim_suspect_rounds=24),
             tc=TopologyConfig(family="power_law", n=n4, k=3,
                               degree_cap=256),
             run=RunConfig(max_rounds=80, engine="auto")),
        # BASELINE.json configs[4], "10M-node multi-rumor broadcast,
        # node-dim sharded": pull, so that on one device engine='auto'
        # takes the fused multi-rumor kernel (on a card; the xla engine on
        # the CPU) and over K ranks the node-sharded drivers; revision 2
        # is the reference's mode change from pushpull
        dict(name="multirumor-10m-sharded", backend="jax-tpu",
             proto=ProtocolConfig(mode="pull", fanout=1, rumors=8),
             tc=TopologyConfig(family="complete", n=n5),
             run=RunConfig(max_rounds=64, engine="auto"),
             mesh=MeshConfig(n_devices=devices, shared_card=shared_card),
             revision=2),
    ]


def cmd_sweep(a) -> int:
    """``sweep``: the five BASELINE rows, one JSON line each (the
    reference's ``cmd_sweep``).  Row 1 adds ``gonative_ref``, the same
    graph flooded on the go-native event core; each row adds
    ``row_wall_s`` and ``row_overhead_s`` (the row's wall less the
    engine's, the topology build's and the go-native run's)."""
    import dataclasses
    import time

    import torch

    from gossip_tpu_torch.backend import dispatch
    from gossip_tpu_torch.ops.common import resolve_device
    dev = resolve_device(a.device)
    devices = a.devices or (torch.cuda.device_count()
                            if dev.type == "cuda" else 1)
    configs = baseline_configs(a.scale, devices, a.share_card)
    if a.only:
        configs = [c for c in configs if c["name"] in a.only]
    if a.swim_diss:
        configs = [dict(cfg, proto=dataclasses.replace(
            cfg["proto"], swim_diss=a.swim_diss))
            if cfg["proto"].mode == C.SWIM else cfg for cfg in configs]
    for cfg in configs:
        t0_row = time.perf_counter()
        report = dispatch(cfg["backend"], cfg["proto"], cfg["tc"],
                          cfg["run"], None, cfg.get("mesh"),
                          want_curve=a.curve, device=dev)
        out = report.to_dict()
        out["config"] = cfg["name"]
        out["config_revision"] = cfg.get("revision", 1)
        out["compile_cache"] = _cache_stamp(a)
        if cfg.get("compare_gonative"):
            ref = dispatch("go-native", ProtocolConfig(mode=C.FLOOD),
                           cfg["tc"], cfg["run"], want_curve=a.curve)
            out["gonative_ref"] = ref.to_dict()
        # the row's wall is everything the row cost: the engine's wall,
        # the topology build, the go-native run and what is left
        row_wall = time.perf_counter() - t0_row
        parts = (out["wall_s"]
                 + (out.get("meta") or {}).get("topo_build_s", 0.0)
                 + (out.get("gonative_ref") or {}).get("wall_s", 0.0))
        out["row_wall_s"] = round(row_wall, 4)
        out["row_overhead_s"] = round(max(0.0, row_wall - parts), 4)
        print(json.dumps(out), flush=True)
    return 0


def cmd_maelstrom(a) -> int:
    """``maelstrom``: the Maelstrom protocol node on stdio."""
    from gossip_tpu_torch.runtime.maelstrom_node import main as node_main
    node_main(["--gossip-interval", str(a.gossip_interval),
               "--workload", a.workload])
    return 0


def _node_argv(gossip_interval: float, workload: str = "broadcast"):
    """The harnesses' node command; None keeps their default (the
    immediate-relay broadcast node)."""
    if gossip_interval <= 0 and workload == "broadcast":
        return None
    argv = [sys.executable, "-u", "-m",
            "gossip_tpu_torch.runtime.maelstrom_node",
            "--workload", workload]
    if gossip_interval > 0:
        argv += ["--gossip-interval", str(gossip_interval)]
    return argv


def cmd_maelstrom_check(a) -> int:
    """``maelstrom-check``: a workload against ``--n`` node processes on
    the Python router (every workload) or the C++ router (broadcast),
    its invariant and the optional gates; exit 1 when one fails (the
    reference's command)."""
    import asyncio

    from gossip_tpu_torch.runtime import maelstrom_harness as MH
    argv = _node_argv(a.gossip_interval, a.workload)
    kw = dict(rate=a.rate, latency=a.latency, topology=a.topology,
              partition_mid=a.partition, seed=a.seed, argv=argv)
    if a.workload != "broadcast" and a.router == "native":
        # the reference's words
        return _refuse(f"the {a.workload} workload runs on the python "
                       "router (the C++ router speaks the broadcast "
                       "envelope set only)")
    if a.workload == "kafka":
        stats = asyncio.run(MH.run_kafka_workload(a.n, a.ops, **kw))
    elif a.workload == "txn":
        stats = asyncio.run(MH.run_txn_workload(a.n, a.ops, **kw))
    elif a.workload == "counter":
        stats = asyncio.run(MH.run_counter_workload(a.n, a.ops, **kw))
    elif a.router == "native":
        from gossip_tpu_torch.runtime.native_router import \
            run_native_workload
        stats = run_native_workload(a.n, a.ops, **kw)
    else:
        stats = asyncio.run(MH.run_broadcast_workload(a.n, a.ops, **kw))
    stats["workload"] = a.workload
    stats["gossip_interval"] = a.gossip_interval
    ok = stats["invariant_ok"]
    if a.assert_msgs_per_op is not None:
        # the Glomers-style efficiency gate: the report carries the target
        # and the verdict, and the exit code enforces it
        stats["msgs_per_op_target"] = a.assert_msgs_per_op
        stats["msgs_per_op_ok"] = (stats["msgs_per_op"]
                                   <= a.assert_msgs_per_op)
        ok = ok and stats["msgs_per_op_ok"]
    if a.assert_latency_ms is not None:
        stats["op_latency_target_ms"] = a.assert_latency_ms
        stats["op_latency_ok"] = (stats["op_latency_ms"]["max"]
                                  <= a.assert_latency_ms)
        ok = ok and stats["op_latency_ok"]
    print(json.dumps(stats))
    return 0 if ok else 1


def _add_runtime_parsers(sub) -> None:
    """``sweep``, ``maelstrom`` and ``maelstrom-check``: the reference's
    flags, plus ``--device`` and ``--share-card`` on ``sweep``."""
    p = sub.add_parser("sweep", help="run the 5 BASELINE benchmark configs")
    p.add_argument("--scale", type=float, default=1.0,
                   help="node-count scale factor (CPU smoke: 0.01)")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks for the sharded config (0 = every card; "
                        "1 with --device cpu)")
    p.add_argument("--only", nargs="*", default=None,
                   help="subset of config names")
    p.add_argument("--curve", action="store_true")
    p.add_argument("--swim-diss", choices=("scatter", "sort", "pack"),
                   default=None,
                   help="override the SWIM config's dissemination "
                        "lowering (equal results)")
    p.add_argument("--share-card", action="store_true",
                   help="run the --devices ranks on one card under gloo "
                        "(a test mode: NCCL takes one card a rank)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs on the CPU (default: cuda, which must "
                        "be present)")
    _add_cache_flags(p)
    p.set_defaults(fn=cmd_sweep)

    workloads = ("broadcast", "counter", "kafka", "txn")
    p = sub.add_parser("maelstrom",
                       help="run the Maelstrom protocol node on stdio")
    p.add_argument("--gossip-interval", type=float, default=0.0,
                   help="batch relays per neighbor every INTERVAL "
                        "seconds (0 = immediate per-message fan-out)")
    p.add_argument("--workload", default="broadcast", choices=workloads,
                   help="node personality: broadcast log (the "
                        "reference), Gossip Glomers counter (CRDT "
                        "shards, merge = per-key max), the "
                        "replicated kafka-style log (owner-assigned "
                        "offsets, committed-offset max merge), or "
                        "txn-rw-register (totally-available "
                        "transactions over LWW registers)")
    p.set_defaults(fn=cmd_maelstrom)

    p = sub.add_parser("maelstrom-check",
                       help="run a Maelstrom workload against N real node "
                            "processes and check its invariant")
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--ops", type=int, default=20)
    p.add_argument("--rate", type=float, default=50.0, help="ops/sec")
    p.add_argument("--latency", type=float, default=0.002,
                   help="simulated link latency (s)")
    p.add_argument("--topology", default="line", choices=("line", "grid"))
    p.add_argument("--partition", action="store_true",
                   help="cut a mid-cluster link for the middle third of "
                        "the run (fault-tolerance variant)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--router", default="python",
                   choices=("python", "native"),
                   help="harness engine: the asyncio router or the C++ "
                        "poll()-loop router (native/router.cpp, built at "
                        "first use; without g++ an error)")
    p.add_argument("--workload", default="broadcast", choices=workloads,
                   help="broadcast (every value in every read), the "
                        "Gossip Glomers counter (every node's final "
                        "read == the sum of acked adds, through a "
                        "--partition), kafka (acked sends exactly "
                        "once per key in offset order, monotone "
                        "committed offsets, gapless polls), or txn "
                        "(txn-rw-register: no G0/G1a weak-isolation "
                        "anomalies + cross-node LWW convergence)")
    p.add_argument("--gossip-interval", type=float, default=0.0,
                   help="run the nodes with interval-batched relays "
                        "(seconds; 0 = the reference's immediate "
                        "per-message fan-out)")
    p.add_argument("--assert-msgs-per-op", type=float, default=None,
                   metavar="T",
                   help="efficiency gate: fail (exit 1) if msgs_per_op "
                        "exceeds T; the report records the target and "
                        "verdict")
    p.add_argument("--assert-latency-ms", type=float, default=None,
                   metavar="MS",
                   help="fail if the max client-op latency exceeds MS")
    p.set_defaults(fn=cmd_maelstrom_check)


def _device_spec_from_flags(a):
    from gossip_tpu_torch.planner.budget import (H100_HBM_BYTES,
                                                 HOST_RAM_BYTES, DeviceSpec)
    return DeviceSpec(
        chips=a.chips,
        hbm_bytes_per_chip=(H100_HBM_BYTES if a.hbm_gb is None
                            else int(a.hbm_gb * 1024**3)),
        slices=a.slices,
        host_ram_bytes=(HOST_RAM_BYTES if a.host_ram_gb is None
                        else int(a.host_ram_gb * 1024**3)))


def _plan_fault_from_flags(a):
    ch = parse_scenario(a.scenario) if a.scenario else None
    if ch is None and a.death == 0.0 and a.drop == 0.0:
        return None
    return FaultConfig(node_death_rate=a.death, drop_prob=a.drop,
                       seed=a.fault_seed, churn=ch)


def cmd_plan(a) -> int:
    """``plan``: capacity planning without a device — print (or
    validate) a ScalePlan as JSON, the word-plane tiling, segment
    schedule and mesh shape that fit N on the given devices, or refuse
    naming the binding constraint (:mod:`gossip_tpu_torch.planner.budget`;
    the reference's output and refusals, exit 2)."""
    from gossip_tpu_torch.planner import budget as PB
    if a.validate:
        try:
            with open(a.validate) as f:
                doc = json.load(f)
            plan = PB.plan_from_dict(doc)
        except (OSError, ValueError) as e:
            return _refuse(str(e))
        print(json.dumps({"plan_valid": True, "n": plan.n,
                          "tiles": plan.tiles,
                          "bucket_words": plan.bucket_words,
                          "fingerprint": PB.plan_fingerprint(
                              plan.to_dict())}))
        return 0
    try:
        fault = _plan_fault_from_flags(a)
        reserve = (PB.DEFAULT_RESERVE_FRAC if a.reserve is None
                   else a.reserve)
        plan = PB.plan_scale(
            a.n, rumors=a.rumors, device=_device_spec_from_flags(a),
            engine=a.engine, fanout=a.fanout, max_rounds=a.max_rounds,
            seed=a.seed, origin=a.origin, fault=fault,
            segment_every=a.segment_every, reserve_frac=reserve)
    except ValueError as e:
        # InfeasiblePlanError among them: the refusal IS the product
        # here, one line, constraint named
        return _refuse(str(e))
    text = plan.to_json()
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
        print(json.dumps({"plan_written": a.out, "n": plan.n,
                          "tiles": plan.tiles,
                          "bucket_words": plan.bucket_words,
                          "predicted_peak_device_bytes":
                          plan.predicted_peak_device_bytes,
                          "binding": plan.binding}))
    else:
        print(text)
    return 0


def run_plan_file(path: str, *, checkpoint=None, resume=False,
                  check_bitwise=False, measure_memory=False, overlap=True,
                  device=None, share_card=False, stats=None) -> int:
    """Load a plan file and execute it through the streamed driver
    (:func:`~gossip_tpu_torch.planner.stream.run_at_scale`), printing
    the reference's line and the plan's fingerprint — shared by
    ``scale-run`` and ``run --plan`` so the two surfaces cannot drift.
    Exit 2 on a refusal, 1 when ``check_bitwise`` finds a difference.
    ``stats`` gets the run's walls."""
    from gossip_tpu_torch.planner import budget as PB
    from gossip_tpu_torch.planner.stream import run_at_scale
    try:
        with open(path) as f:
            doc = json.load(f)
        plan = PB.plan_from_dict(doc)
    except (OSError, ValueError) as e:
        return _refuse(str(e))
    if resume and not checkpoint:
        return _refuse("--resume needs --checkpoint PATH")
    try:
        res = run_at_scale(plan, checkpoint_path=checkpoint, resume=resume,
                           check_bitwise=check_bitwise,
                           measure_memory=measure_memory, overlap=overlap,
                           device=device, shared_card=share_card,
                           stats=stats)
    except ValueError as e:
        return _refuse(str(e))
    out = res.to_dict()
    out["plan_fingerprint"] = PB.plan_fingerprint(plan.to_dict())
    print(json.dumps(out))
    if check_bitwise and res.bitwise_equal is not True:
        return 1
    return 0


def cmd_scale_run(a) -> int:
    """``scale-run``: execute a ScalePlan, word-plane tiles streamed
    through the packed pull round per checkpoint segment
    (:mod:`gossip_tpu_torch.planner.stream`)."""
    return run_plan_file(a.plan, checkpoint=a.checkpoint, resume=a.resume,
                         check_bitwise=a.check_bitwise,
                         measure_memory=a.measure_memory,
                         overlap=not a.no_overlap, device=a.device,
                         share_card=a.share_card)


def _exit_on_sigterm() -> None:
    """SIGTERM raises ``SystemExit(143)`` in the main thread, so a
    command's ``finally`` runs: ``serve`` stops its ranks, ``route`` its
    replicas (each in a session of its own)."""
    import signal
    import threading
    if threading.current_thread() is not threading.main_thread():
        return

    def stop(signum, frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, stop)


def cmd_serve(a) -> int:
    """``serve``: the gRPC sidecar (:func:`gossip_tpu_torch.rpc.sidecar.
    serve`)."""
    from gossip_tpu_torch.rpc.sidecar import serve
    batching = None
    if not a.no_batching:
        batching = ServingConfig(tick_ms=a.batch_tick_ms,
                                 max_batch=a.batch_max,
                                 max_queue=a.batch_queue,
                                 devices=a.devices,
                                 coordinator=a.coordinator,
                                 num_processes=a.num_processes,
                                 process_id=a.process_id,
                                 shared_card=a.share_card)
    server, port = serve(a.port, a.workers, batching=batching,
                         device=a.device)
    print(json.dumps({"serving": True, "port": port,
                      "batching": batching is not None,
                      "devices": (batching.devices
                                  if batching is not None else 1)}),
          flush=True)
    _exit_on_sigterm()
    try:
        server.wait_for_termination()
    finally:
        server.stop(grace=None)
        if server.gossip_batcher is not None:
            server.gossip_batcher.close()
    return 0


def cmd_route(a) -> int:
    """``route``: spawn sidecar replicas behind the failover router
    (:class:`gossip_tpu_torch.rpc.router.Fleet`)."""
    from gossip_tpu_torch.rpc.router import (Fleet, fleet_env,
                                             replica_mesh_argv)
    cfg = FleetConfig(replicas=a.replicas,
                      probe_interval_ms=a.probe_interval_ms,
                      down_after=a.down_after, up_after=a.up_after,
                      max_inflight=a.max_inflight,
                      devices_per_replica=a.devices_per_replica)
    replica_argv = []
    if a.no_batching:
        if cfg.devices_per_replica > 1:
            # the reference's words
            raise ValueError(
                "--devices-per-replica needs batching replicas (the mesh "
                "shards the admission megabatch); drop --no-batching")
        replica_argv.append("--no-batching")
    replica_argv += replica_mesh_argv(cfg.devices_per_replica, a.device)
    if a.device is not None:
        replica_argv += ["--device", a.device]
    fleet = Fleet(cfg=cfg, port=a.port, max_workers=a.workers,
                  replica_argv=replica_argv, env=fleet_env())
    _exit_on_sigterm()
    try:
        if not fleet.router.wait_healthy(a.replicas, timeout_s=60):
            print(f"error: only {fleet.router.healthy_count()}/"
                  f"{a.replicas} replicas admitted within 60s (see "
                  f"the replica logs under {fleet.workdir})",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "routing": True, "port": fleet.port,
            "replicas": [r.address for r in fleet.router.replicas],
            "healthy": fleet.router.healthy_count()}), flush=True)
        fleet.server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        fleet.close()
    return 0


def _fleet_degraded(m: dict) -> List[str]:
    """Why a ``Metrics`` reply is degraded (empty: healthy), the
    reference's reasons."""
    reasons = []
    if m.get("router"):
        if m.get("healthy", 0) < m.get("replicas", 0):
            reasons.append(f"{m.get('healthy', 0)}/"
                           f"{m.get('replicas', 0)} replicas healthy")
        for row in m.get("fleet", ()):
            if not row.get("healthy"):
                reasons.append(f"replica {row.get('replica')} "
                               f"{(row.get('state') or 'down')}")
            elif "error" in row:
                reasons.append(f"replica {row.get('replica')} metrics "
                               f"unreachable: {row['error']}")
    elif not m.get("ok"):
        reasons.append("replica reports not ok")
    return reasons


def _window_text(w: dict) -> str:
    return (f"rps {w.get('rps', 0)} p50 {w.get('p50_ms', 0)}ms "
            f"p99 {w.get('p99_ms', 0)}ms")


def _render_fleet_status(m: dict) -> str:
    """The fleet table of one poll (the reference's): a router's reply
    renders its fleet, a replica's its own window."""
    if not m.get("router"):
        return (f"replica | {_window_text(m.get('window', {}))}"
                f" | inflight {m.get('inflight', 0)} compiles "
                f"{m.get('compiles_total')} (+{m.get('compiles_delta')})"
                f" devices {m.get('serving_devices')}")
    c = m.get("counters", {})
    lines = [f"fleet {m.get('healthy', 0)}/{m.get('replicas', 0)} "
             f"healthy | {_window_text(m.get('window', {}))} | dispatched "
             f"{c.get('dispatched', 0)} failovers "
             f"{c.get('failovers', 0)} sheds {c.get('sheds', 0)}"]
    for row in m.get("fleet", ()):
        state = "up" if row.get("healthy") \
            else (row.get("state") or "down").upper()
        line = (f"  r{row.get('replica')} {row.get('address', ''):<21}"
                f" {state:<5} epoch {row.get('epoch')} "
                f"inflight {row.get('inflight')}")
        rm = row.get("metrics")
        if rm:
            line += (f" | {_window_text(rm.get('window', {}))} | compiles "
                     f"{rm.get('compiles_total')} "
                     f"(+{rm.get('compiles_delta')}) devices "
                     f"{rm.get('serving_devices')}")
        elif "error" in row:
            line += f" | error: {row['error']}"
        lines.append(line)
    return "\n".join(lines)


def cmd_fleet_status(a) -> int:
    """``fleet-status``: live fleet health over ``Metrics``; exit 0
    healthy, 1 degraded, 2 the target unreachable."""
    import time

    from gossip_tpu_torch.rpc.sidecar import SidecarClient
    from gossip_tpu_torch.utils import telemetry
    client = SidecarClient(a.address, max_attempts=1)
    rc = 2
    try:
        while True:
            try:
                m = client.metrics(timeout=a.timeout_s)
            except (client._grpc.RpcError, ValueError) as e:
                code = e.code() if callable(getattr(e, "code", None)) \
                    else None
                print(f"error: {a.address} unreachable "
                      f"({code or type(e).__name__})", file=sys.stderr)
                rc, m = 2, None
            if m is not None:
                reasons = _fleet_degraded(m)
                rc = 1 if reasons else 0
                if a.as_json:
                    print(json.dumps({"degraded": bool(reasons),
                                      "reasons": reasons,
                                      "metrics": m}), flush=True)
                else:
                    print(_render_fleet_status(m), flush=True)
                    for reason in reasons:
                        print(f"  DEGRADED: {reason}", flush=True)
                if a.out:
                    with open(a.out, "w") as f:
                        json.dump({"provenance": telemetry.provenance(),
                                   "degraded": bool(reasons),
                                   "reasons": reasons, "metrics": m},
                                  f, indent=1)
            if not a.watch:
                return rc
            time.sleep(a.interval_s)
    except KeyboardInterrupt:
        return rc
    finally:
        client.close()


def _add_serving_parsers(sub) -> None:
    """``serve``, ``route`` and ``fleet-status``: the JAX commands' flags
    and help, plus ``--device``."""
    device_help = ("cpu serves the plain versions (default: cuda, which "
                   "must be present)")
    p = sub.add_parser("serve", help="start the gRPC sidecar")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--no-batching", action="store_true",
                   help="disable the admission-batching serving layer "
                        "(per-request solo dispatch)")
    p.add_argument("--batch-tick-ms", type=float, default=20.0,
                   help="admission collector cadence")
    p.add_argument("--batch-max", type=int, default=64,
                   help="per-tick per-key megabatch lane cap")
    p.add_argument("--batch-queue", type=int, default=256,
                   help="backpressure cap: admissions past this depth "
                        "get RESOURCE_EXHAUSTED")
    p.add_argument("--devices", type=int, default=1,
                   help="megabatch mesh width (power of two): shard "
                        "each tick's megabatch over K spawned ranks; "
                        "refuses at startup when the process has fewer "
                        "cards (without --share-card)")
    p.add_argument("--share-card", action="store_true",
                   help="the --devices ranks share one card under gloo "
                        "(a test mode, not a speed-up)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="coordinator address when one replica spans "
                        "processes (refused: not ported yet)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="process count of one replica (1: one process)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's rank in [0, num-processes)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help=device_help)
    _add_cache_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("route", help="front N sidecar replicas with the "
                       "health-gated failover router")
    p.add_argument("--replicas", type=int, default=2,
                   help="sidecar replica processes to spawn")
    p.add_argument("--port", type=int, default=50051,
                   help="router port (replicas pick free ports)")
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--probe-interval-ms", type=float, default=250.0,
                   help="health-probe cadence per replica")
    p.add_argument("--down-after", type=int, default=2,
                   help="consecutive probe failures before a replica "
                        "leaves rotation")
    p.add_argument("--up-after", type=int, default=3,
                   help="consecutive healthy probes before a downed "
                        "replica re-enters rotation (flap hysteresis)")
    p.add_argument("--max-inflight", type=int, default=8,
                   help="per-replica in-flight cap; past it the router "
                        "sheds with RESOURCE_EXHAUSTED")
    p.add_argument("--no-batching", action="store_true",
                   help="disable admission batching in the replicas")
    p.add_argument("--devices-per-replica", type=int, default=1,
                   help="megabatch mesh width per replica (power of "
                        "two): children serve --devices K (with "
                        "--share-card on a host with fewer cards); the "
                        "fleet refuses loudly if a child reports fewer "
                        "serving devices")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the replicas' device: " + device_help)
    p.set_defaults(fn=cmd_route)

    p = sub.add_parser(
        "fleet-status", help="live fleet metrics table over the Metrics "
        "RPC; exits nonzero on a degraded replica")
    p.add_argument("address", metavar="HOST:PORT",
                   help="router address (renders the whole fleet) or a "
                        "single replica address (renders its window)")
    p.add_argument("--watch", action="store_true",
                   help="re-render every --interval seconds until ^C "
                        "(exit code reflects the LAST poll)")
    p.add_argument("--interval", dest="interval_s", type=float,
                   default=2.0, help="--watch poll cadence, seconds")
    p.add_argument("--timeout", dest="timeout_s", type=float,
                   default=10.0, help="per-poll Metrics RPC timeout")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="one JSON document per poll instead of the "
                        "table")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the latest poll as a provenance-"
                        "stamped fleet_status JSON document")
    p.set_defaults(fn=cmd_fleet_status)


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser; each command sets ``fn``."""
    ap = argparse.ArgumentParser(
        prog="gossip_tpu_torch",
        description="gossip simulation on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one simulation")
    p.add_argument("--backend", default="jax-tpu",
                   choices=("jax-tpu", "go-native"),
                   help="jax-tpu: this package's simulator on --device; "
                        "go-native: the reference node's event-driven "
                        "model on the C++ core (flood only, on the host)")
    p.add_argument("--mode", default=C.PUSH, choices=C.MODES)
    p.add_argument("--rumor-k", type=int, default=2,
                   help="rumor mongering: remove a rumor after this many "
                        "unnecessary (feedback) or total (blind) pushes")
    p.add_argument("--rumor-variant", default="feedback",
                   choices=C.RUMOR_VARIANTS)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--engine", default="auto",
                   choices=("auto", "fused", "xla", "native"),
                   help="auto: the fused kernel on a card where it is "
                        "eligible, else xla; fused: the CUDA round "
                        "kernels; xla: the threefry engine; native: "
                        "--backend go-native only, the C++ event core "
                        "with the node cap raised to 1M")
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
    p.add_argument("--parity-check", action="store_true",
                   help="flood only: run the same topology through the "
                        "flood rounds and the go-native event core (its "
                        "C++ engine above 20k nodes) and report "
                        "curve_gap (0 on race-free graphs), "
                        "hop_bound_violation and fixed_point_gap (0 "
                        "always)")
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
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpointed driver (SI single-device, sharded "
                        "packed via --devices, --engine fused planes, "
                        "swim, or rumor — the last two single-device or "
                        "sharded): "
                        "run max_rounds rounds saving an atomic npz every "
                        "--checkpoint-every rounds; with --resume, "
                        "continue a previous run from PATH (bitwise "
                        "continuation incl. the PRNG key); composes with "
                        "--curve/--save-curve (curve persists in the "
                        "checkpoint and resumes seamlessly)")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="load --checkpoint PATH and continue to "
                        "max_rounds total rounds")
    p.add_argument("--plan", default=None, metavar="FILE",
                   help="execute a ScalePlan (from `plan`) through the "
                        "streamed word-plane tile driver instead of the "
                        "flag-configured run; composes with --checkpoint/"
                        "--resume, --device and --share-card (the plan "
                        "carries n/rumors/fanout/faults/segments)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda, which "
                        "must be present)")
    # flags that compose with --plan; every other run flag is run shape
    # the plan file carries, refused by cmd_run when changed from its
    # default (the defaults are read from this parser, so a flag added
    # later is guarded too)
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the run into "
                        "LOGDIR (a Chrome trace; on a card with its CUDA "
                        "kernels)")
    _add_cache_flags(p)
    composable = {"plan", "checkpoint", "resume", "ensemble",
                  "parity_check", "curve", "save_curve", "device",
                  "share_card", "compile_cache", "no_compile_cache"}
    p.set_defaults(fn=cmd_run, plan_guard_defaults={
        k: v for k, v in vars(p.parse_args([])).items()
        if k not in composable})

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
    _add_cache_flags(p)
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
    _add_cache_flags(p)
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
    _add_cache_flags(p)
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
    _add_cache_flags(p)
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
    _add_cache_flags(p)
    p.set_defaults(fn=run_txn)

    p = sub.add_parser(
        "plan", help="device-memory budget model: what word-plane tiling "
        "fits N on these devices? (prints a ScalePlan as JSON, or refuses "
        "naming the binding constraint; pure host arithmetic)")
    p.add_argument("--n", type=int, default=100_000_000,
                   help="target node count")
    p.add_argument("--rumors", type=int, default=64)
    p.add_argument("--fanout", type=int, default=1)
    p.add_argument("--engine", default="packed",
                   choices=("packed", "dense", "fused"),
                   help="engine byte model (only 'packed' is executable "
                        "by scale-run)")
    p.add_argument("--max-rounds", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--origin", type=int, default=0)
    p.add_argument("--chips", type=int, default=1, help="total chip count")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="device memory per chip (GiB; fractional values "
                        "allowed; default: one H100's, planner/budget."
                        "H100_HBM_BYTES)")
    p.add_argument("--slices", type=int, default=1,
                   help="slices (chips/slices = the node mesh inside a "
                        "slice; >1 emits the hybrid mesh)")
    p.add_argument("--host-ram-gb", type=float, default=None,
                   help="host RAM (GiB; default: the card machine's, "
                        "planner/budget.HOST_RAM_BYTES)")
    p.add_argument("--segment-every", type=int, default=None,
                   help="checkpoint segment length in rounds")
    p.add_argument("--reserve", type=float, default=None,
                   help="device-memory fraction held back from the plan "
                        "(default: planner/budget.DEFAULT_RESERVE_FRAC, "
                        "0.08)")
    p.add_argument("--death", type=float, default=0.0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--scenario", default=None,
                   help="fault program spec, the churn-sweep syntax: "
                        "'event=N:D[:R];partition=S:E:C;ramp=S:E:P0:P1'")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="write the plan JSON here instead of stdout")
    p.add_argument("--validate", default=None, metavar="FILE",
                   help="validate an existing plan file instead of "
                        "planning")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser(
        "scale-run", help="execute a ScalePlan: stream word-plane tiles "
        "through the packed pull round per checkpoint segment")
    p.add_argument("--plan", required=True, metavar="FILE",
                   help="plan JSON from `plan`")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="publish an atomic npz checkpoint per segment")
    p.add_argument("--resume", action="store_true",
                   help="continue from --checkpoint (refuses a mismatched "
                        "plan or fault-program fingerprint)")
    p.add_argument("--check-bitwise", action="store_true",
                   help="also run the untiled in-memory reference and "
                        "gate byte equality (exit 1 on mismatch)")
    p.add_argument("--measure-memory", action="store_true",
                   help="the card's peak of allocated memory over the "
                        "first segment, against the plan's prediction")
    p.add_argument("--no-overlap", action="store_true",
                   help="drain each tile synchronously instead of "
                        "running the three-stage copy pipeline (the "
                        "serial leg; trajectories are bitwise identical "
                        "either way)")
    p.add_argument("--share-card", action="store_true",
                   help="run a plan's ranks on one card under gloo (a "
                        "test mode: NCCL takes one card a rank)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu runs the plain versions (default: cuda, which "
                        "must be present)")
    _add_cache_flags(p)
    p.set_defaults(fn=cmd_scale_run)
    _add_serving_parsers(sub)
    _add_runtime_parsers(sub)
    return ap


def _open_ledger():
    """The run ledger of this process (``GOSSIP_TELEMETRY``), or None
    when the variable is unset (a caller's ambient ledger stays).  Inside
    a launcher's group only rank 0 opens the file, and it decides for the
    group: one broadcast says whether its ledger is active, and the other
    ranks are peers only then (a round-metrics flush is a collective of
    every rank, so a rank 0 that failed to open its file must not leave
    its peers recording)."""
    import torch
    import torch.distributed as dist

    from gossip_tpu_torch.utils import telemetry
    if os.environ.get(telemetry.ENV_VAR) is None:
        return None
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return telemetry.from_env(argv=sys.argv)
    rank = dist.get_rank()
    led = telemetry.from_env(argv=sys.argv) if rank == 0 else None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    on = torch.tensor([int(getattr(led, "active", False))], device=dev)
    dist.broadcast(on, 0)
    if rank == 0:
        return led
    return telemetry.PeerLedger() if int(on) else telemetry.NullLedger()


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cmd in HOST_COMMANDS:
        try:
            return a.fn(a)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from gossip_tpu_torch.utils import telemetry
    joined = False
    led = prev = None
    try:
        # multi-host runs: join the launcher's process group first (a
        # no-op without its variables)
        from gossip_tpu_torch.parallel.multislice import \
            maybe_init_distributed
        if a.cmd not in SINGLE_PROCESS_COMMANDS:
            joined = maybe_init_distributed(
                "gloo" if a.device == "cpu" or a.share_card else None)
        led = _open_ledger()
        if led is not None:
            prev = telemetry.activate(led)
        _enable_compile_cache(a)
        if a.cmd in PAYLOAD_COMMANDS:
            print(json.dumps(a.fn(a, keep_state=False)[0]))
            return 0
        return a.fn(a)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if led is not None:
            telemetry.activate(prev)
            led.close()
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
