"""Serving load harness: replay concurrent requests against a live
admission-batching sidecar over gRPC and gate latency, throughput and
per-request bitwise equality from the run ledger.

The port's copy of the repository's ``tools/load_harness.py``.  Two legs
over the same request mix (four protocol shapes times distinct seeds,
``curve=True``, ``engine="xla"`` so that no request routes to a fused
kernel):

* **solo**: ``serve(batching=None)``, every request dispatched alone;
* **batched**: ``serve(batching=ServingConfig(...))``, the admission
  batcher coalescing concurrent requests into a megabatch a tick
  (:mod:`gossip_tpu_torch.rpc.batcher`).

Gates (exit 1 on any failure, ledgered as one ``serving_gate`` event),
the reference's:

* batched requests/s at least ``--min-ratio`` times solo requests/s;
* every batched reply's curve, msgs, coverage and rounds equal to its
  solo reply's, bitwise;
* steady state all warm: no ``kernel_build`` event
  (``ops/_kernels.build_events``, the mesh ranks' included) inside the
  batched measurement window, where the reference counts XLA compiles
  (ROADMAP queue 3 item 8(c)).

The ledger carries the per-tick ``batch`` events of the in-process
server, one ``load_leg`` summary per leg (p50, p95 and p99 latency, rps)
and the verdict::

    python -m gossip_tpu_torch.tools.load_harness --smoke --device cpu
    python -m gossip_tpu_torch.tools.load_harness --out serving.jsonl

**Meshserve mode** (``--mesh-devices``): one leg per (replica count,
devices per replica) pair over the same request list at fixed
concurrency, each request on its own client connection (one channel and
thread each), so ``--connections`` is the concurrency.  One-replica legs
serve in this process (their ``batch`` events land on this ledger, the
all-warm gate's evidence); more replicas spawn a
:class:`~gossip_tpu_torch.rpc.router.Fleet` whose replicas serve
``--devices K``.  Every leg's replies are held bitwise against references
computed once by the single-device driver (a lane's reply is its solo
run's whatever its batch mates, so one reference set serves every leg),
and the ``meshserve_gate`` needs the widest mesh's rps to reach
``--mesh-min-ratio`` (1.5) times the one-device leg's.  Where the
machine cannot run the widest mesh's ranks in parallel (fewer
schedulable CPUs than ranks on the CPU; ranks sharing one card under
``--share-card``), the scaling is unresolved: the gate then holds the
reference's serial floor, 0.85, and records ``scaling_resolved: false``
with its reason::

    python -m gossip_tpu_torch.tools.load_harness --mesh-devices 1,2 \\
        --connections 64 --rate 40 --device cpu

``--rate R`` (the port's) replays the requests open-loop at R arrivals a
second, evenly spaced, each latency counted from its scheduled arrival;
without it a leg sends as fast as its connections allow, the
reference's closed loop.  ``--device cpu`` runs every leg on the CPU;
by default they run on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from gossip_tpu_torch.utils import telemetry


def request_mix(n=256, rounds=16, fanout=2, repeats=8, seed0=0):
    """The request mix both legs replay (the reference's): push-pull
    under a churn schedule (a partition window mid-run), pull under a
    static fault, plain push, and period-2 anti-entropy under link loss,
    each repeated with distinct seeds.  All four share one batch key, so
    a megabatch mixes modes, faults and schedules."""
    shapes = [
        ({"mode": "pushpull", "fanout": fanout},
         {"drop_prob": 0.05, "seed": 3,
          "churn": {"events": [[3, 1, 4]],
                    "partitions": [[1, 3, n // 2]]}}),
        ({"mode": "pull", "fanout": fanout},
         {"node_death_rate": 0.05, "drop_prob": 0.05, "seed": 5}),
        ({"mode": "push", "fanout": fanout}, None),
        ({"mode": "antientropy", "fanout": fanout, "period": 2},
         {"drop_prob": 0.1, "seed": 7}),
    ]
    reqs = []
    for r in range(repeats):
        for i, (proto, fault) in enumerate(shapes):
            req = {"backend": "jax-tpu", "proto": proto,
                   "topology": {"family": "complete", "n": n},
                   "run": {"max_rounds": rounds, "engine": "xla",
                           "seed": seed0 + 31 * r + i},
                   "curve": True}
            if fault is not None:
                req["fault"] = fault
            reqs.append(req)
    return reqs


def distinct_requests(requests):
    """One request per distinct shape (everything but the ``run`` block):
    the warm-up set of the solo leg, the fleet legs and
    :mod:`gossip_tpu_torch.tools.fleet_crashloop`."""
    seen, out = set(), []
    for req in requests:
        sig = json.dumps({k: v for k, v in req.items() if k != "run"},
                         sort_keys=True)
        if sig not in seen:
            seen.add(sig)
            out.append(req)
    return out


def _group_by_key(requests, device):
    """``{BatchKey: [(index, spec), ...]}`` of a batchable request list."""
    from gossip_tpu_torch.backend import request_to_args
    from gossip_tpu_torch.rpc.batcher import classify_run
    by_key = {}
    for i, req in enumerate(requests):
        key, spec, _ = classify_run(request_to_args(dict(req)), device)
        if key is None:
            raise SystemExit(f"load mix contains an unbatchable "
                             f"request: {spec}")
        by_key.setdefault(key, []).append((i, spec))
    return by_key


def reference_replies(requests, serving_cfg, device):
    """The expected reply of every request, from the single-device driver
    in chunks of ``max_batch`` lanes: a lane's result is its solo run's
    whatever its batch mates (``tests/test_torch_serving.py``), so these
    are the bytes every leg must return."""
    from gossip_tpu_torch.parallel.sweep import request_sweep_curves
    from gossip_tpu_torch.rpc.batcher import _topo_for
    refs = [None] * len(requests)
    for key, entries in _group_by_key(requests, device).items():
        for at in range(0, len(entries), serving_cfg.max_batch):
            chunk = entries[at:at + serving_cfg.max_batch]
            res = request_sweep_curves(
                tuple(s for _, s in chunk),
                topo=_topo_for(key.topology, device),
                n_pad=(None if key.topology is not None
                       else key.n_bucket), device=device)
            for j, (i, _) in enumerate(chunk):
                curve = [float(c) for c in res.curves[j]]
                refs[i] = {"curve": curve, "coverage": curve[-1],
                           "msgs": float(res.msgs[j][-1]),
                           "rounds": int(res.rounds_to_target[j])}
    return refs


def warm(address, requests, timeout_s):
    """Each distinct shape once through the server at ``address``,
    outside any measured window (the card's first launches and
    allocations; the mesh ranks' too)."""
    from gossip_tpu_torch.rpc.sidecar import SidecarClient
    client = SidecarClient(address, max_attempts=1)
    try:
        for req in distinct_requests(requests):
            client.run(timeout=timeout_s, **req)
    finally:
        client.close()


def run_leg(label, requests, workers, serving_cfg, timeout_s, led,
            address=None, devices=1, attempts=1, device=None, rate=None):
    """One measured leg: serve in this process on ``device`` (unless
    ``address`` names a running server), warm it, then replay the mix
    from ``workers`` client threads, each with its own channel (so
    ``workers == len(requests)`` is one connection a request):
    ``(summary, replies)``.  ``rate`` releases request i at ``i / rate``
    seconds after the start and counts its latency from then; without it
    each thread sends its next request as soon as its last returns.
    ``attempts`` is each client's UNAVAILABLE retry budget (a reply is a
    pure function of its payload, so a retry cannot change the bitwise
    gate)."""
    from gossip_tpu_torch.rpc.sidecar import SidecarClient, serve
    server = None
    if address is None:
        server, port = serve(port=0, max_workers=workers + 4,
                             batching=serving_cfg, device=device)
        address = f"127.0.0.1:{port}"
        warm(address, requests, timeout_s)
    n_req = len(requests)
    replies = [None] * n_req
    lat_ms = [None] * n_req
    errors = []
    cursor = {"i": 0}
    lock = threading.Lock()

    def worker():
        client = SidecarClient(address, max_attempts=attempts)
        while True:
            with lock:
                i = cursor["i"]
                if i >= n_req:
                    break
                cursor["i"] = i + 1
            if rate:
                t_arrive = t0 + i / rate
                time.sleep(max(0.0, t_arrive - time.perf_counter()))
            else:
                t_arrive = time.perf_counter()
            try:
                replies[i] = client.run(timeout=timeout_s, **requests[i])
            except Exception as e:          # ledgered, gated below
                errors.append(f"req {i}: {type(e).__name__}: "
                              f"{str(e).splitlines()[0][:200]}")
            lat_ms[i] = (time.perf_counter() - t_arrive) * 1e3
        client.close()
    led.event("load_phase", leg=label, phase="measure_start")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    led.event("load_phase", leg=label, phase="measure_end")
    if server is not None:
        if server.gossip_batcher is not None:
            server.gossip_batcher.close()
        server.stop(grace=None)
    lat = [x for x in lat_ms if x is not None]
    summary = {
        "leg": label, "requests": n_req, "workers": workers,
        "devices": devices, "rate": rate,
        "errors": len(errors), "wall_s": round(wall, 3),
        "rps": round(n_req / wall, 2),
        "p50_ms": round(telemetry.percentile(lat, 0.50), 1),
        "p95_ms": round(telemetry.percentile(lat, 0.95), 1),
        "p99_ms": round(telemetry.percentile(lat, 0.99), 1),
    }
    led.event("load_leg", **summary)
    for msg in errors[:10]:
        led.event("load_error", leg=label, error=msg)
    return summary, replies


def compare_replies(batched, solo):
    """Per-request bitwise equality of curve, msgs, coverage and rounds:
    the mismatches' descriptions (empty: all equal)."""
    bad = []
    for i, (b, s) in enumerate(zip(batched, solo)):
        if b is None or s is None:
            bad.append(f"req {i}: missing reply "
                       f"(batched={b is not None}, solo={s is not None})")
            continue
        for field in ("curve", "msgs", "coverage", "rounds"):
            if b.get(field) != s.get(field):
                bad.append(f"req {i}: {field} differs")
                break
    return bad


def measure_window_batch_events(path, run_id, leg="batched"):
    """The ``batch`` events between one leg's ``load_phase`` markers: the
    all-warm gate's evidence."""
    events = telemetry.load_ledger(path, run=run_id)
    out, active = [], False
    for e in events:
        if e.get("ev") == "load_phase" and e.get("leg") == leg:
            active = e.get("phase") == "measure_start"
        elif e.get("ev") == "batch" and active:
            out.append(e)
    return out


def emit_trace_join(led, out_path):
    """Join this run's request traces
    (:mod:`gossip_tpu_torch.tools.trace_report`) and ledger the summary
    and the slowest three as a ``trace_join`` event.  In-process legs
    write both halves of a trace here; spawned replicas write no ledger
    here, so their traces join router half only (reported, not
    gated)."""
    from gossip_tpu_torch.tools import trace_report
    rows = trace_report.waterfalls(trace_report.load_events([out_path]))
    if not rows:
        return None
    summary = trace_report.summarize(rows)
    led.event("trace_join", **summary,
              exemplars=trace_report.exemplars(rows, k=3))
    return summary


# Where the machine cannot run the widest mesh's ranks in parallel, the
# scaling leg is unresolved: the ratio gate then holds only that the mesh
# does not fall behind the one-device leg by more than harness noise
# (the reference's floor), and the gate event records
# scaling_resolved=false with its reason.
_SERIAL_HOST_FLOOR = 0.85


def scaling_resolution(peak: int, device):
    """``(resolved, sched_cpus, reason)``: whether ``peak`` ranks can run
    in parallel here.  CPU ranks need as many schedulable CPUs (the
    reference's rule); card ranks need a card each (on fewer cards they
    share one under gloo and take turns on it, a test mode)."""
    try:
        sched_cpus = len(os.sched_getaffinity(0))
    except AttributeError:                  # not Linux
        sched_cpus = os.cpu_count() or 1
    if device.type == "cpu":
        return (sched_cpus >= peak, sched_cpus,
                f"{sched_cpus} schedulable CPUs for {peak} CPU ranks")
    import torch
    cards = torch.cuda.device_count()
    if cards < peak:
        return (False, sched_cpus, f"{peak} ranks share one card under "
                f"gloo ({cards} card(s), --share-card)")
    return True, sched_cpus, f"{peak} ranks on {cards} cards"


def run_meshserve(args, led, out_path, device):
    """The per-(replica count, devices per replica) legs: references
    once, then one fixed-concurrency leg per pair and the
    ``meshserve_gate`` (module doc)."""
    from gossip_tpu_torch.config import ServingConfig
    from gossip_tpu_torch.rpc.router import replica_mesh_argv
    devices_list = sorted({int(d) for d in args.mesh_devices.split(",")
                           if d})
    replicas_list = sorted({int(r) for r in args.mesh_replicas.split(",")
                            if r})
    connections = args.connections
    peak = devices_list[-1]
    resolved, sched_cpus, reason = scaling_resolution(peak, device)
    # a 2 MiB stack a client thread: they only drive a channel
    if connections >= 512:
        threading.stack_size(2 * 1024 * 1024)
    base = request_mix(n=args.n, rounds=args.rounds, fanout=args.fanout,
                       repeats=(connections + 3) // 4)
    requests = base[:connections]
    led.event("load_config", mode="meshserve", requests=len(requests),
              connections=connections, devices_legs=devices_list,
              replicas_legs=replicas_list, n=args.n, rounds=args.rounds,
              tick_ms=args.tick_ms, max_batch=args.max_batch,
              rate=args.rate, device=device.type, smoke=bool(args.smoke))

    def cfg_for(devs):
        return ServingConfig(
            tick_ms=args.tick_ms, max_batch=args.max_batch,
            max_queue=connections + 256, devices=devs,
            shared_card="--share-card" in replica_mesh_argv(devs,
                                                            device.type))

    led.event("load_phase", leg="warmup", phase="start")
    refs = reference_replies(requests, cfg_for(1), device)
    led.event("load_phase", leg="warmup", phase="end",
              references=len(refs))

    legs, mismatch_total, errors_total, compiles_total = {}, 0, 0, 0
    for reps in replicas_list:
        for devs in devices_list:
            label = f"mesh_r{reps}_d{devs}"
            if reps == 1:
                summary, replies = run_leg(
                    label, requests, connections, cfg_for(devs),
                    args.timeout_s, led, devices=devs, attempts=4,
                    device=device, rate=args.rate)
                evs = measure_window_batch_events(out_path, led.run_id,
                                                  leg=label)
                compiles = sum(e.get("compiles") or 0 for e in evs)
                summary["measure_compiles"] = compiles
                compiles_total += compiles
            else:
                from gossip_tpu_torch.config import FleetConfig
                from gossip_tpu_torch.rpc.router import Fleet, fleet_env
                fleet = Fleet(
                    cfg=FleetConfig(replicas=reps,
                                    devices_per_replica=devs,
                                    max_inflight=connections),
                    replica_argv=(replica_mesh_argv(devs, device.type)
                                  + ["--device", device.type]),
                    env=fleet_env(), max_workers=connections + 4)
                try:
                    if not fleet.router.wait_healthy(reps, timeout_s=60):
                        raise SystemExit(f"{label}: fleet never reached "
                                         "full health")
                    for r in fleet.router.replicas:
                        warm(r.address, requests, args.timeout_s)
                    summary, replies = run_leg(
                        label, requests, connections, None,
                        args.timeout_s, led, address=fleet.address,
                        devices=devs, attempts=4, rate=args.rate)
                    # the replicas' builds are not on this ledger:
                    # recorded as unmeasured, never as zero
                    summary["measure_compiles"] = None
                finally:
                    fleet.close()
            bad = compare_replies(replies, refs)
            for m in bad[:10]:
                led.event("equality_mismatch", leg=label, detail=m)
            summary["bitwise_equal"] = not bad
            mismatch_total += len(bad)
            errors_total += summary["errors"]
            legs[label] = summary

    base_leg = legs.get(f"mesh_r1_d{devices_list[0]}")
    peak_leg = legs.get(f"mesh_r1_d{peak}")
    ratio = (peak_leg["rps"] / base_leg["rps"]
             if base_leg and peak_leg and base_leg["rps"] else 0.0)
    if args.mesh_min_ratio <= 0:
        ok_ratio = True
    elif resolved:
        ok_ratio = ratio >= args.mesh_min_ratio
    else:
        ok_ratio = ratio >= _SERIAL_HOST_FLOOR
    ok = (ok_ratio and mismatch_total == 0 and errors_total == 0
          and compiles_total == 0)
    led.event("meshserve_gate", ok=ok, devices_ratio=round(ratio, 2),
              min_ratio=args.mesh_min_ratio, ratio_ok=ok_ratio,
              sched_cpus=sched_cpus, scaling_resolved=resolved,
              scaling_reason=reason,
              serial_host_floor=(None if resolved
                                 else _SERIAL_HOST_FLOOR),
              connections=connections, base_devices=devices_list[0],
              peak_devices=peak, bitwise_equal=mismatch_total == 0,
              mismatches=mismatch_total,
              steady_all_warm=compiles_total == 0,
              measure_compiles=compiles_total, errors=errors_total,
              legs=legs)
    emit_trace_join(led, out_path)
    print(json.dumps({"ok": ok, "mode": "meshserve",
                      "devices_ratio": round(ratio, 2),
                      "ratio_ok": ok_ratio,
                      "scaling_resolved": resolved,
                      "scaling_reason": reason,
                      "sched_cpus": sched_cpus,
                      "connections": connections,
                      "legs": {k: {f: v[f] for f in
                                   ("rps", "p50_ms", "p95_ms", "p99_ms",
                                    "errors", "bitwise_equal")}
                               for k, v in legs.items()},
                      "bitwise_equal": mismatch_total == 0,
                      "steady_all_warm": compiles_total == 0,
                      "ledger": out_path}))
    return 0 if ok else 1


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=16,
                    help="repeats of the 4-shape mix (requests = 4x)")
    ap.add_argument("--workers", type=int, default=24)
    ap.add_argument("--tick-ms", type=float, default=25.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--min-ratio", type=float, default=3.0,
                    help="batched/solo rps acceptance (0 disables)")
    ap.add_argument("--timeout-s", type=float, default=300.0)
    ap.add_argument("--fleet-replicas", type=int, default=0,
                    help="also run the mix through a router over N "
                         "spawned replicas, its replies held bitwise to "
                         "the solo leg's (0: off)")
    ap.add_argument("--mesh-devices", default=None,
                    help="meshserve mode: comma list of devices-per-"
                         "replica leg widths (e.g. '1,2')")
    ap.add_argument("--mesh-replicas", default="1",
                    help="meshserve mode: comma list of replica counts "
                         "to cross with --mesh-devices")
    ap.add_argument("--connections", type=int, default=2048,
                    help="meshserve mode: concurrent client connections "
                         "= requests per leg")
    ap.add_argument("--mesh-min-ratio", type=float, default=1.5,
                    help="meshserve acceptance: widest-mesh rps / "
                         "1-device rps (0 disables)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrivals a second, evenly spaced "
                         "(default: closed loop)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu serves the plain versions (default: cuda, "
                         "which must be present)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny live batch: 2 repeats, 4 workers, no "
                         "throughput gate (equality and all-warm still "
                         "gate)")
    ap.add_argument("--out", default=None,
                    help="ledger path (default: a temporary file)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.smoke:
        args.repeats = min(args.repeats, 2)
        args.workers = min(args.workers, 4)
        args.n = min(args.n, 128)
        args.rounds = min(args.rounds, 8)
        args.min_ratio = 0.0
        args.mesh_min_ratio = 0.0
        args.connections = min(args.connections, 64)
        if args.out and args.out.endswith(".jsonl"):
            args.out = args.out[:-len(".jsonl")] + ".smoke.jsonl"

    from gossip_tpu_torch.backend import dispatch, request_to_args
    from gossip_tpu_torch.config import ServingConfig
    from gossip_tpu_torch.ops.common import resolve_device
    device = resolve_device(args.device)
    out_path = args.out
    if not out_path:
        import tempfile
        fd, out_path = tempfile.mkstemp(prefix="gossip_serving_",
                                        suffix=".jsonl")
        os.close(fd)
    led = telemetry.Ledger(out_path)
    prev = telemetry.activate(led)
    try:
        led.record_runtime()
        if args.mesh_devices:
            return run_meshserve(args, led, out_path, device)
        requests = request_mix(n=args.n, rounds=args.rounds,
                               fanout=args.fanout, repeats=args.repeats)
        serving = ServingConfig(tick_ms=args.tick_ms,
                                max_batch=args.max_batch,
                                max_queue=max(4 * args.max_batch, 256))
        led.event("load_config", requests=len(requests),
                  workers=args.workers, n=args.n, rounds=args.rounds,
                  tick_ms=args.tick_ms, max_batch=args.max_batch,
                  rate=args.rate, device=device.type,
                  smoke=bool(args.smoke))

        # warm-up (unmeasured): each distinct request solo, each batch
        # key's megabatch once, then each leg warms its own server
        led.event("load_phase", leg="warmup", phase="start")
        distinct = distinct_requests(requests)
        for req in distinct:
            dispatch(**request_to_args(dict(req)), device=device)
        reference_replies(requests, serving, device)
        led.event("load_phase", leg="warmup", phase="end",
                  distinct_configs=len(distinct),
                  batch_keys=len(_group_by_key(requests, device)))

        solo, solo_replies = run_leg("solo", requests, args.workers, None,
                                     args.timeout_s, led, device=device,
                                     rate=args.rate)
        batched, batched_replies = run_leg("batched", requests,
                                           args.workers, serving,
                                           args.timeout_s, led,
                                           device=device, rate=args.rate)

        fleet_ok = True
        if args.fleet_replicas > 0:
            from gossip_tpu_torch.config import FleetConfig
            from gossip_tpu_torch.rpc.router import Fleet, fleet_env
            fleet = Fleet(
                cfg=FleetConfig(replicas=args.fleet_replicas,
                                max_inflight=max(8, args.workers)),
                replica_argv=["--device", device.type], env=fleet_env(),
                max_workers=args.workers + 4)
            try:
                if not fleet.router.wait_healthy(args.fleet_replicas,
                                                 timeout_s=60):
                    raise SystemExit("fleet never reached full health")
                # each replica warmed directly (the router would send
                # serial traffic to one replica)
                for r in fleet.router.replicas:
                    warm(r.address, requests, args.timeout_s)
                fleet_sum, fleet_replies = run_leg(
                    f"fleet_r{args.fleet_replicas}", requests,
                    args.workers, None, args.timeout_s, led,
                    address=fleet.address, rate=args.rate)
                fleet_mismatch = compare_replies(fleet_replies,
                                                 solo_replies)
                for m in fleet_mismatch[:10]:
                    led.event("equality_mismatch", leg="fleet", detail=m)
                fleet_ok = not fleet_mismatch and not fleet_sum["errors"]
                led.event("fleet_gate", ok=fleet_ok,
                          replicas=args.fleet_replicas,
                          bitwise_equal=not fleet_mismatch,
                          mismatches=len(fleet_mismatch),
                          rps=fleet_sum["rps"],
                          p50_ms=fleet_sum["p50_ms"],
                          p95_ms=fleet_sum["p95_ms"],
                          p99_ms=fleet_sum["p99_ms"],
                          stats=fleet.router.stats())
            finally:
                fleet.close()

        mismatches = compare_replies(batched_replies, solo_replies)
        for m in mismatches[:10]:
            led.event("equality_mismatch", detail=m)
        batch_evs = measure_window_batch_events(out_path, led.run_id)
        compiles = sum(e.get("compiles") or 0 for e in batch_evs)
        sizes = [e.get("batch_size", 0) for e in batch_evs]
        ratio = (batched["rps"] / solo["rps"]) if solo["rps"] else 0.0
        coalesced = any(s > 1 for s in sizes)
        ok_ratio = (args.min_ratio <= 0) or (ratio >= args.min_ratio)
        ok = (ok_ratio and not mismatches and compiles == 0
              and not solo["errors"] and not batched["errors"]
              and coalesced and fleet_ok)
        led.event("serving_gate", ok=ok, throughput_ratio=round(ratio, 2),
                  min_ratio=args.min_ratio, ratio_ok=ok_ratio,
                  bitwise_equal=not mismatches,
                  mismatches=len(mismatches),
                  steady_all_warm=compiles == 0,
                  measure_compiles=compiles, batch_events=len(batch_evs),
                  max_batch_size=max(sizes) if sizes else 0,
                  coalesced=coalesced, solo=solo, batched=batched)
        traces = emit_trace_join(led, out_path)
        print(json.dumps({"ok": ok, "ratio": round(ratio, 2),
                          "traces": (traces or {}).get("traces", 0),
                          "complete_waterfalls":
                              (traces or {}).get("complete", 0),
                          "solo_rps": solo["rps"],
                          "batched_rps": batched["rps"],
                          "batched_p50_ms": batched["p50_ms"],
                          "batched_p95_ms": batched["p95_ms"],
                          "batched_p99_ms": batched["p99_ms"],
                          "bitwise_equal": not mismatches,
                          "steady_all_warm": compiles == 0,
                          "max_batch_size": max(sizes) if sizes else 0,
                          "ledger": out_path}))
        return 0 if ok else 1
    finally:
        telemetry.activate(prev)
        led.close()


if __name__ == "__main__":
    sys.exit(main())
