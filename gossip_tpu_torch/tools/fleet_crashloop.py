"""Fleet crashloop: the nemesis pointed at the serving fleet itself.

The port's copy of the repository's ``tools/fleet_crashloop.py``.  It
drives the load harness's request mix
(:func:`gossip_tpu_torch.tools.load_harness.request_mix`) through the
failover router (:class:`gossip_tpu_torch.rpc.router.Fleet`, N spawned
``serve`` replicas) from concurrent client threads, SIGKILLs K replicas
at seeded mid-load acked-count thresholds, respawns each one, and gates
the fleet contract, the reference's gates:

* **zero acked-request loss**: every request of the mix is acked with a
  valid reply despite the kills (the router sends a dead replica's
  in-flight requests to a survivor; no client sees a transport error);
* **every reply bitwise its solo run's**: each fleet reply's curve,
  msgs, coverage and rounds equal an in-process solo dispatch of the
  same payload (a request is a pure function of its payload, so a
  failover replay cannot fork a trajectory);
* **failover in the ledger**: one ``kill`` event a SIGKILL and the
  router's ``replica_down``, ``failover``, ``replica_up`` and
  ``control_catchup`` events (a respawned replica catches its config
  epoch up from the survivors' views);
* **recovery to full capacity**: every killed replica is respawned and
  re-admitted by the probe hysteresis, ending at N healthy.

::

    python -m gossip_tpu_torch.tools.fleet_crashloop --smoke --device cpu \\
        --out fleet.jsonl

The replicas take ``--device`` (the reference's ``--replica-platform``
pins JAX's platform instead; ROADMAP queue 3 item 8(g)) and share one
kernel store, so a respawned replica loads its predecessors' builds.
Without ``--device cpu`` every replica serves on the card.  It prints
one JSON line and exits 0, or names each broken gate on stderr and
exits 1.
"""

import argparse
import json
import os
import random
import sys
import threading
import time

from gossip_tpu_torch.tools.load_harness import (compare_replies,
                                                 distinct_requests,
                                                 request_mix)


def solo_references(requests, device):
    """Each request's solo dispatch in this process on ``device`` (the
    parity targets): the entry point a ``--no-batching`` replica runs a
    request, and with ``curve=True`` its numbers are the megabatch's."""
    from gossip_tpu_torch.backend import dispatch, request_to_args
    return [dispatch(**request_to_args(dict(req)), device=device).to_dict()
            for req in requests]


def kill_thresholds(kills: int, total: int, seed: int):
    """One seeded acked-count threshold in each equal slice of the
    middle three fifths of the run: every kill lands mid-load (never
    before the first ack, never after the last), spread over the run."""
    rng = random.Random(seed)
    lo, hi = max(1, total // 5), max(2, (4 * total) // 5)
    pool = []
    for i in range(kills):
        s0 = lo + (hi - lo) * i // kills
        s1 = max(s0 + 1, lo + (hi - lo) * (i + 1) // kills)
        pool.append(rng.randrange(s0, s1))
    return sorted(pool), rng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--kills", type=int, default=2,
                    help="seeded mid-load replica SIGKILLs")
    ap.add_argument("--kill-seed", type=int, default=18,
                    help="seeds the kill thresholds and victim draws "
                         "(a failing sequence replays exactly)")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=12,
                    help="repeats of the 4-shape load-harness mix")
    ap.add_argument("--workers", type=int, default=12)
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="per-request client deadline (bounds queue "
                         "wait + run + failover end to end)")
    ap.add_argument("--probe-interval-ms", type=float, default=200.0)
    ap.add_argument("--up-after", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the replicas' and the references' device: cpu "
                         "serves the plain versions (default: cuda, "
                         "which must be present)")
    ap.add_argument("--workdir", default=None,
                    help="replica log/cache scratch dir (default: a "
                         "fresh temp dir)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny live fleet: 2 replicas, 1 kill, 8 "
                         "requests (every gate still enforced)")
    ap.add_argument("--out", default=None,
                    help="ledger path (default: a file in the workdir)")
    a = ap.parse_args(argv)
    if a.smoke:
        a.replicas = min(a.replicas, 2)
        a.kills = min(a.kills, 1)
        a.repeats = min(a.repeats, 2)
        a.workers = min(a.workers, 4)
        a.n = min(a.n, 128)
        a.rounds = min(a.rounds, 8)

    if a.workdir is None:
        import tempfile
        a.workdir = tempfile.mkdtemp(prefix="fleet_crashloop_")
    os.makedirs(a.workdir, exist_ok=True)
    if a.out is None:
        a.out = os.path.join(a.workdir, "fleet.jsonl")

    from gossip_tpu_torch.config import FleetConfig
    from gossip_tpu_torch.ops.common import resolve_device
    from gossip_tpu_torch.rpc.router import Fleet, fleet_env
    from gossip_tpu_torch.rpc.sidecar import SidecarClient
    from gossip_tpu_torch.utils import telemetry
    device = resolve_device(a.device)

    led = telemetry.Ledger(a.out)
    prev = telemetry.activate(led)   # router events land in this file
    fleet = None
    try:
        led.record_runtime()
        requests = request_mix(n=a.n, rounds=a.rounds,
                               repeats=a.repeats)
        total = len(requests)
        thresholds, rng = kill_thresholds(a.kills, total, a.kill_seed)
        led.event("config", replicas=a.replicas, kills=a.kills,
                  kill_seed=a.kill_seed, kill_thresholds=thresholds,
                  requests=total, workers=a.workers, n=a.n,
                  rounds=a.rounds, device=device.type,
                  smoke=bool(a.smoke))

        # ---- solo parity references (in-process, unmeasured) --------
        t0 = time.perf_counter()
        refs = solo_references(requests, device)
        led.event("solo_refs_done",
                  wall_s=round(time.perf_counter() - t0, 3),
                  distinct=len({json.dumps(r, sort_keys=True)
                                for r in requests}))

        # ---- the fleet ----------------------------------------------
        cfg = FleetConfig(replicas=a.replicas,
                          probe_interval_ms=a.probe_interval_ms,
                          up_after=a.up_after,
                          max_inflight=max(8, a.workers))
        env = fleet_env(
            compile_cache_dir=os.path.join(a.workdir, "cache"))
        fleet = Fleet(cfg=cfg, workdir=a.workdir, env=env,
                      replica_argv=["--device", device.type],
                      max_workers=a.workers + 4)
        if not fleet.router.wait_healthy(a.replicas, timeout_s=60):
            raise RuntimeError("fleet never reached full health at "
                               "startup")
        # each replica warmed directly (the router would send all of a
        # serial warm-up to one replica): one pass of the distinct shapes
        # a replica
        t0 = time.perf_counter()
        distinct = distinct_requests(requests)
        for r in fleet.router.replicas:
            c = SidecarClient(r.address, max_attempts=1)
            for req in distinct:
                c.run(timeout=a.timeout_s, **req)
            c.close()
        led.event("warmup_done",
                  wall_s=round(time.perf_counter() - t0, 3),
                  distinct=len(distinct))

        # ---- measured run: concurrent load + seeded kills -----------
        replies = [None] * total
        errors = []
        acked = {"count": 0}
        cursor = {"i": 0}
        lock = threading.Lock()

        def worker():
            client = SidecarClient(fleet.address, max_attempts=1)
            while True:
                with lock:
                    i = cursor["i"]
                    if i >= total:
                        break
                    cursor["i"] = i + 1
                try:
                    replies[i] = client.run(timeout=a.timeout_s,
                                            **requests[i])
                    with lock:
                        acked["count"] += 1
                except Exception as e:
                    with lock:
                        errors.append(
                            f"req {i}: {type(e).__name__}: "
                            f"{str(e).splitlines()[0][:200]}")
            client.close()

        led.event("load_phase", phase="measure_start")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker)
                   for _ in range(a.workers)]
        for t in threads:
            t.start()
        # the killer: poll the acked counter, SIGKILL at each seeded
        # threshold and respawn at once (the probe hysteresis and the
        # control-plane catch-up re-admit the replacement)
        kills_done = 0
        kill_acked = []
        for threshold in thresholds:
            while True:
                with lock:
                    now_acked = acked["count"]
                    done = cursor["i"] >= total
                if now_acked >= threshold:
                    break
                if done and not any(t.is_alive() for t in threads):
                    break
                time.sleep(0.002)
            with lock:
                now_acked = acked["count"]
            if now_acked >= total:
                led.event("kill_vacuous", threshold=threshold,
                          acked=now_acked)
                break      # nothing left mid-load to interrupt
            # the victim is a healthy replica (in rotation) with a live
            # process: a respawned one still waiting for re-admission has
            # nothing in flight, and killing it would write no
            # replica_down (it is down already)
            live = [i for i, r in enumerate(fleet.router.replicas)
                    if r.proc is not None and r.proc.poll() is None
                    and r.healthy]
            if not live:
                led.event("kill_skipped", threshold=threshold,
                          reason="no healthy replica to interrupt")
                continue
            victim = rng.choice(live)
            pid = fleet.kill(victim)
            kills_done += 1
            kill_acked.append(now_acked)
            led.event("kill", seq=kills_done, replica=victim, pid=pid,
                      threshold=threshold, acked=now_acked,
                      run_id=led.run_id)
            addr = fleet.restart(victim)
            led.event("respawn", replica=victim, address=addr)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        led.event("load_phase", phase="measure_end",
                  wall_s=round(wall, 3),
                  rps=round(total / wall, 2) if wall else None)

        # ---- recovery to full capacity ------------------------------
        recovered = fleet.router.wait_healthy(a.replicas,
                                              timeout_s=120)
        stats = fleet.router.stats()
        led.event("recovered", ok=recovered, **stats)

        # ---- verdict ------------------------------------------------
        problems = list(errors)
        if kills_done < a.kills:
            problems.append(f"only {kills_done}/{a.kills} kills "
                            "landed (raise --repeats)")
        for k, at in enumerate(kill_acked):
            if not 0 < at < total:
                problems.append(f"kill {k + 1} landed at acked={at} "
                                f"of {total} — not mid-load")
        mismatches = compare_replies(replies, refs)
        for m in mismatches[:10]:
            led.event("parity_mismatch", detail=m)
        if mismatches:
            problems.append(f"{len(mismatches)} replies differ from "
                            "solo dispatch")
        if not recovered:
            problems.append(
                f"fleet never recovered to {a.replicas} healthy "
                f"replicas (healthy={stats['healthy']})")
        events = telemetry.load_ledger(a.out, run=led.run_id)

        def count(kind):
            return sum(1 for e in events if e.get("ev") == kind)
        if count("replica_down") < kills_done:
            problems.append("fewer replica_down events than kills — "
                            "the failover path was not exercised")
        if kills_done and count("failover") < 1:
            problems.append("no failover event: no in-flight request "
                            "was ever re-dispatched")
        if count("replica_up") < kills_done + a.replicas:
            problems.append("fewer replica_up events than "
                            "kills + initial admissions")
        if count("control_catchup") < kills_done:
            problems.append("a respawned replica never caught its "
                            "config epoch up from gossip")
        led.event("verdict", ok=not problems, kills=kills_done,
                  kill_acked=kill_acked, requests=total,
                  acked=acked["count"], errors=len(errors),
                  zero_acked_loss=not errors
                  and acked["count"] == total,
                  bitwise_equal=not mismatches,
                  mismatches=len(mismatches),
                  failovers=stats["failovers"],
                  recovered_full_capacity=recovered,
                  healthy=stats["healthy"], epochs=stats["epochs"],
                  problems=problems)
        if problems:
            for p in problems:
                print(f"FLEET CRASHLOOP FAIL: {p}", file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "kills": kills_done,
                          "requests": total, "acked": acked["count"],
                          "bitwise_equal": True,
                          "failovers": stats["failovers"],
                          "healthy": stats["healthy"],
                          "epochs": stats["epochs"],
                          "ledger": a.out}))
        return 0
    finally:
        if fleet is not None:
            fleet.close()
        telemetry.activate(prev)
        led.close()


if __name__ == "__main__":
    sys.exit(main())
