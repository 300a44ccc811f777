"""Cross-ledger request-trace join: per-request waterfalls and p99
exemplars from the run ledgers of a traced serving run.

The port's copy of the repository's ``tools/trace_report.py`` (which
imports neither package; this one reads the ledgers through
:mod:`gossip_tpu_torch.utils.telemetry`).  A traced request leaves two
``request_trace`` halves, the router's (``source="router"``:
``proxy_ms``, ``retries``, ``deadline_consumed``) and the serving
replica's (``source="replica"``: ``queue_wait_ms``, ``batch_run_ms``),
plus ``dispatch_attempt``, ``trace_admit`` and ``failover`` events, all
carrying the one ``trace_id`` the client minted
(:data:`gossip_tpu_torch.rpc.sidecar.TRACE_KEY`); a megabatch's
``batch`` event lists its members' ids.  The port's router, batcher and
sidecar write these events with the reference's names and fields
(:mod:`gossip_tpu_torch.rpc`), so this join is the reference's, field
for field.  The halves land in different writers' ledgers (the router's
process, each replica's) unless a run points them at one file, so the
join reads any number of ledgers and ignores run ids: a trace crosses
processes, a run does not::

    python -m gossip_tpu_torch.tools.trace_report LEDGER.jsonl [MORE ...]
    python -m gossip_tpu_torch.tools.trace_report ... --json
    python -m gossip_tpu_torch.tools.trace_report ... --trace TID

The exemplar table is the decomposition of a tail latency: the actual
slowest traces, each attributed to its dominant leg (queue wait, batch
run, or routing and failover overhead).  The load harness
(:mod:`gossip_tpu_torch.tools.load_harness`) runs it after its legs.
"""

import argparse
import json
import sys

from gossip_tpu_torch.utils import telemetry


def load_events(paths):
    """Every event from every ledger, in path-then-file order — no run
    filter: the join key is trace_id, and one trace's events span the
    router's run, each replica's run, and the capture parent's run."""
    events = []
    for p in paths:
        events.extend(telemetry.load_ledger(p))
    return events


def join_traces(events):
    """{trace_id: joined record} over every trace-bearing event (the
    request_trace halves, the attempt/admit/failover spans, and the
    megabatch ``batch`` events' member links)."""
    traces = {}

    def rec(tid):
        return traces.setdefault(tid, {
            "trace_id": tid, "attempts": 0, "failovers": 0,
            "admits": 0, "client_retries": 0, "expired": False,
            "router": None, "replica_halves": [], "ticks": []})

    for e in events:
        ev = e.get("ev")
        if ev == "batch":
            for tid in e.get("trace_ids") or ():
                rec(tid)["ticks"].append(e.get("tick"))
            continue
        tid = e.get("trace_id")
        if tid is None:
            continue
        r = rec(tid)
        if ev == "dispatch_attempt":
            r["attempts"] += 1
        elif ev == "failover":
            r["failovers"] += 1
        elif ev == "trace_admit":
            r["admits"] += 1
        elif ev == "rpc_retry":
            r["client_retries"] += 1
        elif ev == "deadline_exceeded":
            r["expired"] = True
        elif ev == "request_trace":
            if e.get("source") == "router":
                r["router"] = e
            else:
                r["replica_halves"].append(e)
    return traces


def waterfall(joined):
    """One joined trace flattened to the per-request waterfall row.
    ``complete`` = both halves present.  A replayed
    request can leave one replica half per completed attempt; the LAST
    one is the half whose reply the client actually received (the
    failover replay runs after the dead replica's attempt)."""
    ro = joined["router"]
    rep = joined["replica_halves"][-1] if joined["replica_halves"] \
        else None
    row = {"trace_id": joined["trace_id"],
           "complete": ro is not None and rep is not None,
           "attempts": joined["attempts"],
           "failovers": joined["failovers"],
           "client_retries": joined["client_retries"],
           "expired": joined["expired"],
           "ticks": sorted(set(joined["ticks"]))}
    if ro is not None:
        row.update(method=ro.get("method"), replica=ro.get("replica"),
                   proxy_ms=ro.get("proxy_ms"),
                   retries=ro.get("retries"),
                   deadline_consumed=ro.get("deadline_consumed"))
    if rep is not None:
        row.update(req_kind=rep.get("req_kind"),
                   batched=rep.get("batched"),
                   queue_wait_ms=rep.get("queue_wait_ms"),
                   batch_run_ms=rep.get("batch_run_ms"),
                   cache=rep.get("cache"), tick=rep.get("tick"),
                   replica_halves=len(joined["replica_halves"]))
    if ro is not None and rep is not None:
        # routing overhead: what the proxy wall holds beyond the
        # replica's queue+run (network, failover retries, serialization)
        row["overhead_ms"] = round(
            (ro.get("proxy_ms") or 0.0)
            - (rep.get("queue_wait_ms") or 0.0)
            - (rep.get("batch_run_ms") or 0.0), 1)
    return row


def waterfalls(events):
    """Every joined trace as a waterfall row, slowest last."""
    rows = [waterfall(j) for j in join_traces(events).values()]
    rows.sort(key=_wall)
    return rows


def _wall(row):
    """One end-to-end wall per trace: the router's proxy view when
    present (what the client experienced), else the replica's
    queue+run (a replica-only ledger still ranks)."""
    if row.get("proxy_ms") is not None:
        return float(row["proxy_ms"])
    return float(row.get("queue_wait_ms") or 0.0) \
        + float(row.get("batch_run_ms") or 0.0)


def _dominant_leg(row):
    legs = {"queue_wait": row.get("queue_wait_ms") or 0.0,
            "batch_run": row.get("batch_run_ms") or 0.0,
            "routing_overhead": row.get("overhead_ms") or 0.0}
    if not any(legs.values()):
        return "unknown"
    return max(legs, key=lambda k: legs[k])


def exemplars(rows, k=5):
    """The p99 exemplar contract: the ACTUAL k slowest traces (not a
    percentile abstraction), each carrying its full waterfall and the
    leg that dominates it."""
    out = []
    for row in rows[-k:][::-1]:
        out.append({**row, "wall_ms": round(_wall(row), 1),
                    "dominant_leg": _dominant_leg(row)})
    return out


def summarize(rows):
    """Machine summary of one waterfall set (the --json document and
    the capture tools' assertion surface)."""
    pct = telemetry.percentile
    walls = [_wall(r) for r in rows]
    qw = [r["queue_wait_ms"] for r in rows
          if r.get("queue_wait_ms") is not None]
    br = [r["batch_run_ms"] for r in rows
          if r.get("batch_run_ms") is not None]
    return {
        "traces": len(rows),
        "complete": sum(1 for r in rows if r["complete"]),
        "incomplete": sum(1 for r in rows if not r["complete"]),
        "replayed": sum(1 for r in rows if (r.get("retries") or 0) > 0
                        or r["failovers"] > 0),
        "expired": sum(1 for r in rows if r["expired"]),
        "wall_ms": {"p50": round(pct(walls, 0.50), 1),
                    "p95": round(pct(walls, 0.95), 1),
                    "p99": round(pct(walls, 0.99), 1)},
        "queue_wait_ms": {"p50": round(pct(qw, 0.50), 1),
                          "p99": round(pct(qw, 0.99), 1)},
        "batch_run_ms": {"p50": round(pct(br, 0.50), 1),
                         "p99": round(pct(br, 0.99), 1)},
    }


def render_trace_section(events, k=5):
    """The "Request traces" markdown section for one event set, [] when
    it carries no traces."""
    rows = waterfalls(events)
    if not rows:
        return []
    s = summarize(rows)
    out = ["## Request traces (trace_id join, "
           "gossip_tpu_torch/tools/trace_report.py)", ""]
    out.append(f"- {s['traces']} trace(s): {s['complete']} complete "
               f"waterfall(s), {s['incomplete']} incomplete, "
               f"{s['replayed']} failover-replayed, "
               f"{s['expired']} expired")
    out.append(f"- end-to-end wall ms p50/p95/p99: "
               f"{s['wall_ms']['p50']} / {s['wall_ms']['p95']} / "
               f"{s['wall_ms']['p99']}; queue wait p50/p99: "
               f"{s['queue_wait_ms']['p50']} / "
               f"{s['queue_wait_ms']['p99']}; batch run p50/p99: "
               f"{s['batch_run_ms']['p50']} / "
               f"{s['batch_run_ms']['p99']}")
    out.append("")
    out.append("### p99 exemplars (the actual slowest traces, "
               "attributed)")
    out.append("")
    out.append("| trace_id | wall_ms | queue_wait | batch_run | "
               "overhead | retries | replica | dominant leg |")
    out.append("|---|---|---|---|---|---|---|---|")
    for x in exemplars(rows, k=k):
        out.append(
            f"| `{x['trace_id']}` | {x['wall_ms']} "
            f"| {x.get('queue_wait_ms', '-')} "
            f"| {x.get('batch_run_ms', '-')} "
            f"| {x.get('overhead_ms', '-')} "
            f"| {x.get('retries', x['failovers'])} "
            f"| {x.get('replica', '-')} | {x['dominant_leg']} |")
    out.append("")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ledgers", nargs="+",
                    help="one or more telemetry JSONL ledgers (router "
                         "+ replica files join across paths)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine summary (+ exemplars) as "
                         "one JSON document instead of markdown")
    ap.add_argument("--trace", default=None, metavar="TID",
                    help="print one trace's full waterfall + raw "
                         "events (the load_ledger trace_id= filter)")
    ap.add_argument("-k", "--exemplars", type=int, default=5,
                    help="exemplar count in the table (default 5)")
    ap.add_argument("-o", "--out", default=None,
                    help="write output here instead of stdout")
    args = ap.parse_args(argv)

    if args.trace is not None:
        evs = []
        for p in args.ledgers:
            evs.extend(telemetry.load_ledger(p, trace_id=args.trace))
        joined = join_traces(evs)
        if args.trace not in joined:
            print(f"no events for trace {args.trace!r}",
                  file=sys.stderr)
            return 1
        doc = json.dumps({"waterfall": waterfall(joined[args.trace]),
                          "events": evs}, indent=1)
    else:
        events = load_events(args.ledgers)
        rows = waterfalls(events)
        if not rows:
            print("no request_trace events in "
                  + ", ".join(args.ledgers), file=sys.stderr)
            return 1
        if args.json:
            doc = json.dumps({"summary": summarize(rows),
                              "exemplars": exemplars(
                                  rows, k=args.exemplars)})
        else:
            doc = "\n".join(render_trace_section(
                events, k=args.exemplars))
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    else:
        print(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
