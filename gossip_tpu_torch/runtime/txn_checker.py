"""Weak-isolation anomaly checker for the txn-rw-register workload.

Maelstrom's ``txn-rw-register`` workload claims *total availability*:
every node answers every transaction, partitions included — which is
only an interesting claim if the isolation level it provides is
CHECKED, not asserted.  This module classifies the two anomaly classes
the read-uncommitted / read-committed boundary is defined by (Adya's
portable phenomena, the classes Jepsen's Elle checks first):

  * **G0 (dirty write)** — a cycle in the write-depends graph: for
    transactions T1, T2 (or a longer chain), T1's write to some key
    precedes T2's on that key while T2's write to another key precedes
    T1's.  Version order per key is the LWW timestamp order — the
    SAME total order the replicas converge by, so the checker judges
    the system against its own commit discipline.  The server stamps
    one timestamp per transaction (all its writes share it), which is
    exactly why a live run can never produce G0: cross-key version
    orders all collapse onto the one total timestamp order.  The
    checker does not assume that — it detects cycles over per-WRITE
    timestamps, so a planted violation on a synthetic trace is flagged
    (a checker that cannot fail is not a checker).
  * **G1a (aborted read / dirty read)** — a committed transaction
    read a value written by an ABORTED transaction.  The TxnServer
    validates a transaction's micro-op list BEFORE applying anything,
    so an error reply is a definite abort whose writes must never be
    visible; a client-side timeout is INDETERMINATE (the Maelstrom
    info-timeout convention — the txn may have applied with its ack
    lost) and its writes are legitimate reads, never G1a.
  * **G1b (intermediate read)** — a committed transaction read a
    value some OTHER transaction overwrote within itself: the writer
    wrote the same key again later in its own micro-op list, so only
    the final write is ever a committed version.  A transaction
    reading its own in-progress write is internal program order, not
    an isolation phenomenon — self-reads never flag.
  * **G1c (circular information flow)** — a cycle in ww ∪ wr that a
    read-depends edge closes (a ww-only cycle is already G0).  wr
    edges attribute each committed read to its unique writer; aborted
    writers are excluded — reading one is G1a, not information flow.
  * **lost update** — two COMMITTED transactions both read the same
    (key, pre-value) — ``None`` meaning the initial state — and both
    wrote that key: one update was computed from a version the
    other's write superseded.  REPORTED but excluded from ``ok``:
    the LWW register claims read-committed, not snapshot isolation,
    and losing concurrent updates across a partition is its
    documented merge semantics — the list is surfaced so captures
    can pin its presence or absence, never treated as a violation of
    a claim the system does not make.

Trace format (built by runtime/maelstrom_harness.run_txn_workload, or
synthesized by tests): a list of transaction records

    {"id": int, "node": str,
     "status": "committed" | "aborted" | "indeterminate",
     "reads":  [[key, value-or-None], ...],      # committed only
     "writes": [{"key": k, "value": v, "ts": [c, o]}, ...]}

``ts`` is the lexicographic (counter, owner-index) pair the server
assigned — compared as tuples.  Write values are UNIQUE per run (the
workload generator's contract, the one-add-tag convention), which is
what lets a read be attributed to exactly one writing transaction.

No torch imports — pure stdlib, shared by the harness, the CLI verdict
path, and the unit tests that plant anomalies.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["check_txn_trace", "ww_edges", "wr_edges"]


def _writer_index(txns) -> Tuple[Dict[object, dict], list]:
    """``(value -> writing txn record, duplicate values)`` — write
    values are unique by contract; a duplicate is reported as a trace
    defect, not silently folded."""
    by_value: Dict[object, dict] = {}
    dups = []
    for t in txns:
        for w in t.get("writes", ()):
            v = w["value"]
            if v in by_value:
                dups.append(v)
            by_value[v] = t
    return by_value, dups


def ww_edges(txns) -> List[Tuple[int, int, object]]:
    """The write-depends edges: ``(t1_id, t2_id, key)`` whenever both
    wrote ``key`` and t1's write timestamp precedes t2's.  Timestamps
    compare as tuples (lexicographic (counter, owner) — the LWW total
    order)."""
    per_key: Dict[object, List[Tuple[tuple, int]]] = {}
    for t in txns:
        if t.get("status") == "aborted":
            continue            # an aborted write installs no version
        for w in t.get("writes", ()):
            if w.get("ts") is None:
                continue        # indeterminate: no server timestamp,
            per_key.setdefault(w["key"], []).append(  # no version order
                (tuple(w["ts"]), t["id"]))
    edges = []
    for key, writes in per_key.items():
        writes.sort()
        for i, (ts1, id1) in enumerate(writes):
            for ts2, id2 in writes[i + 1:]:
                if id1 != id2:
                    edges.append((id1, id2, key))
    return edges


def _find_cycle(edges) -> Optional[List[int]]:
    """A cycle in the ww digraph as a txn-id list, or None — iterative
    DFS with color marking (the trace can be long; no recursion)."""
    adj: Dict[int, list] = {}
    for a, b, _ in edges:
        adj.setdefault(a, []).append(b)
    color: Dict[int, int] = {}          # 0/absent=white, 1=grey, 2=black
    parent: Dict[int, int] = {}
    for root in adj:
        if color.get(root):
            continue
        stack = [(root, iter(adj.get(root, ())))]
        color[root] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 0) == 0:
                    color[nxt] = 1
                    parent[nxt] = node
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    advanced = True
                    break
                if color.get(nxt) == 1:      # back edge: cycle
                    cyc = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        cyc.append(cur)
                    cyc.reverse()
                    return cyc
            if not advanced:
                color[node] = 2
                stack.pop()
    return None


def wr_edges(txns) -> List[Tuple[int, int, object]]:
    """The read-depends edges: ``(writer_id, reader_id, key)`` whenever
    a COMMITTED transaction read a value some other transaction wrote
    (unique write values attribute each read to exactly one writer).
    Aborted writers are excluded — a committed read of one is G1a, not
    information flow — and self-reads carry no cross-txn dependency."""
    by_value, _ = _writer_index(txns)
    edges = []
    for t in txns:
        if t.get("status") != "committed":
            continue
        for key, value in t.get("reads", ()):
            if value is None:
                continue
            w = by_value.get(value)
            if (w is None or w["id"] == t["id"]
                    or w.get("status") == "aborted"):
                continue
            edges.append((w["id"], t["id"], key))
    return edges


def _cycle_through(edges, start: int, nxt: int) -> Optional[List[int]]:
    """A closed walk ``[start, nxt, ..., start]`` that returns from
    ``nxt`` to ``start`` over ``edges``, or None — BFS, so the
    reported cycle is the shortest one the (start → nxt) edge closes."""
    adj: Dict[int, list] = {}
    for a, b, _ in edges:
        adj.setdefault(a, []).append(b)
    if nxt == start:
        return [start, start]
    parent: Dict[int, int] = {}
    seen = {nxt}
    q = deque([nxt])
    while q:
        cur = q.popleft()
        for m in adj.get(cur, ()):
            if m == start:
                back = [cur]
                while back[-1] != nxt:
                    back.append(parent[back[-1]])
                back.reverse()
                return [start] + back + [start]
            if m not in seen:
                seen.add(m)
                parent[m] = cur
                q.append(m)
    return None


def check_txn_trace(txns, final_reads: Optional[Dict] = None) -> dict:
    """Classify the trace; returns

    ``{"ok": bool, "g0": [...], "g1a": [...], "g1b": [...],
    "g1c": [...], "lost_update": [...], "defects": [...],
    "committed": int, "aborted": int, "indeterminate": int}``

    * ``g0``: each entry a dict with the offending txn-id cycle and
      the keys whose version orders close it;
    * ``g1a``: each entry ``{"reader": id, "key": k, "value": v,
      "writer": id}`` — a committed read of an aborted write;
    * ``g1b``: each entry adds ``"final"`` — a committed read of a
      write the writing transaction itself overwrote (intermediate
      state; self-reads never flag);
    * ``g1c``: a witness cycle in ww ∪ wr closed by a wr edge
      (``{"cycle": [...], "wr_edge": [w, r, key]}``);
    * ``lost_update``: ``{"key": k, "pre": v, "txns": [ids]}`` —
      committed read-modify-writes of the same version; REPORTED but
      excluded from ``ok`` (LWW read-committed loses concurrent
      updates by design — see module docstring);
    * ``defects``: trace-integrity problems that would make the
      verdict unsound (duplicate write values, same-key timestamp
      collisions) — reported separately so a broken harness can never
      masquerade as a clean isolation verdict.

    ``final_reads`` (optional): ``{node: {key: value}}`` final
    register states; checked for cross-node agreement and — when the
    winner is attributable — that each key's final value is the
    max-timestamp write's (the LWW convergence cross-check; verdict
    key ``converged``)."""
    txns = list(txns)
    by_value, dup_values = _writer_index(txns)
    defects = [f"duplicate write value {v!r} (unique-value contract)"
               for v in dup_values]

    # same-key timestamp collisions fork the LWW winner: a trace
    # carrying one cannot certify anything
    per_key_ts: Dict[tuple, int] = {}
    for t in txns:
        if t.get("status") == "aborted":
            continue
        for w in t.get("writes", ()):
            if w.get("ts") is None:
                continue                 # indeterminate: unordered
            sig = (w["key"], tuple(w["ts"]))
            if sig in per_key_ts and per_key_ts[sig] != t["id"]:
                defects.append(
                    f"timestamp collision on key {w['key']!r} at "
                    f"{w['ts']} (txns {per_key_ts[sig]} and "
                    f"{t['id']})")
            per_key_ts[sig] = t["id"]

    # -- G0: cycles in the write-depends graph -------------------------
    g0 = []
    edges = ww_edges(txns)
    cycle = _find_cycle(edges)
    if cycle is not None:
        pairs = set(zip(cycle, cycle[1:]))
        keys = sorted({str(k) for a, b, k in edges if (a, b) in pairs})
        g0.append({"cycle": cycle, "keys": keys})

    # -- G1a: committed reads of aborted writes ------------------------
    g1a = []
    for t in txns:
        if t.get("status") != "committed":
            continue
        for key, value in t.get("reads", ()):
            if value is None:
                continue
            writer = by_value.get(value)
            if writer is not None and writer.get("status") == "aborted":
                g1a.append({"reader": t["id"], "key": key,
                            "value": value, "writer": writer["id"]})

    # -- G1b: committed reads of intermediate writes -------------------
    # Only a transaction's LAST write to a key is ever a committed
    # version; a foreign read of an earlier one observed state that
    # never existed between transactions.  Self-reads are program
    # order (a txn reading its own in-progress write), never flagged.
    g1b = []
    for t in txns:
        if t.get("status") != "committed":
            continue
        for key, value in t.get("reads", ()):
            if value is None:
                continue
            writer = by_value.get(value)
            if (writer is None or writer["id"] == t["id"]
                    or writer.get("status") == "aborted"):
                continue        # unattributed, self, or already G1a
            same_key = [w["value"] for w in writer.get("writes", ())
                        if w["key"] == key]
            if value in same_key and same_key[-1] != value:
                g1b.append({"reader": t["id"], "writer": writer["id"],
                            "key": key, "value": value,
                            "final": same_key[-1]})

    # -- G1c: circular information flow --------------------------------
    # A cycle in ww ∪ wr that a read-depends edge closes; ww-only
    # cycles are already G0, so each candidate starts from a wr edge.
    g1c = []
    wr = wr_edges(txns)
    for a, b, key in wr:
        cyc = _cycle_through(edges + wr, a, b)
        if cyc is not None:
            g1c.append({"cycle": cyc, "wr_edge": [a, b, str(key)]})
            break               # one witness cycle, like G0

    # -- lost update: two committed read-modify-writes of one version --
    # Reported, not folded into ``ok`` (see module docstring): LWW
    # read-committed registers lose concurrent updates by design.
    lost_update = []
    rmw: Dict[Tuple[object, object], List[int]] = {}
    for t in txns:
        if t.get("status") != "committed":
            continue
        wrote = {w["key"] for w in t.get("writes", ())}
        for key, value in t.get("reads", ()):
            if key in wrote:
                rmw.setdefault((key, value), []).append(t["id"])
    for (key, pre), ids in sorted(rmw.items(),
                                  key=lambda kv: (str(kv[0][0]),
                                                  str(kv[0][1]))):
        ids = sorted(set(ids))
        if len(ids) >= 2:
            lost_update.append({"key": key, "pre": pre, "txns": ids})

    out = {"g0": g0, "g1a": g1a, "g1b": g1b, "g1c": g1c,
           "lost_update": lost_update, "defects": defects,
           "committed": sum(1 for t in txns
                            if t.get("status") == "committed"),
           "aborted": sum(1 for t in txns
                          if t.get("status") == "aborted"),
           "indeterminate": sum(1 for t in txns
                                if t.get("status") == "indeterminate")}

    if final_reads is not None:
        states = list(final_reads.values())
        agree = all(s == states[0] for s in states[1:])
        lww_ok = True
        if states:
            # expected winner per key: the max-ts committed write —
            # >= so a transaction's SECOND write to one key (same
            # txn timestamp, later program order) is the winner, the
            # TxnServer's apply rule
            best: Dict[object, Tuple[tuple, object]] = {}
            indet_vals: Dict[object, set] = {}
            for t in txns:
                if t.get("status") == "aborted":
                    continue
                for w in t.get("writes", ()):
                    if w.get("ts") is None:
                        # a timed-out txn's write MAY have applied
                        # with its ack lost (the info-timeout
                        # convention) — admissible as a final winner,
                        # never required
                        indet_vals.setdefault(w["key"], set()).add(
                            w["value"])
                        continue
                    ts = tuple(w["ts"])
                    cur = best.get(w["key"])
                    if cur is None or ts >= cur[0]:
                        best[w["key"]] = (ts, w["value"])
            for key, (_, value) in best.items():
                got = states[0].get(key, states[0].get(str(key)))
                if got != value and got not in indet_vals.get(key,
                                                              ()):
                    lww_ok = False
            # an ABORTED write visible in the final state is a failure
            # on ANY key — including one `best` never covers (no
            # committed write): a server that applied before its error
            # reply must not certify clean (review finding)
            aborted_vals = {w["value"] for t in txns
                            if t.get("status") == "aborted"
                            for w in t.get("writes", ())}
            for got in states[0].values():
                if got is not None and got in aborted_vals:
                    lww_ok = False
        out["converged"] = bool(agree and lww_ok)

    out["ok"] = (not (g0 or g1a or g1b or g1c or defects)
                 and out.get("converged", True))
    return out
