"""``go-native`` backend: discrete-event simulator of the reference semantics.

This is the Backend seam's parity side (SURVEY.md §7 layer 5): a faithful
event-driven reimplementation of the reference node's behavior so the batched
TPU kernels can be validated against it curve-for-curve (BASELINE.json north
star: "convergence curves matching the Go reference at N=1024").

Semantics reproduced (SURVEY.md §2.2, reference main.go):

  1. **Ack-before-process** (main.go:109-118): ``broadcast_ok`` is sent
     before dedup/append/fan-out.
  2. **At-least-once + idempotent receipt** (main.go:80-87 + 113): unbounded
     retries; duplicates suppressed by the per-node dedup set.
  3. **Sender exclusion** (main.go:73-75): never relay back to the peer the
     message came from.
  4. **Sequential, blocking fan-out** (main.go:72-88): neighbor i+1's RPC
     starts only after neighbor i's ack returns.
  5. **Retry liveness hole** (main.go:77-87, defect §2.2.7): the 2 s context
     is created once per neighbor, *before* the retry loop; after it expires
     every retry's ``SyncRPC`` fails instantly, so the loop never exits and
     later neighbors are never contacted by this relayer.  Crucially the
     resends still go on the wire (the send precedes the ctx check), so a
     healed partition still eventually delivers — but only via growing
     backoff.  ``NetConfig.faithful_ctx_bug=False`` models the fixed node
     (fresh context per attempt, loop proceeds after success).

Not reproducible single-threaded (and deliberately absent): the dedup TOCTOU
race and the unsynchronized topology write (§2.2.5-6) — the batched kernels
make both structurally impossible, and so does this sequential event loop.

The "network" is the event queue itself: per-link one-way latency plus
partition windows, standing in for Maelstrom's external fault injection
(SURVEY.md §4).

**The parity clock** (SURVEY.md §7 "Event-driven vs. round-synchronous
parity", mapping documented here as required): the round-synchronous flood
kernel advances one BFS shell per round, so its coverage after round t is
exactly the BFS ball of radius t (tests/test_torch_gonative.py checks this against
an independent numpy BFS).  The event-driven node is *faster than its own hop
count*: transitive relays race ahead of the origin's sequential fan-out loop,
so a node's first receipt may travel a longer-hop path that was quicker in
wall-time.  Hence per-hop coverage satisfies an inequality, not equality:

    event_sim.coverage_by_hop(m, t)  <=  flood_kernel.coverage[t]  (= BFS)

with equality (a) in the limit (both converge to the same covered set — the
Maelstrom checker's actual invariant, SURVEY.md §4) and (b) exactly, per
round, on graphs where every node has at most one non-sender neighbor (paths,
k=2 rings), where no relay race exists.  ``hop_depths`` records the *minimum*
hop over all arrivals (duplicates included — a deduped arrival still arrived),
which is the tightest observable bound on BFS distance.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Network + protocol constants (reference values from BASELINE.md)."""

    latency: float = 0.001        # one-way message latency, seconds
    rpc_timeout: float = 2.0      # SyncRPC context (main.go:77)
    backoff_base: float = 0.1     # 100 ms * 2^k (main.go:85-86)
    faithful_ctx_bug: bool = True # reproduce defect §2.2.7 (True = as shipped)
    max_backoff_doublings: int = 40  # int-overflow guard the reference lacks


class GoNativeNode:
    """Per-node state: the MessageKeeper analog (main.go:22-58)."""

    __slots__ = ("id", "neighbors", "log", "seen")

    def __init__(self, node_id: int):
        self.id = node_id
        self.neighbors: List[int] = []
        self.log: List[int] = []       # append-only ordered log (read_ok)
        self.seen: set = set()         # dedup set (broadcasted map)


class GoNativeSim:
    """Event-driven cluster simulation.

    ``topology`` maps node id -> neighbor list (the reference's runtime
    ``topology`` message, main.go:132-149).  Client broadcasts are injected
    with :meth:`broadcast`; :meth:`run` drains the event queue to the horizon.
    """

    def __init__(self, topology: Dict[int, List[int]],
                 net: NetConfig = NetConfig(), horizon: float = 120.0):
        self.net = net
        self.horizon = horizon
        self.nodes: Dict[int, GoNativeNode] = {}
        for nid, nbrs in topology.items():
            node = GoNativeNode(nid)
            node.neighbors = list(nbrs)
            self.nodes[nid] = node
        self._q: List[Tuple[float, int, tuple]] = []
        self._seq = itertools.count()
        self._partitions: List[Tuple[int, int, float, float]] = []
        self.msgs_sent = 0          # every wire message (requests + acks)
        self.deliveries: List[Tuple[float, int, int, int]] = []
        # (time, node, message, hop) — first receipt only
        self._min_hop: Dict[Tuple[int, int], int] = {}  # (node, msg) -> hop
        self.now = 0.0

    # -- network ---------------------------------------------------------

    def partition(self, a: int, b: int, t0: float, t1: float) -> None:
        """Block the (a, b) link in both directions during [t0, t1)."""
        self._partitions.append((a, b, t0, t1))

    def _link_open(self, a: int, b: int, t: float) -> bool:
        for (x, y, t0, t1) in self._partitions:
            if {a, b} == {x, y} and t0 <= t < t1:
                return False
        return True

    def _push_event(self, t: float, ev: tuple) -> None:
        # Never drop: events beyond the current horizon stay queued so a
        # later run(until=...) can still process them (at-least-once holds
        # across resumed runs); run() bounds the clock, not the queue.
        heapq.heappush(self._q, (t, next(self._seq), ev))

    # -- protocol --------------------------------------------------------

    def broadcast(self, origin: int, message: int, t: float = 0.0) -> None:
        """Client injection: a Maelstrom client `broadcast` op landing at one
        node (main.go:102).  The client is not in the topology, so sender
        exclusion does not apply to it (§2.2.3)."""
        self._push_event(t, ("deliver", origin, -1, message, 0))

    def _deliver(self, t: float, dst: int, src: int, message: int,
                 hop: int) -> None:
        node = self.nodes[dst]
        self.msgs_sent += 1               # the broadcast request itself
        # 1. ack FIRST (main.go:109) — before dedup or fan-out.
        self.msgs_sent += 1               # broadcast_ok back to src/client
        k = (dst, message)
        if k not in self._min_hop or hop < self._min_hop[k]:
            self._min_hop[k] = hop
        # 2. dedup (main.go:113).
        if message in node.seen:
            return
        node.seen.add(message)
        node.log.append(message)          # append (main.go:117)
        self.deliveries.append((t, dst, message, hop))
        # 3. fan-out (main.go:118): sequential, excluding the sender.
        targets = [nb for nb in node.neighbors if nb != src]
        if targets:
            self._push_event(t, ("fanout", dst, message, hop, tuple(targets),
                                 0, 0, t))

    def _fanout(self, t: float, src: int, message: int, hop: int,
                targets: tuple, idx: int, attempt: int,
                ctx_start: float) -> None:
        """One retry-loop step of the sequential fan-out (main.go:72-88).

        ``idx`` is the neighbor being worked; ``attempt`` the retry count for
        it; ``ctx_start`` when its 2 s context was created (main.go:77)."""
        if idx >= len(targets):
            return
        nb = targets[idx]
        net = self.net
        deadline = ctx_start + net.rpc_timeout
        # SyncRPC sends unconditionally, then waits on the reply channel with
        # the (possibly already expired) context.
        if self._link_open(src, nb, t):
            self._push_event(t + net.latency,
                             ("deliver", nb, src, message, hop + 1))
            if t + 2 * net.latency <= deadline:
                # Reply arrives in time: this neighbor succeeds; move to the
                # next neighbor once the ack is back (blocking fan-out).
                self._push_event(t + 2 * net.latency,
                                 ("fanout", src, message, hop, targets,
                                  idx + 1, 0, t + 2 * net.latency))
                return
            # else: delivered, but SyncRPC still errors at the deadline.
        # Failure path: SyncRPC returns error — at the ctx deadline for the
        # first in-window attempt, instantly once the ctx is expired.
        fail_at = max(t, deadline)
        k = min(attempt, net.max_backoff_doublings)
        retry_at = fail_at + net.backoff_base * (2 ** k)
        if net.faithful_ctx_bug:
            # Defect §2.2.7: same dead context forever; the loop never exits
            # and later neighbors are never reached from this relayer — but
            # each retry still resends (the delivery above), so a healed link
            # eventually gets the message.
            self._push_event(retry_at, ("fanout", src, message, hop, targets,
                                        idx, attempt + 1, ctx_start))
        else:
            # Fixed node: fresh context per attempt; a post-heal attempt
            # succeeds and the fan-out proceeds.
            self._push_event(retry_at, ("fanout", src, message, hop, targets,
                                        idx, attempt + 1, retry_at))

    # -- driver ----------------------------------------------------------

    def run(self, until: Optional[float] = None) -> None:
        stop = self.horizon if until is None else until
        while self._q and self._q[0][0] <= stop:
            t, _, ev = heapq.heappop(self._q)
            self.now = t
            if ev[0] == "deliver":
                self._deliver(t, *ev[1:])
            else:
                self._fanout(t, *ev[1:])

    # -- observability (the reference had none — SURVEY.md §5) -----------

    def read(self, node: int) -> List[int]:
        """The `read` handler: ordered log snapshot (main.go:123-130)."""
        return list(self.nodes[node].log)

    def delivery_count(self) -> int:
        """First-receipt count (cheap on both engines — the native core's
        ``deliveries`` property marshals full arrays)."""
        return len(self.deliveries)

    def hop_depths(self, message: int) -> Dict[int, int]:
        """Min hop over all arrivals per node (>= BFS distance; == on
        race-free graphs — see the parity-clock note in the module doc)."""
        return {nid: hop for (nid, m), hop in self._min_hop.items()
                if m == message}

    def coverage_by_hop(self, message: int, max_hops: int) -> List[float]:
        """coverage[h] = fraction of nodes holding ``message`` within h hops.

        This is the hop-depth clock on which the round-synchronous flood
        kernel is exactly comparable: flood coverage after round t == the
        BFS ball of radius t (ops/propagate.flood_gather docstring)."""
        depths = self.hop_depths(message)
        n = len(self.nodes)
        return [sum(1 for d in depths.values() if d <= h) / n
                for h in range(max_hops + 1)]

    def coverage_at(self, message: int, t: float) -> float:
        """Wall-clock coverage (Maelstrom's stable-latency view)."""
        n = len(self.nodes)
        holders = {nid for (tt, nid, m, _) in self.deliveries
                   if m == message and tt <= t}
        return len(holders) / n


def topology_from_table(topo) -> Dict[int, List[int]]:
    """Convert a padded-table Topology into the dict form the event sim (and
    the reference's `topology` message, main.go:132-149) uses.  The table
    may be numpy arrays or the port's torch tensors, on any device."""
    import numpy as np

    def host(a):
        return np.asarray(a.cpu() if hasattr(a, "cpu") else a)
    nbrs = host(topo.nbrs)
    deg = host(topo.deg)
    return {i: nbrs[i, :deg[i]].tolist() for i in range(topo.n)}
