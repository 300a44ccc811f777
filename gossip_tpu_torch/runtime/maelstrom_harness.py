"""Mini-Maelstrom: spawn N protocol-node processes and route their traffic.

The reference was tested exclusively by the external Maelstrom harness — N
OS processes on one machine, all networking simulated by a router over
stdin/stdout pipes, with injected latency and partitions (SURVEY.md §4,
"the same trick the TPU framework should replay as a parity fixture").
This module IS that fixture: a small asyncio router speaking the Maelstrom
envelope protocol as client ``c1``, driving
:mod:`gossip_tpu_torch.runtime.maelstrom_node` processes (or any binary speaking
the protocol) for black-box conformance tests.

No torch imports — pure stdlib.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class MaelstromHarness:
    """Router + client for N Maelstrom protocol nodes.

    Usage::

        h = MaelstromHarness(5, latency=0.005)
        await h.start()
        await h.set_topology({"n0": ["n1"], ...})
        await h.broadcast("n0", 42)
        await h.quiesce()
        assert 42 in await h.read("n3")
        await h.stop()
    """

    CLIENT = "c1"

    def __init__(self, n: int, latency: float = 0.002,
                 argv: Optional[List[str]] = None):
        self.n = n
        self.latency = latency
        self.argv = argv or [sys.executable, "-u", "-m",
                             "gossip_tpu_torch.runtime.maelstrom_node"]
        self.ids = [f"n{i}" for i in range(n)]
        self.procs: Dict[str, asyncio.subprocess.Process] = {}
        self._pump_tasks: List[asyncio.Task] = []
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_msg_id = 1000
        self._partitions: List[Tuple[str, str, float, float]] = []
        self._loop_t0 = 0.0
        self.routed = 0              # inter-node messages routed
        self._last_activity = 0.0
        self.op_latencies: List[float] = []   # client RPC round trips (s)
        self.broadcast_ops = 0
        self.client_ops = 0          # all workload-generator ops

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        loop = asyncio.get_running_loop()
        self._loop_t0 = loop.time()
        for nid in self.ids:
            proc = await asyncio.create_subprocess_exec(
                *self.argv,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
                limit=16 * 1024 * 1024,   # read_ok lines grow with the log
                env=env)
            self.procs[nid] = proc
            self._pump_tasks.append(asyncio.ensure_future(
                self._pump(nid, proc)))
            self._pump_tasks.append(asyncio.ensure_future(
                self._drain_stderr(nid, proc)))
        await asyncio.gather(*[
            self._client_rpc(nid, {"type": "init", "node_id": nid,
                                   "node_ids": list(self.ids)})
            for nid in self.ids])

    async def stop(self) -> None:
        for proc in self.procs.values():
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        await asyncio.gather(*[p.wait() for p in self.procs.values()],
                             return_exceptions=True)
        # pumps return on EOF once the processes are gone; awaiting them
        # (rather than cancelling mid-read) lets the pipe transports close
        # inside the running loop, not in __del__ after it's gone
        await asyncio.gather(*self._pump_tasks, return_exceptions=True)
        for proc in self.procs.values():
            if proc.stdin:
                proc.stdin.close()

    # -- network simulation ----------------------------------------------

    def _now(self) -> float:
        return asyncio.get_running_loop().time() - self._loop_t0

    def partition(self, a: str, b: str, duration: float,
                  start: Optional[float] = None) -> None:
        """Block the (a, b) link both ways for ``duration`` from now (or
        from ``start``, in harness time)."""
        t0 = self._now() if start is None else start
        self._partitions.append((a, b, t0, t0 + duration))

    def _link_open(self, a: str, b: str) -> bool:
        t = self._now()
        for (x, y, t0, t1) in self._partitions:
            if {a, b} == {x, y} and t0 <= t < t1:
                return False
        return True

    def _write_to(self, nid: str, envelope: dict) -> None:
        proc = self.procs.get(nid)
        if proc is None or proc.stdin is None or proc.stdin.is_closing():
            return
        proc.stdin.write((json.dumps(envelope) + "\n").encode())

    async def _deliver_later(self, nid: str, envelope: dict) -> None:
        if self.latency > 0:
            await asyncio.sleep(self.latency)
        self._write_to(nid, envelope)

    async def _pump(self, nid: str, proc) -> None:
        """Route node ``nid``'s stdout: replies to the client resolve RPC
        futures; node-to-node traffic is delivered with latency unless the
        link is partitioned (messages in a cut are dropped, Maelstrom
        style — the nodes' retries provide at-least-once)."""
        try:
            while True:
                raw = await proc.stdout.readline()
                if not raw:
                    return
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                dest = msg.get("dest")
                self._last_activity = self._now()
                if dest == self.CLIENT:
                    irt = msg.get("body", {}).get("in_reply_to")
                    fut = self._pending.pop(irt, None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
                    continue
                if dest in self.procs and self._link_open(msg.get("src"),
                                                          dest):
                    self.routed += 1
                    asyncio.ensure_future(self._deliver_later(dest, msg))
        except Exception as e:   # a dead pump black-holes the node: say so
            print(f"[harness] pump for {nid} died: {e!r}", file=sys.stderr)
            raise

    async def _drain_stderr(self, nid: str, proc) -> None:
        while True:
            raw = await proc.stderr.readline()
            if not raw:
                return
            print(f"[{nid} stderr] {raw.decode().rstrip()}", file=sys.stderr)

    # -- client ops (what the Maelstrom workload generator sends) ---------

    async def _client_rpc(self, dest: str, body: dict,
                          timeout: float = 15.0) -> dict:
        body = dict(body)
        self._next_msg_id += 1
        mid = body["msg_id"] = self._next_msg_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        try:
            self._write_to(dest,
                           {"src": self.CLIENT, "dest": dest, "body": body})
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(mid, None)

    async def set_topology(self, topo: Dict[str, List[str]]) -> None:
        replies = await asyncio.gather(*[
            self._client_rpc(nid, {"type": "topology", "topology": topo})
            for nid in self.ids])
        assert all(r["body"]["type"] == "topology_ok" for r in replies)

    async def _timed_op(self, node: str, body: dict) -> dict:
        """One workload-generator op: latency-recorded, op-counted —
        the shared accounting of every workload's write path, so
        ``stats()`` means the same thing for all of them."""
        t0 = self._now()
        r = await self._client_rpc(node, body)
        self.op_latencies.append(self._now() - t0)
        self.client_ops += 1
        return r

    async def broadcast(self, node: str, value: int) -> dict:
        r = await self._timed_op(node, {"type": "broadcast",
                                        "message": value})
        self.broadcast_ops += 1
        return r

    async def add(self, node: str, delta: int) -> dict:
        """Counter-workload ``add`` op (Gossip Glomers challenge #4);
        the caller checks the reply type — only an ``add_ok`` counts
        toward the acked-sum invariant."""
        return await self._timed_op(node, {"type": "add",
                                           "delta": delta})

    async def read(self, node: str) -> List[int]:
        r = await self._client_rpc(node, {"type": "read"})
        assert r["body"]["type"] == "read_ok"
        return r["body"]["messages"]

    async def read_counter(self, node: str) -> int:
        r = await self._client_rpc(node, {"type": "read"})
        assert r["body"]["type"] == "read_ok"
        return int(r["body"]["value"])

    async def kafka_send(self, node: str, key: str, msg: int) -> dict:
        """Kafka-workload ``send`` op; the caller checks for
        ``send_ok`` (only acked sends join the exactly-once-in-order
        invariant) and reads the assigned ``offset`` off the reply."""
        return await self._timed_op(node, {"type": "send", "key": key,
                                           "msg": msg})

    async def kafka_poll(self, node: str, offsets: dict) -> dict:
        """``poll`` from the given per-key offsets ->
        ``{key: [[offset, msg], ...]}``."""
        r = await self._client_rpc(node, {"type": "poll",
                                          "offsets": offsets})
        assert r["body"]["type"] == "poll_ok"
        return r["body"]["msgs"]

    async def kafka_commit(self, node: str, offsets: dict) -> dict:
        """``commit_offsets`` op (op-counted like every write)."""
        return await self._timed_op(node, {"type": "commit_offsets",
                                           "offsets": offsets})

    async def kafka_list_committed(self, node: str, keys: list) -> dict:
        r = await self._client_rpc(node, {
            "type": "list_committed_offsets", "keys": keys})
        assert r["body"]["type"] == "list_committed_offsets_ok"
        return r["body"]["offsets"]

    async def txn(self, node: str, ops: list) -> dict:
        """txn-rw-register workload ``txn`` op (op-counted like every
        write-bearing op); the caller inspects the reply — ``txn_ok``
        commits, an error reply is a definite abort (the TxnServer
        validates before applying anything)."""
        return await self._timed_op(node, {"type": "txn", "txn": ops})

    async def send_raw(self, dest: str, body: dict, timeout: float = 15.0
                       ) -> dict:
        """Arbitrary client RPC (conformance probes, e.g. unknown types)."""
        return await self._client_rpc(dest, body, timeout)

    async def quiesce(self, idle: float = 0.3, timeout: float = 30.0) -> None:
        """Wait until no message has moved for ``idle`` seconds."""
        deadline = self._now() + timeout
        while self._now() < deadline:
            if self._now() - self._last_activity >= idle:
                return
            await asyncio.sleep(idle / 4)
        raise TimeoutError("cluster did not quiesce")


    def stats(self) -> dict:
        """Maelstrom-checker-style workload stats (SURVEY.md §4: the real
        harness reports messages-per-op and op latencies externally).
        ``ops``/``msgs_per_op`` count every workload-generator op (the
        counter workload's adds included); ``broadcast_ops`` stays the
        broadcast-specific count for the batching artifacts."""
        lats = sorted(self.op_latencies)

        def pct(p):
            return lats[min(len(lats) - 1, int(p * len(lats)))] if lats else 0.0
        return {
            "nodes": self.n,
            "ops": self.client_ops,
            "broadcast_ops": self.broadcast_ops,
            "msgs_routed": self.routed,
            "msgs_per_op": (self.routed / self.client_ops
                            if self.client_ops else 0.0),
            "op_latency_ms": {
                "mean": 1e3 * sum(lats) / len(lats) if lats else 0.0,
                "p50": 1e3 * pct(0.50), "p99": 1e3 * pct(0.99),
                "max": 1e3 * (lats[-1] if lats else 0.0)},
            "link_latency_ms": 1e3 * self.latency,
        }


async def _start_workload(n: int, ops: int, rate: float, latency: float,
                          topology: str, partition_mid: bool,
                          argv: Optional[List[str]]) -> MaelstromHarness:
    """The spawn/topology/partition scaffolding EVERY workload runner
    shares — one definition, so :func:`run_broadcast_workload` and
    :func:`run_counter_workload` cannot drift on how a cluster is
    brought up or how the fault-tolerance variant cuts it."""
    h = MaelstromHarness(n, latency=latency, argv=argv)
    await h.start()
    try:
        topo = (line_topology(h.ids) if topology == "line"
                else grid_topology(h.ids, max(1, int(n ** 0.5))))
        await h.set_topology(topo)
        if partition_mid and n >= 2:
            # cut a REAL edge near the middle of the cluster —
            # consecutive ids are only adjacent in the line topology;
            # on a grid an arbitrary pair is usually not an edge and
            # the cut would drop nothing while still reporting
            # partitioned=true (both built families give every middle
            # node a neighbor at n >= 2)
            a = h.ids[n // 2]
            b = topo[a][0]
            # cut the middle third of the send window, anchored NOW
            # (the send loop starts now) — anchoring at loop start
            # would let process-spawn/init time expire the window
            # before the first broadcast and make the fault variant
            # vacuous
            span = ops / rate
            h.partition(a, b, duration=span / 3,
                        start=h._now() + span / 3)
    except BaseException:
        # the callers' try/finally h.stop() only guards AFTER this
        # returns: a topology failure here (a node that crashed on
        # spawn, a never-answered topology_ok) must not strand n
        # stdin-blocked node processes
        await h.stop()
        raise
    return h


async def _finish_workload(h: MaelstromHarness, check,
                           poll_deadline: float = 30.0) -> dict:
    """The quiesce + eventual-invariant polling every workload runner
    shares: quiesce (reported, never fatal — a retry loop can look
    idle mid-backoff), then poll ``check()`` (an async predicate) until
    it holds or the deadline passes.  Returns the stats dict with
    ``invariant_ok`` / ``quiesce_timeout`` filled."""
    timed_out = False
    try:
        await h.quiesce(timeout=60.0)
    except TimeoutError:
        timed_out = True           # report, don't crash: reads still run
    deadline = h._now() + poll_deadline
    while True:
        ok = await check()
        if ok or h._now() > deadline:
            break
        await asyncio.sleep(0.5)
    out = h.stats()
    out["invariant_ok"] = ok
    out["quiesce_timeout"] = timed_out
    return out


async def run_broadcast_workload(n: int, ops: int, rate: float = 50.0,
                                 latency: float = 0.002,
                                 topology: str = "line",
                                 partition_mid: bool = False,
                                 seed: int = 0,
                                 argv: Optional[List[str]] = None) -> dict:
    """The Maelstrom ``broadcast`` workload as a callable: spawn ``n``
    protocol nodes, send ``ops`` broadcasts at ``rate`` ops/s to random
    nodes, optionally cut a mid-cluster link for the middle third of the
    run (the fault-tolerance variant), quiesce, then check the checker's
    invariant — EVERY value appears in EVERY node's read (SURVEY.md §4).
    Returns the stats dict (+ ``invariant_ok``, ``values``)."""
    import random
    rng = random.Random(seed)
    h = await _start_workload(n, ops, rate, latency, topology,
                              partition_mid, argv)
    try:
        for v in range(ops):
            await h.broadcast(rng.choice(h.ids), v)
            await asyncio.sleep(1.0 / rate)
        # The checker invariant is EVENTUAL delivery: a quiesce can look
        # idle while a node's partition-dropped push sits in its ~2 s
        # RPC-timeout retry loop, so poll the reads until every value is
        # everywhere or the deadline passes (nodes retry with capped
        # backoff — runtime/maelstrom_node.py).
        want = set(range(ops))

        async def check():
            reads = await asyncio.gather(*[h.read(nid)
                                           for nid in h.ids])
            return all(want <= set(r) for r in reads)

        out = await _finish_workload(h, check)
        out["values"] = ops
        out["partitioned"] = bool(partition_mid)
        return out
    finally:
        await h.stop()


async def run_counter_workload(n: int, ops: int, rate: float = 50.0,
                               latency: float = 0.002,
                               topology: str = "line",
                               partition_mid: bool = False,
                               seed: int = 0,
                               max_delta: int = 10,
                               argv: Optional[List[str]] = None) -> dict:
    """The Gossip Glomers ``g-counter`` workload: spawn ``n`` counter
    nodes (runtime/maelstrom_node.CounterServer — per-node CRDT shards,
    merge = per-key max), send ``ops`` random-delta ``add`` ops at
    ``rate`` ops/s to random nodes, optionally cut a mid-cluster link
    mid-run, quiesce, then check the checker's invariant: the final
    ``read`` on EVERY node equals the **sum of acked adds** — exact
    integer equality, through the partition.  Returns the stats dict
    (+ ``invariant_ok``, ``expected``, ``final_values``)."""
    import random
    rng = random.Random(seed)
    if argv is None:
        argv = [sys.executable, "-u", "-m",
                "gossip_tpu_torch.runtime.maelstrom_node",
                "--workload", "counter"]
    h = await _start_workload(n, ops, rate, latency, topology,
                              partition_mid, argv)
    try:
        acked_sum = 0
        for _ in range(ops):
            delta = rng.randint(1, max_delta)
            r = await h.add(rng.choice(h.ids), delta)
            if r["body"]["type"] == "add_ok":   # only acked adds count
                acked_sum += delta
            await asyncio.sleep(1.0 / rate)

        finals: List[int] = []

        async def check():
            finals[:] = await asyncio.gather(*[h.read_counter(nid)
                                               for nid in h.ids])
            return all(v == acked_sum for v in finals)

        out = await _finish_workload(h, check)
        out["expected"] = acked_sum
        out["final_values"] = list(finals)
        out["partitioned"] = bool(partition_mid)
        return out
    finally:
        await h.stop()


async def run_kafka_workload(n: int, ops: int, rate: float = 50.0,
                             latency: float = 0.002,
                             topology: str = "line",
                             partition_mid: bool = False,
                             seed: int = 0, keys: int = 3,
                             argv: Optional[List[str]] = None) -> dict:
    """The Gossip Glomers ``kafka`` (replicated log) workload: spawn
    ``n`` kafka nodes (runtime/maelstrom_node.KafkaServer), send
    ``ops`` unique-value ``send`` ops at ``rate`` ops/s to random
    nodes over ``keys`` keys, interleave polls and commits, optionally
    cut a mid-cluster link mid-run, then check the three kafka
    invariants (SURVEY.md §4 checker style):

      1. **exactly-once in offset order** — every ACKED send appears
         in every node's final ``poll(key, 0)`` at exactly its acked
         offset, no send (acked or not) appears twice, and offsets
         are consecutive.  A send whose client RPC timed out or drew
         an error reply is **indeterminate** (the Maelstrom
         info-timeout convention: the owner may have applied a
         forwarded send whose ack was lost) — it MAY appear, but
         still at most once (the owner dedups retried forwards by
         value);
      2. **monotone committed offsets** — every
         ``list_committed_offsets`` sample taken during the run
         (including across the partition) never regresses per
         (node, key), and the final committed map agrees on every
         node;
      3. **gapless polls** — every poll reply's offsets are
         consecutive from the requested offset (checked on every
         in-run poll, not just the final ones).

    In-run probes that time out across the partition are skipped,
    never crashed on (the client timeout is a harness budget, not a
    verdict).  Returns the stats dict (+ ``invariant_ok``,
    ``monotone_ok``, ``gapless_ok``, ``acked``, ``indeterminate``,
    ``partitioned``)."""
    import random
    rng = random.Random(seed)
    if argv is None:
        argv = [sys.executable, "-u", "-m",
                "gossip_tpu_torch.runtime.maelstrom_node",
                "--workload", "kafka"]
    h = await _start_workload(n, ops, rate, latency, topology,
                              partition_mid, argv)
    try:
        key_names = [str(k) for k in range(keys)]
        acked: Dict[str, Dict[int, int]] = {k: {} for k in key_names}
        # client-timeout / error-reply sends: the owner MAY have
        # applied a forwarded send whose ack was lost (at-least-once),
        # so these values may legitimately appear in polls — but never
        # twice (docstring invariant 1)
        indeterminate: Dict[str, set] = {k: set() for k in key_names}
        committed_seen: Dict[Tuple[str, str], int] = {}
        monotone_ok = True
        gapless_ok = True
        exactly_once_ok = True

        def check_gapless(polled: dict, offsets: dict) -> bool:
            return all(
                [int(o) for o, _ in lst]
                == list(range(int(offsets[k]),
                              int(offsets[k]) + len(lst)))
                for k, lst in polled.items())

        async def sample_committed(node: str) -> None:
            nonlocal monotone_ok
            got = await h.kafka_list_committed(node, key_names)
            for k, off in got.items():
                prev = committed_seen.get((node, k))
                if prev is not None and int(off) < prev:
                    monotone_ok = False
                committed_seen[(node, k)] = int(off)

        for i in range(ops):
            key = rng.choice(key_names)
            try:
                r = await h.kafka_send(rng.choice(h.ids), key, i)
            except asyncio.TimeoutError:
                # a long partition can outlast the client RPC budget
                # while the node's forward retries keep going — the
                # send is indeterminate, never a harness crash
                indeterminate[key].add(i)
            else:
                if r["body"]["type"] == "send_ok":
                    off = int(r["body"]["offset"])
                    if off in acked[key]:        # duplicate offset ack
                        exactly_once_ok = False
                    acked[key][off] = i
                else:                            # error reply: the
                    indeterminate[key].add(i)    # forward may have
                                                 # landed at the owner
            try:
                if i % 3 == 2:                   # in-run gapless probe
                    node = rng.choice(h.ids)
                    offsets = {k: 0 for k in key_names}
                    polled = await h.kafka_poll(node, offsets)
                    if not check_gapless(polled, offsets):
                        gapless_ok = False
                if i % 4 == 3 and acked[key]:    # commit what we saw
                    await h.kafka_commit(rng.choice(h.ids),
                                         {key: max(acked[key])})
                if i % 5 == 4:                   # monotonicity probe
                    await sample_committed(rng.choice(h.ids))
            except asyncio.TimeoutError:
                pass       # probe across the cut: skip, retry later
            await asyncio.sleep(1.0 / rate)

        want_committed = {k: max((off for (nd, kk), off
                                  in committed_seen.items() if kk == k),
                                 default=None) for k in key_names}

        def key_log_ok(k: str, lst) -> bool:
            """Invariant 1 on one node's full poll of key ``k``: every
            acked send at exactly its acked offset, every other entry
            a known indeterminate value, nothing twice."""
            got = {int(o): m for o, m in lst}
            msgs = [m for _, m in lst]
            if len(set(msgs)) != len(msgs):      # a value twice: the
                return False                     # owner dedup failed
            if any(got.get(o) != m for o, m in acked[k].items()):
                return False
            return all(m in indeterminate[k] for o, m in got.items()
                       if acked[k].get(o) != m)

        async def check() -> bool:
            nonlocal gapless_ok
            try:
                for nid in h.ids:
                    polled = await h.kafka_poll(
                        nid, {k: 0 for k in key_names})
                    if not check_gapless(polled,
                                         {k: 0 for k in key_names}):
                        gapless_ok = False
                        return False
                    if not all(key_log_ok(k, polled.get(k, []))
                               for k in key_names):
                        return False
                    await sample_committed(nid)  # monotone across polls
                    listed = await h.kafka_list_committed(nid, key_names)
                    for k, want in want_committed.items():
                        if want is not None \
                                and int(listed.get(k, -1)) < want:
                            return False
            except asyncio.TimeoutError:
                return False                     # still healing: poll
            return True                          # again until deadline

        out = await _finish_workload(h, check)
        out["invariant_ok"] = bool(out["invariant_ok"]
                                   and exactly_once_ok and monotone_ok
                                   and gapless_ok)
        out["monotone_ok"] = monotone_ok
        out["gapless_ok"] = gapless_ok
        out["acked"] = {k: len(v) for k, v in acked.items()}
        out["indeterminate"] = {k: len(v) for k, v
                                in indeterminate.items()}
        out["committed"] = {k: v for k, v in want_committed.items()
                            if v is not None}
        out["partitioned"] = bool(partition_mid)
        return out
    finally:
        await h.stop()


async def run_txn_workload(n: int, ops: int, rate: float = 50.0,
                           latency: float = 0.002,
                           topology: str = "line",
                           partition_mid: bool = False,
                           seed: int = 0, keys: int = 4,
                           argv: Optional[List[str]] = None) -> dict:
    """The Maelstrom ``txn-rw-register`` workload: spawn ``n`` txn
    nodes (runtime/maelstrom_node.TxnServer — LWW registers, Lamport-
    pair timestamps), run ``ops`` random multi-key read/write
    transactions at ``rate`` ops/s against random nodes (1-3 micro-ops
    each, UNIQUE write values — the attribution contract), optionally
    cut a mid-cluster link mid-run, then hand the trace to the
    weak-isolation checker (runtime/txn_checker.check_txn_trace):

      * **G0 (dirty write)** — no cycle in the per-key LWW version
        orders across transactions;
      * **G1a (aborted read)** — no committed read observes an
        aborted transaction's write (error replies are definite
        aborts: the TxnServer validates before applying);
      * **convergence** — after heal, every node's final read-all
        transaction returns the SAME state, and each key's final
        value is its max-timestamp write's (total availability is
        only meaningful if the replicas agree eventually).

    A transaction whose client RPC times out across the partition is
    INDETERMINATE (the Maelstrom info-timeout convention): its writes
    may appear — they are never G1a evidence — and the harness never
    crashes on it.  Returns the stats dict (+ ``invariant_ok``,
    ``anomalies`` with the checker verdict, ``partitioned``)."""
    import random
    rng = random.Random(seed)
    if argv is None:
        argv = [sys.executable, "-u", "-m",
                "gossip_tpu_torch.runtime.maelstrom_node",
                "--workload", "txn"]
    h = await _start_workload(n, ops, rate, latency, topology,
                              partition_mid, argv)
    try:
        key_names = [str(k) for k in range(keys)]
        trace: List[dict] = []
        next_value = [1]          # unique write values, monotone

        def gen_ops():
            out = []
            for _ in range(rng.randint(1, 3)):
                k = rng.choice(key_names)
                if rng.random() < 0.5:
                    out.append(["r", k, None])
                else:
                    out.append(["w", k, next_value[0]])
                    next_value[0] += 1
            return out

        for i in range(ops):
            requested = gen_ops()
            rec = {"id": i, "node": rng.choice(h.ids),
                   "reads": [], "writes": []}
            try:
                r = await h.txn(rec["node"], requested)
            except asyncio.TimeoutError:
                # a long partition can outlast the client RPC budget
                # while the node would still answer after heal — the
                # txn is indeterminate, never a harness crash; its
                # writes (values are in `requested`) may appear later
                rec["status"] = "indeterminate"
                rec["writes"] = [{"key": k, "value": v,
                                  "ts": None}
                                 for f, k, v in requested if f == "w"]
            else:
                body = r["body"]
                if body.get("type") == "txn_ok":
                    rec["status"] = "committed"
                    ts = body.get("ts")
                    for f, k, v in body.get("txn", []):
                        if f == "r":
                            rec["reads"].append([k, v])
                        else:
                            rec["writes"].append(
                                {"key": k, "value": v, "ts": ts})
                else:
                    # definite abort: the node validated and refused
                    # BEFORE applying anything (TxnServer contract)
                    rec["status"] = "aborted"
                    rec["writes"] = [{"key": k, "value": v,
                                      "ts": None}
                                     for f, k, v in requested
                                     if f == "w"]
            trace.append(rec)
            await asyncio.sleep(1.0 / rate)

        final_reads: Dict[str, dict] = {}
        read_all = [["r", k, None] for k in key_names]

        async def check() -> bool:
            try:
                for nid in h.ids:
                    r = await h.txn(nid, list(read_all))
                    if r["body"].get("type") != "txn_ok":
                        return False
                    final_reads[nid] = {k: v for _, k, v
                                        in r["body"]["txn"]}
            except asyncio.TimeoutError:
                return False                 # still healing: poll
            states = list(final_reads.values())
            return (len(states) == n
                    and all(s == states[0] for s in states[1:]))

        out = await _finish_workload(h, check)
        # the RAW trace goes to the checker, aborted writes included:
        # G1a detection is only real if an aborted transaction's
        # writes stay attributable (the checker itself skips ts-less
        # writes where no version order exists — review finding)
        from gossip_tpu_torch.runtime.txn_checker import check_txn_trace
        verdict = check_txn_trace(trace, final_reads=final_reads)
        out["invariant_ok"] = bool(out["invariant_ok"]
                                   and verdict["ok"])
        out["anomalies"] = {"g0": len(verdict["g0"]),
                            "g1a": len(verdict["g1a"]),
                            "g1b": len(verdict["g1b"]),
                            "g1c": len(verdict["g1c"]),
                            "lost_update": len(verdict["lost_update"]),
                            "defects": len(verdict["defects"])}
        out["g0_ok"] = not verdict["g0"]
        out["g1a_ok"] = not verdict["g1a"]
        out["converged"] = verdict.get("converged", False)
        out["committed"] = verdict["committed"]
        out["aborted"] = verdict["aborted"]
        out["indeterminate"] = verdict["indeterminate"]
        out["partitioned"] = bool(partition_mid)
        return out
    finally:
        await h.stop()


def line_topology(ids: List[str]) -> Dict[str, List[str]]:
    topo = {}
    for i, nid in enumerate(ids):
        nbrs = []
        if i > 0:
            nbrs.append(ids[i - 1])
        if i < len(ids) - 1:
            nbrs.append(ids[i + 1])
        topo[nid] = nbrs
    return topo


def grid_topology(ids: List[str], cols: int) -> Dict[str, List[str]]:
    topo = {nid: [] for nid in ids}
    rows = (len(ids) + cols - 1) // cols
    for i, nid in enumerate(ids):
        r, c = divmod(i, cols)
        for (rr, cc) in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            j = rr * cols + cc
            if 0 <= rr < rows and 0 <= cc < cols and j < len(ids):
                topo[nid].append(ids[j])
    return topo
