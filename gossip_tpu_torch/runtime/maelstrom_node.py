"""Maelstrom-protocol broadcast node: one OS process per cluster node.

A drop-in functional replacement for the reference Go binary under the
Maelstrom / Jepsen harness (fly.io "Gossip Glomers" broadcast workload):
newline-delimited JSON envelopes ``{"src","dest","body":{...}}`` on
stdin/stdout, stderr for logs (SURVEY.md §2.5's L0 contract, inferred from
the reference's call sites of the maelstrom demo/go library, reference
go.mod:5).

Implemented surface, matching the reference handler set (main.go:99-158):

  * built-in ``init`` handshake — record ``node_id``/``node_ids``, reply
    ``init_ok`` (the Go library does this invisibly; SURVEY.md §2.5);
  * ``broadcast`` — ack FIRST with ``broadcast_ok`` (main.go:109), dedup
    (main.go:113), append (main.go:117), then gossip to all topology
    neighbors except the sender (main.go:72-75) with per-neighbor retry;
  * ``read`` — ordered message log as ``read_ok`` (main.go:123-130);
  * ``topology`` — store the neighbor map, reply ``topology_ok``
    (main.go:132-149);
  * ``broadcast_ok`` — no-op sink for acks with no outstanding RPC
    (main.go:151-153); acks that match a pending RPC wake its waiter;
  * unknown types — Maelstrom error reply, code 10 (not-supported).

Deliberate fix vs the reference (flagged per SURVEY.md §2.2): the retry loop
creates a FRESH 2 s context per attempt, so a healed partition lets the
fan-out proceed (the reference reuses one expired context forever —
main.go:77-87, the §2.2.7 liveness hole; that faithful behavior is modeled
by :mod:`gossip_tpu_torch.runtime.gonative` where parity needs it).  Dedup and the
topology write are also race-free here by construction: each message is
handled on the single asyncio loop (the reference's §2.2.5-6 races came from
per-message goroutines).

This module imports neither torch nor numpy — it must start fast, N processes
at a time, under a harness.
"""

from __future__ import annotations

import asyncio
import json
import sys
from typing import Any, Callable, Dict, List, Optional

ERR_NOT_SUPPORTED = 10


class MaelstromNode:
    """Minimal async Maelstrom node runtime (the L0 layer, SURVEY.md §1).

    Handlers run as their own asyncio task per message — the cooperative
    analog of the Go library's goroutine-per-message dispatch, so a handler
    blocked in :meth:`rpc` never stalls the read loop."""

    def __init__(self):
        self.node_id: Optional[str] = None
        self.node_ids: List[str] = []
        self.handlers: Dict[str, Callable] = {}
        self._next_msg_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._write_lock: Optional[asyncio.Lock] = None

    def handle(self, typ: str, fn: Callable) -> None:
        self.handlers[typ] = fn

    def _msg_id(self) -> int:
        self._next_msg_id += 1
        return self._next_msg_id

    async def _write(self, dest: str, body: Dict[str, Any]) -> None:
        line = json.dumps({"src": self.node_id, "dest": dest, "body": body})
        async with self._write_lock:
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    async def send(self, dest: str, body: Dict[str, Any]) -> None:
        await self._write(dest, body)

    async def reply(self, req: Dict[str, Any], body: Dict[str, Any]) -> None:
        body = dict(body)
        body["in_reply_to"] = req["body"].get("msg_id")
        await self._write(req["src"], body)

    async def rpc(self, dest: str, body: Dict[str, Any],
                  timeout: float = 2.0) -> Dict[str, Any]:
        """SyncRPC analog (main.go:81): fresh msg_id, block until the
        matching ``in_reply_to`` arrives or the timeout expires."""
        body = dict(body)
        mid = self._msg_id()
        body["msg_id"] = mid
        fut = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        try:
            await self._write(dest, body)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(mid, None)

    async def _dispatch(self, msg: Dict[str, Any]) -> None:
        body = msg.get("body", {})
        typ = body.get("type")
        irt = body.get("in_reply_to")
        if irt is not None and irt in self._pending:
            fut = self._pending.pop(irt)
            if not fut.done():
                fut.set_result(msg)
            return
        if typ == "init":
            self.node_id = body["node_id"]
            self.node_ids = list(body.get("node_ids", []))
            await self.reply(msg, {"type": "init_ok"})
            return
        fn = self.handlers.get(typ)
        if fn is None:
            await self.reply(msg, {"type": "error", "code": ERR_NOT_SUPPORTED,
                                   "text": f"unhandled type {typ!r}"})
            return
        try:
            await fn(msg)
        except Exception as e:  # crash log on stderr, Maelstrom-style
            print(f"handler {typ} failed: {e!r}", file=sys.stderr)

    async def run(self) -> None:
        self._write_lock = asyncio.Lock()
        loop = asyncio.get_running_loop()
        while True:
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line:
                return                      # EOF: harness closed us
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                print(f"bad json: {e}", file=sys.stderr)
                continue
            asyncio.ensure_future(self._dispatch(msg))


class BroadcastServer:
    """The L1-L3 layers: message store + gossip engine + handlers.

    ``gossip_interval > 0`` switches the relay from the reference's
    immediate per-message fan-out (main.go:72-88 relays every broadcast
    to every neighbor the moment it arrives) to INTERVAL BATCHING — the
    efficiency variant the reference never addressed (SURVEY.md §4, the
    Gossip Glomers "efficient broadcast" challenge): new values
    accumulate per neighbor and ride one internal ``gossip`` RPC per
    neighbor per tick, acked with ``gossip_ok``.  A value stays pending
    for a neighbor until that neighbor acks a batch containing it, so
    delivery remains at-least-once across partitions (unacked batches
    simply retry next tick — there is no give-up; Maelstrom's checker
    demands eventual delivery).  Per-hop latency is bounded by
    ``interval + rtt``; messages-per-op drops from O(edges x values)
    toward O(edges x ticks) (measured in tests/test_torch_maelstrom.py).
    Client-facing ``broadcast``/``read`` semantics are unchanged."""

    def __init__(self, node: MaelstromNode, rpc_timeout: float = 2.0,
                 backoff_base: float = 0.1, max_retries: int = 64,
                 gossip_interval: float = 0.0):
        self.node = node
        self.rpc_timeout = rpc_timeout
        self.backoff_base = backoff_base
        self.max_retries = max_retries    # int-overflow guard (ref has none)
        self.gossip_interval = gossip_interval
        self.messages: List[int] = []     # ordered log (main.go:23)
        self.seen: set = set()            # dedup set (main.go:24)
        self.topology: Dict[str, List[str]] = {}
        self.pending: Dict[str, set] = {}   # neighbor -> values owed
        self._in_flight: set = set()        # neighbors with a live batch RPC
        self._flusher: Optional[asyncio.Task] = None
        node.handle("broadcast", self.on_broadcast)
        node.handle("read", self.on_read)
        node.handle("topology", self.on_topology)
        node.handle("broadcast_ok", self.on_broadcast_ok)
        node.handle("gossip", self.on_gossip)
        node.handle("gossip_ok", self.on_broadcast_ok)   # same sink

    async def on_broadcast(self, msg) -> None:
        body = msg["body"]
        m = body["message"]
        sender = msg["src"]                        # main.go:107
        await self.node.reply(msg, {"type": "broadcast_ok"})  # ack FIRST
        if m in self.seen:                         # dedup (main.go:113)
            return
        self.seen.add(m)
        self.messages.append(m)                    # append (main.go:117)
        if self.gossip_interval > 0:
            self._enqueue([m], exclude=sender)
        else:
            await self.gossip(m, exclude=sender)   # fan-out (main.go:118)

    # -- interval batching ------------------------------------------------

    def _enqueue(self, ms: List[int], exclude: str) -> None:
        assert self.gossip_interval > 0   # callers gate on the mode
        for nb in self.topology.get(self.node.node_id, []):
            if nb != exclude:
                self.pending.setdefault(nb, set()).update(ms)
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._flush_loop())

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            try:
                for nb, owed in self.pending.items():
                    if owed and nb not in self._in_flight:
                        self._in_flight.add(nb)
                        asyncio.ensure_future(
                            self._flush_one(nb, sorted(owed)))
            except Exception as e:
                # a poisoned batch (e.g. unsortable mixed-type values
                # from a hostile peer) must not kill the ONLY flusher —
                # that would silently strand every pending value forever
                print(f"flush loop error (continuing): {e!r}",
                      file=sys.stderr)

    async def _flush_one(self, nb: str, batch: List[int]) -> None:
        """One batch RPC; on ack the batch leaves the neighbor's owed
        set, on timeout/error it stays for the next tick (at-least-once
        with interval-paced retries instead of the immediate path's
        exponential backoff)."""
        try:
            reply = await self.node.rpc(nb, {"type": "gossip",
                                             "messages": batch},
                                        timeout=self.rpc_timeout)
            if reply.get("body", {}).get("type") != "error":
                self.pending[nb] -= set(batch)
        except asyncio.TimeoutError:
            pass
        finally:
            self._in_flight.discard(nb)

    async def on_gossip(self, msg) -> None:
        body = msg["body"]
        sender = msg["src"]
        await self.node.reply(msg, {"type": "gossip_ok"})     # ack FIRST
        new = [m for m in body.get("messages", []) if m not in self.seen]
        for m in new:
            self.seen.add(m)
            self.messages.append(m)
        if not new:
            return
        if self.gossip_interval > 0:
            self._enqueue(new, exclude=sender)
        else:
            # an immediate-mode node in a heterogeneous cluster relays a
            # received batch through its own immediate path — it must
            # never start the tick flusher (interval 0 would busy-spin)
            for m in new:
                await self.gossip(m, exclude=sender)

    async def gossip(self, m: int, exclude: str) -> None:
        """Sequential fan-out with retry (main.go:65-89), fixed-context
        variant: fresh 2 s deadline per attempt (see module doc)."""
        neighbors = self.topology.get(self.node.node_id, [])
        for nb in neighbors:
            if nb == exclude:                      # sender exclusion
                continue
            for attempt in range(self.max_retries):
                try:
                    reply = await self.node.rpc(nb, {"type": "broadcast",
                                                     "message": m},
                                                timeout=self.rpc_timeout)
                except asyncio.TimeoutError:
                    pass                           # lost/late: retry
                else:
                    # An error reply is a failed delivery, not an ack: the
                    # reference's SyncRPC returns error replies as Go errors
                    # and stays in the retry loop (main.go:81-87).
                    if reply.get("body", {}).get("type") != "error":
                        break
                if attempt + 1 < self.max_retries:   # no sleep before give-up
                    await asyncio.sleep(
                        self.backoff_base * (2 ** min(attempt, 12)))
            else:
                # at-least-once exhausted (the capped variant of the
                # reference's unbounded loop) — surface it, don't lose it
                # silently
                print(f"gossip: giving up on {nb} after "
                      f"{self.max_retries} attempts (message {m!r})",
                      file=sys.stderr)

    async def on_read(self, msg) -> None:
        await self.node.reply(msg, {"type": "read_ok",
                                    "messages": list(self.messages)})

    async def on_topology(self, msg) -> None:
        self.topology = {k: list(v)
                         for k, v in msg["body"]["topology"].items()}
        await self.node.reply(msg, {"type": "topology_ok"})

    async def on_broadcast_ok(self, msg) -> None:
        pass                                       # sink (main.go:151-153)


class CounterServer:
    """The Gossip Glomers grow-only / PN counter workload node: the
    SAME epidemic machinery as :class:`BroadcastServer` with a
    commutative-merge payload instead of the dedup set (the batched
    twin is gossip_tpu_torch/models/crdt.py; docs/WORKLOADS.md).

    State is the classic per-node counter shards — ``pos``/``neg`` maps
    ``node_id -> contribution`` where only the owner ever raises its
    own entry — so merge is **per-key max** and gossip order,
    duplication, and loss cannot corrupt the value.  Client ops:

      * ``add {delta}`` — ack ``add_ok`` FIRST (the reference's
        ack-before-process shape, main.go:109), then bump the own
        shard (negative deltas land in the ``neg`` plane — the PN
        variant; a grow-only workload simply never sends one);
      * ``read`` — ``read_ok {value}``, value = sum(pos) - sum(neg).

    Dissemination is interval-ticked full-state gossip: every
    ``interval`` seconds each neighbor that has not acked the CURRENT
    shard maps gets one ``counter_gossip`` RPC carrying them; an ack
    records the acked snapshot, a timeout/partition leaves the
    neighbor dirty for the next tick — at-least-once with idempotent
    merge, so a healed partition converges with no special casing
    (the BroadcastServer batching layer's retry shape)."""

    def __init__(self, node: MaelstromNode, rpc_timeout: float = 2.0,
                 gossip_interval: float = 0.05):
        self.node = node
        self.rpc_timeout = rpc_timeout
        self.gossip_interval = gossip_interval
        self.pos: Dict[str, int] = {}
        self.neg: Dict[str, int] = {}
        self.topology: Dict[str, List[str]] = {}
        self.acked: Dict[str, tuple] = {}   # nbr -> last acked snapshot
        self._in_flight: set = set()
        self._flusher: Optional[asyncio.Task] = None
        node.handle("add", self.on_add)
        node.handle("read", self.on_read)
        node.handle("topology", self.on_topology)
        node.handle("counter_gossip", self.on_gossip)
        node.handle("counter_gossip_ok", self.on_sink)
        node.handle("add_ok", self.on_sink)

    def _value(self) -> int:
        return sum(self.pos.values()) - sum(self.neg.values())

    def _snapshot(self) -> tuple:
        return (tuple(sorted(self.pos.items())),
                tuple(sorted(self.neg.items())))

    def _merge(self, pos: Dict[str, int], neg: Dict[str, int]) -> bool:
        """Per-key max join; True when anything changed (a change means
        neighbors may be stale, which the snapshot compare picks up)."""
        changed = False
        for mine, theirs in ((self.pos, pos), (self.neg, neg)):
            for nid, v in theirs.items():
                if int(v) > mine.get(nid, 0):
                    mine[nid] = int(v)
                    changed = True
        return changed

    def _ensure_flusher(self) -> None:
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._flush_loop())

    async def on_add(self, msg) -> None:
        body = msg["body"]
        delta = int(body.get("delta", 0))
        await self.node.reply(msg, {"type": "add_ok"})   # ack FIRST
        me = self.node.node_id
        if delta >= 0:
            self.pos[me] = self.pos.get(me, 0) + delta
        else:
            self.neg[me] = self.neg.get(me, 0) - delta
        self._ensure_flusher()

    async def on_read(self, msg) -> None:
        await self.node.reply(msg, {"type": "read_ok",
                                    "value": self._value()})

    async def on_topology(self, msg) -> None:
        self.topology = {k: list(v)
                         for k, v in msg["body"]["topology"].items()}
        await self.node.reply(msg, {"type": "topology_ok"})

    async def on_gossip(self, msg) -> None:
        body = msg["body"]
        await self.node.reply(msg, {"type": "counter_gossip_ok"})
        if self._merge(body.get("pos", {}), body.get("neg", {})):
            self._ensure_flusher()

    async def on_sink(self, msg) -> None:
        pass

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            try:
                snap = self._snapshot()
                for nb in self.topology.get(self.node.node_id, []):
                    if (self.acked.get(nb) != snap
                            and nb not in self._in_flight):
                        self._in_flight.add(nb)
                        asyncio.ensure_future(self._flush_one(nb, snap))
            except Exception as e:    # never kill the only flusher
                print(f"counter flush loop error (continuing): {e!r}",
                      file=sys.stderr)

    async def _flush_one(self, nb: str, snap: tuple) -> None:
        try:
            reply = await self.node.rpc(
                nb, {"type": "counter_gossip",
                     "pos": dict(self.pos), "neg": dict(self.neg)},
                timeout=self.rpc_timeout)
            if reply.get("body", {}).get("type") != "error":
                self.acked[nb] = snap
        except asyncio.TimeoutError:
            pass                      # partitioned/lost: retry next tick
        finally:
            self._in_flight.discard(nb)


class KafkaServer:
    """The Gossip Glomers replicated-log ("kafka") workload node: the
    last challenge-family sibling (the batched twin is
    gossip_tpu_torch/models/log.py; docs/WORKLOADS.md "Replicated logs").

    Per-key logs with a single OFFSET-ASSIGNER: key ``k`` is owned by
    a deterministic node (``crc32(key) % n`` over the init-ordered
    ``node_ids`` — every node computes the same owner with no
    coordination), and only the owner assigns offsets, so each key's
    log is gap-free and append-ordered at the source.  Replicas learn
    entries by interval-ticked full-state gossip with an idempotent
    union merge — every gossiped map is a union of owner prefixes of
    the same sequence, so **every replica always holds a contiguous
    prefix per key** (gapless polls are structural, not checked-for).
    Committed offsets merge by per-key max (monotone — they can never
    regress, the second kafka invariant).  Client ops:

      * ``send {key, msg}`` — owner appends and replies ``send_ok
        {offset}``; a non-owner FORWARDS to the owner with
        fresh-deadline retries (the BroadcastServer.gossip shape) and
        acks the client only with the owner's offset — so an acked
        send is in the log exactly once at its acked offset.  Retried
        forwards are deduplicated at the owner BY VALUE per key (the
        workload sends unique values — the CrdtConfig one-add-tag
        convention, documented); exhausted retries reply a Maelstrom
        error (code 11).  An errored or client-timed-out send is
        INDETERMINATE, not absent: the forward may have landed at the
        owner with its ack lost (at-least-once), so the workload
        checker admits such values in polls — but still at most once,
        which the owner's value dedup guarantees.
      * ``poll {offsets: {key: off}}`` — ``poll_ok {msgs: {key:
        [[off, msg], ...]}}``: the contiguous local run from ``off``.
      * ``commit_offsets {offsets}`` — per-key max into the committed
        map, ack, gossip.
      * ``list_committed_offsets {keys}`` — the committed map slice.
    """

    ERR_TEMP_UNAVAILABLE = 11

    def __init__(self, node: MaelstromNode, rpc_timeout: float = 2.0,
                 gossip_interval: float = 0.05,
                 backoff_base: float = 0.1, max_retries: int = 64):
        self.node = node
        self.rpc_timeout = rpc_timeout
        self.gossip_interval = gossip_interval
        self.backoff_base = backoff_base
        self.max_retries = max_retries
        self.entries: Dict[str, Dict[int, Any]] = {}  # key -> off -> msg
        self.by_val: Dict[str, Dict[Any, int]] = {}   # owner dedup
        self.committed: Dict[str, int] = {}
        self.topology: Dict[str, List[str]] = {}
        self.acked: Dict[str, tuple] = {}   # nbr -> last acked snapshot
        self._in_flight: set = set()
        self._flusher: Optional[asyncio.Task] = None
        node.handle("send", self.on_send)
        node.handle("poll", self.on_poll)
        node.handle("commit_offsets", self.on_commit_offsets)
        node.handle("list_committed_offsets",
                    self.on_list_committed_offsets)
        node.handle("topology", self.on_topology)
        node.handle("kafka_gossip", self.on_gossip)
        node.handle("kafka_gossip_ok", self.on_sink)

    def _owner(self, key: str) -> str:
        import zlib
        ids = self.node.node_ids
        return ids[zlib.crc32(str(key).encode()) % len(ids)]

    def _ensure_flusher(self) -> None:
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._flush_loop())

    def _append_as_owner(self, key: str, msg) -> int:
        """Owner-side append: next offset = local log length (the
        owner's log is gap-free by construction); a retried forward of
        an already-appended value returns its existing offset."""
        vals = self.by_val.setdefault(key, {})
        if msg in vals:
            return vals[msg]
        log = self.entries.setdefault(key, {})
        off = len(log)
        log[off] = msg
        vals[msg] = off
        self._ensure_flusher()
        return off

    async def on_send(self, msg) -> None:
        body = msg["body"]
        key, value = str(body["key"]), body["msg"]
        if self._owner(key) == self.node.node_id:
            off = self._append_as_owner(key, value)
            await self.node.reply(msg, {"type": "send_ok",
                                        "offset": off})
            return
        # forward to the owner with fresh-deadline retries; ack the
        # client only with the owner's assigned offset
        for attempt in range(self.max_retries):
            try:
                reply = await self.node.rpc(
                    self._owner(key), {"type": "send", "key": key,
                                       "msg": value},
                    timeout=self.rpc_timeout)
            except asyncio.TimeoutError:
                pass                           # lost/partitioned: retry
            else:
                rb = reply.get("body", {})
                if rb.get("type") == "send_ok":
                    await self.node.reply(msg, {
                        "type": "send_ok", "offset": rb["offset"]})
                    return
            if attempt + 1 < self.max_retries:
                await asyncio.sleep(
                    self.backoff_base * (2 ** min(attempt, 12)))
        await self.node.reply(msg, {
            "type": "error", "code": self.ERR_TEMP_UNAVAILABLE,
            "text": f"could not reach owner of key {key!r}"})

    async def on_poll(self, msg) -> None:
        out: Dict[str, list] = {}
        for key, off in (msg["body"].get("offsets") or {}).items():
            log = self.entries.get(str(key), {})
            o, lst = int(off), []
            while o in log:                  # contiguous run: gapless
                lst.append([o, log[o]])
                o += 1
            out[key] = lst
        await self.node.reply(msg, {"type": "poll_ok", "msgs": out})

    async def on_commit_offsets(self, msg) -> None:
        await self.node.reply(msg, {"type": "commit_offsets_ok"})
        changed = False
        for key, off in (msg["body"].get("offsets") or {}).items():
            key = str(key)
            if int(off) > self.committed.get(key, -1):
                self.committed[key] = int(off)
                changed = True
        if changed:
            self._ensure_flusher()

    async def on_list_committed_offsets(self, msg) -> None:
        keys = [str(k) for k in msg["body"].get("keys") or []]
        await self.node.reply(msg, {
            "type": "list_committed_offsets_ok",
            "offsets": {k: self.committed[k] for k in keys
                        if k in self.committed}})

    async def on_topology(self, msg) -> None:
        self.topology = {k: list(v)
                         for k, v in msg["body"]["topology"].items()}
        await self.node.reply(msg, {"type": "topology_ok"})

    async def on_gossip(self, msg) -> None:
        body = msg["body"]
        await self.node.reply(msg, {"type": "kafka_gossip_ok"})
        changed = False
        for key, ent in (body.get("entries") or {}).items():
            log = self.entries.setdefault(str(key), {})
            for off_s, value in ent.items():
                off = int(off_s)             # JSON keys arrive as str
                if off not in log:
                    log[off] = value
                    changed = True
        for key, off in (body.get("committed") or {}).items():
            if int(off) > self.committed.get(str(key), -1):
                self.committed[str(key)] = int(off)
                changed = True
        if changed:
            self._ensure_flusher()

    async def on_sink(self, msg) -> None:
        pass

    def _snapshot(self) -> tuple:
        return (tuple(sorted((k, tuple(sorted(v.items())))
                             for k, v in self.entries.items())),
                tuple(sorted(self.committed.items())))

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            try:
                snap = self._snapshot()
                for nb in self.topology.get(self.node.node_id, []):
                    if (self.acked.get(nb) != snap
                            and nb not in self._in_flight):
                        self._in_flight.add(nb)
                        asyncio.ensure_future(self._flush_one(nb, snap))
            except Exception as e:    # never kill the only flusher
                print(f"kafka flush loop error (continuing): {e!r}",
                      file=sys.stderr)

    async def _flush_one(self, nb: str, snap: tuple) -> None:
        try:
            reply = await self.node.rpc(
                nb, {"type": "kafka_gossip",
                     "entries": {k: {str(o): m for o, m in v.items()}
                                 for k, v in self.entries.items()},
                     "committed": dict(self.committed)},
                timeout=self.rpc_timeout)
            if reply.get("body", {}).get("type") != "error":
                self.acked[nb] = snap
        except asyncio.TimeoutError:
            pass                      # partitioned/lost: retry next tick
        finally:
            self._in_flight.discard(nb)


class TxnServer:
    """The Maelstrom ``txn-rw-register`` workload node: totally-
    available multi-key read/write transactions over gossip-replicated
    last-writer-wins registers (the batched twin is
    gossip_tpu_torch/models/register.py; docs/WORKLOADS.md "Transactions").

    State: ``store[key] = (value, ts)`` with ``ts = (counter,
    node_index)`` — a Lamport pair, totally ordered, merged per key by
    LWW.  The counter is a Lamport clock: bumped past every counter
    seen in gossip, so a transaction's timestamp always exceeds every
    write it could have read — the commit discipline that makes the
    healthy system read-uncommitted-clean (every write of a txn shares
    ONE timestamp, so cross-key version orders collapse onto the total
    timestamp order and G0 cycles are impossible; the checker verifies
    rather than trusts this, runtime/txn_checker.py).

    Client op: ``txn {txn: [["r", k, null], ["w", k, v], ...]}`` —
    the micro-op list is VALIDATED first (an error reply is therefore
    a definite abort: nothing was applied — the G1a contract), then
    applied atomically on the single event loop: one timestamp for the
    whole transaction, reads see the local LWW state *as of this
    transaction* (its own earlier writes included), writes install
    ``(value, ts)``.  The reply is ``txn_ok {txn: [...completed...],
    ts: [counter, node_index]}`` — the timestamp rides the reply so
    the external checker can reconstruct per-key version orders from
    the trace alone.  Total availability: a partitioned node still
    answers from local state; convergence resumes with gossip.

    Dissemination is the CounterServer shape: interval-ticked
    full-state gossip with per-neighbor acked-snapshot dirtiness —
    at-least-once with idempotent LWW merge, so a healed partition
    converges with no special casing."""

    ERR_MALFORMED = 13            # Maelstrom "malformed-request"

    def __init__(self, node: MaelstromNode, rpc_timeout: float = 2.0,
                 gossip_interval: float = 0.05):
        self.node = node
        self.rpc_timeout = rpc_timeout
        self.gossip_interval = gossip_interval
        self.store: Dict[str, list] = {}   # key -> [value, [c, idx]]
        self.counter = 0                   # Lamport clock
        self.topology: Dict[str, List[str]] = {}
        self.acked: Dict[str, tuple] = {}  # nbr -> last acked snapshot
        self._in_flight: set = set()
        self._flusher: Optional[asyncio.Task] = None
        node.handle("txn", self.on_txn)
        node.handle("topology", self.on_topology)
        node.handle("txn_gossip", self.on_gossip)
        node.handle("txn_gossip_ok", self.on_sink)

    def _my_index(self) -> int:
        return self.node.node_ids.index(self.node.node_id)

    def _ensure_flusher(self) -> None:
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._flush_loop())

    async def on_txn(self, msg) -> None:
        body = msg["body"]
        ops = body.get("txn")
        # validate the WHOLE micro-op list before touching state: an
        # error reply must be a definite abort (nothing applied), or
        # G1a stops being checkable (runtime/txn_checker.py)
        if not isinstance(ops, list) or not all(
                isinstance(op, list) and len(op) == 3
                and op[0] in ("r", "w")
                and (op[0] == "r" or op[2] is not None)
                for op in ops):
            await self.node.reply(msg, {
                "type": "error", "code": self.ERR_MALFORMED,
                "text": "txn must be a list of [\"r\"|\"w\", key, "
                        "value] micro-ops (write values non-null)"})
            return
        # one Lamport timestamp for the whole transaction — every
        # write shares it, which is what collapses cross-key version
        # orders onto one total order (class doc)
        self.counter += 1
        ts = [self.counter, self._my_index()]
        done = []
        wrote = False
        for f, k, v in ops:
            k = str(k)
            if f == "r":
                cur = self.store.get(k)
                done.append(["r", k, cur[0] if cur else None])
            else:
                cur = self.store.get(k)
                # >= not >: an equal timestamp can only be this
                # transaction's OWN earlier write (the counter bumps
                # per txn and the owner is us), and program order says
                # the later micro-op wins — a strict compare would
                # silently drop a txn's second write to the same key
                # while still acking it (review finding)
                if cur is None or ts >= cur[1]:
                    self.store[k] = [v, list(ts)]
                wrote = True
                done.append(["w", k, v])
        await self.node.reply(msg, {"type": "txn_ok", "txn": done,
                                    "ts": ts})
        if wrote:
            self._ensure_flusher()

    async def on_topology(self, msg) -> None:
        self.topology = {k: list(v)
                         for k, v in msg["body"]["topology"].items()}
        await self.node.reply(msg, {"type": "topology_ok"})

    async def on_gossip(self, msg) -> None:
        body = msg["body"]
        await self.node.reply(msg, {"type": "txn_gossip_ok"})
        changed = False
        for k, (v, ts) in (body.get("store") or {}).items():
            ts = [int(ts[0]), int(ts[1])]
            cur = self.store.get(str(k))
            if cur is None or ts > cur[1]:
                self.store[str(k)] = [v, ts]
                changed = True
        # Lamport merge: local events after this gossip must order
        # after everything the peer had seen
        peer_c = int(body.get("counter", 0))
        if peer_c > self.counter:
            self.counter = peer_c
            changed = True
        if changed:
            self._ensure_flusher()

    async def on_sink(self, msg) -> None:
        pass

    def _snapshot(self) -> tuple:
        return tuple(sorted((k, v[0], tuple(v[1]))
                            for k, v in self.store.items()))

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            try:
                snap = self._snapshot()
                for nb in self.topology.get(self.node.node_id, []):
                    if (self.acked.get(nb) != snap
                            and nb not in self._in_flight):
                        self._in_flight.add(nb)
                        asyncio.ensure_future(self._flush_one(nb, snap))
            except Exception as e:    # never kill the only flusher
                print(f"txn flush loop error (continuing): {e!r}",
                      file=sys.stderr)

    async def _flush_one(self, nb: str, snap: tuple) -> None:
        try:
            reply = await self.node.rpc(
                nb, {"type": "txn_gossip",
                     "store": {k: [v[0], list(v[1])]
                               for k, v in self.store.items()},
                     "counter": self.counter},
                timeout=self.rpc_timeout)
            if reply.get("body", {}).get("type") != "error":
                self.acked[nb] = snap
        except asyncio.TimeoutError:
            pass                      # partitioned/lost: retry next tick
        finally:
            self._in_flight.discard(nb)


WORKLOADS = ("broadcast", "counter", "kafka", "txn")


async def amain(gossip_interval: float = 0.0,
                workload: str = "broadcast") -> None:
    node = MaelstromNode()
    if workload == "counter":
        CounterServer(node,
                      gossip_interval=gossip_interval or 0.05)
    elif workload == "kafka":
        KafkaServer(node, gossip_interval=gossip_interval or 0.05)
    elif workload == "txn":
        TxnServer(node, gossip_interval=gossip_interval or 0.05)
    else:
        BroadcastServer(node, gossip_interval=gossip_interval)
    await node.run()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--gossip-interval", type=float, default=0.0,
                    help="batch relays per neighbor every INTERVAL "
                         "seconds (0 = the reference's immediate "
                         "per-message fan-out; the counter workload "
                         "always ticks, default 0.05)")
    ap.add_argument("--workload", default="broadcast",
                    choices=WORKLOADS,
                    help="protocol personality: the reference's "
                         "broadcast log, the Gossip Glomers counter "
                         "(per-node CRDT shards, merge = per-key "
                         "max), the replicated kafka-style log "
                         "(owner-assigned offsets, committed-offset "
                         "max merge), or txn-rw-register (totally-"
                         "available transactions over LWW "
                         "registers, Lamport-pair timestamps)")
    args = ap.parse_args(argv)
    asyncio.run(amain(args.gossip_interval, args.workload))


if __name__ == "__main__":
    main()
