"""The port's Maelstrom runtime: its protocol node, harness, C++ router
and ``maelstrom-check`` against the JAX package's.

Real ``python -m gossip_tpu_torch.runtime.maelstrom_node`` processes
over stdin/stdout pipes through the port's mini-Maelstrom router, as
``tests/test_maelstrom.py`` drives the reference's: conformance,
propagation, retries, partitions.  ``maelstrom-check`` runs every
workload on the Python router and broadcast on the C++ one (built into
the port's build directory); the invariant must hold and the stats must
carry the reference's keys for the same command (the counts depend on
the wall clock, so they are not compared).  A spawned node imports no
torch.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from gossip_tpu_torch.ops import _kernels
from gossip_tpu_torch.runtime.maelstrom_harness import (
    MaelstromHarness, grid_topology, line_topology, run_broadcast_workload)
from gossip_tpu_torch.runtime.maelstrom_node import (BroadcastServer,
                                                     MaelstromNode)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "gossip_tpu_torch.runtime.maelstrom_node"
BATCHED = [sys.executable, "-u", "-m", NODE, "--gossip-interval", "0.05"]


@pytest.fixture(autouse=True)
def _build_dir(tmp_path_factory, monkeypatch):
    """The C++ router is built into a directory of this session."""
    monkeypatch.setitem(_kernels._STORE, "dir", None)
    monkeypatch.setenv("GOSSIP_COMPILE_CACHE",
                       str(tmp_path_factory.getbasetemp() / "native_build"))


def run(coro):
    return asyncio.run(coro)


def test_single_node_conformance():
    async def main():
        h = MaelstromHarness(1)
        await h.start()
        try:
            await h.set_topology({"n0": []})
            r = await h.broadcast("n0", 7)
            assert r["body"]["type"] == "broadcast_ok"
            assert r["body"]["in_reply_to"] == h._next_msg_id
            assert await h.read("n0") == [7]
            await h.broadcast("n0", 7)           # dedup
            assert await h.read("n0") == [7]
            err = await h.send_raw("n0", {"type": "frobnicate"})
            assert err["body"]["type"] == "error"
            assert err["body"]["code"] == 10
        finally:
            await h.stop()
    run(main())


@pytest.mark.parametrize("shape", ["line", "grid"])
def test_propagation(shape):
    async def main():
        n = 5 if shape == "line" else 9
        h = MaelstromHarness(n)
        await h.start()
        try:
            if shape == "line":
                await h.set_topology(line_topology(h.ids))
                sends = [("n0", 1), ("n0", 2), ("n0", 3), ("n4", 99)]
            else:
                await h.set_topology(grid_topology(h.ids, cols=3))
                sends = [(h.ids[i * 4 % 9], v)
                         for i, v in enumerate((10, 20, 30))]
            for nid, v in sends:
                await h.broadcast(nid, v)
            await h.quiesce()
            for nid in h.ids:
                assert sorted(await h.read(nid)) == \
                    sorted(v for _, v in sends), nid
        finally:
            await h.stop()
    run(main())


class _StubNode:
    """Scripted peer for the retry policy."""

    node_id = "n0"

    def __init__(self, replies):
        self.replies = list(replies)
        self.calls = 0

    def handle(self, typ, fn):
        pass

    async def rpc(self, dest, body, timeout=2.0):
        i = min(self.calls, len(self.replies) - 1)
        self.calls += 1
        return {"src": dest, "body": {"type": self.replies[i]}}


def test_error_reply_is_retried_not_taken_as_an_ack(capsys):
    async def main():
        node = _StubNode(["error", "error", "broadcast_ok"])
        srv = BroadcastServer(node, backoff_base=0.0)
        srv.topology = {"n0": ["n1"]}
        await srv.gossip(5, exclude="nX")
        assert node.calls == 3
        node = _StubNode(["error"])
        srv = BroadcastServer(node, backoff_base=0.0, max_retries=4)
        srv.topology = {"n0": ["n1"]}
        await srv.gossip(9, exclude="nX")
        assert node.calls == 4
    run(main())
    assert "giving up on n1" in capsys.readouterr().err


def test_partition_heals_by_retry():
    async def main():
        h = MaelstromHarness(3, latency=0.002)
        await h.start()
        try:
            await h.set_topology(line_topology(h.ids))
            h.partition("n1", "n2", duration=1.5)
            await h.broadcast("n0", 5)
            await asyncio.sleep(0.3)
            assert await h.read("n1") == [5]
            assert await h.read("n2") == []
            await asyncio.sleep(2.0)
            await h.quiesce()
            assert await h.read("n2") == [5]
        finally:
            await h.stop()
    run(main())


def test_batched_node_survives_a_partition():
    stats = run(run_broadcast_workload(4, ops=8, rate=25.0, latency=0.001,
                                       partition_mid=True, seed=3,
                                       argv=BATCHED))
    assert stats["invariant_ok"] is True and stats["partitioned"] is True


def test_immediate_node_relays_a_batch_without_a_flusher():
    async def main():
        node = MaelstromNode()
        node.node_id = "n0"
        srv = BroadcastServer(node, gossip_interval=0.0)
        srv.topology = {"n0": ["n1", "n2"]}
        sent = []

        async def fake_reply(msg, body):
            sent.append(("reply", body["type"]))

        async def fake_rpc(dest, body, timeout=2.0):
            sent.append((dest, body.get("message")))
            return {"body": {"type": "broadcast_ok"}}

        node.reply = fake_reply
        node.rpc = fake_rpc
        await srv.on_gossip({"src": "n1", "body": {"type": "gossip",
                                                   "messages": [7, 8]}})
        assert srv._flusher is None
        assert srv.messages == [7, 8]
        assert [m for d, m in sent if d == "n2"] == [7, 8]
        assert not any(d == "n1" for d, _ in sent)
    run(main())


# the reference keeps these two in its slow tier (tests/test_maelstrom.py)
@pytest.mark.slow
def test_broadcast_workload_stats_and_invariant():
    stats = run(run_broadcast_workload(4, ops=8, rate=100.0, latency=0.001,
                                       seed=2))
    assert stats["invariant_ok"] is True and stats["broadcast_ops"] == 8
    assert stats["op_latency_ms"]["p99"] >= stats["op_latency_ms"]["p50"] > 0
    stats = run(run_broadcast_workload(4, ops=8, rate=25.0, latency=0.001,
                                       partition_mid=True, seed=3))
    assert stats["invariant_ok"] is True and stats["partitioned"] is True


@pytest.mark.slow
def test_interval_batching_cuts_msgs_per_op():
    immediate = run(run_broadcast_workload(5, ops=20, rate=200.0,
                                           latency=0.001, seed=4))
    batched = run(run_broadcast_workload(5, ops=20, rate=200.0,
                                         latency=0.001, seed=4,
                                         argv=BATCHED))
    assert immediate["invariant_ok"] and batched["invariant_ok"]
    assert batched["msgs_per_op"] < 0.6 * immediate["msgs_per_op"]


# the reference keeps the native router's grid case in its slow tier
# (tests/test_native_router.py)
@pytest.mark.slow
def test_native_router_grid_topology():
    from gossip_tpu_torch.runtime.native_router import run_native_workload
    grid = run_native_workload(6, ops=6, rate=50.0, latency=0.001,
                               topology="grid", seed=1)
    line = run_native_workload(6, ops=6, rate=50.0, latency=0.001,
                               topology="line", seed=1)
    assert grid["invariant_ok"] is True
    assert grid["msgs_per_op"] > line["msgs_per_op"]


def _main_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


CHECKS = {
    "broadcast": ["--workload", "broadcast", "--n", "3", "--ops", "6",
                  "--rate", "100"],
    "broadcast_native": ["--workload", "broadcast", "--router", "native",
                         "--n", "4", "--ops", "6", "--rate", "100",
                         "--partition", "--assert-msgs-per-op", "1000"],
    "counter": ["--workload", "counter", "--n", "3", "--ops", "6",
                "--rate", "100", "--assert-latency-ms", "60000"],
    "kafka": ["--workload", "kafka", "--n", "3", "--ops", "6", "--rate",
              "100"],
    "txn": ["--workload", "txn", "--n", "3", "--ops", "6", "--rate", "100"],
}


@pytest.mark.parametrize("name", CHECKS)
def test_maelstrom_check_holds_its_invariant_with_the_references_keys(
        name, monkeypatch):
    """The port's command runs the workload through the port's node,
    harness, checker (and router); its stats carry exactly the keys of
    the JAX package's command on the same arguments."""
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    rc, lines = _main_lines(cli.main, ["maelstrom-check", *CHECKS[name]])
    assert rc == 0 and len(lines) == 1
    got = lines[0]
    assert got["invariant_ok"] is True
    if "native" in name:
        assert got["engine"] == "native-router"
        from gossip_tpu_torch.runtime.native_router import build_router
        path = build_router()
        assert os.path.dirname(path) == os.environ["GOSSIP_COMPILE_CACHE"]
    jrc, jlines = _main_lines(jcli.main, ["maelstrom-check", *CHECKS[name]])
    assert jrc == 0
    assert sorted(got) == sorted(jlines[0])


@pytest.mark.parametrize("workload", ["counter", "kafka", "txn"])
def test_native_router_refusals_are_the_references(workload, capsys):
    from gossip_tpu import cli as jcli
    from gossip_tpu_torch import cli
    argv = ["maelstrom-check", "--workload", workload, "--router", "native"]
    assert cli.main(argv) == 2
    got = capsys.readouterr()
    assert jcli.main(argv) == 2
    want = capsys.readouterr()
    assert got.err == want.err and not got.out


PROBE = """
import sys
from gossip_tpu_torch.runtime import maelstrom_node
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('torch', 'jax', 'gossip_tpu', 'numpy')))
"""


def test_a_spawned_node_imports_no_torch():
    """The harness spawns N node processes: none of them imports torch
    (nor jax, numpy or the JAX package).  A node answers init over its
    pipes, and the module loads nothing heavy."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    init = json.dumps({"src": "c1", "dest": "n0", "body": {
        "type": "init", "msg_id": 1, "node_id": "n0", "node_ids": ["n0"]}})
    proc = subprocess.run([sys.executable, "-u", "-m", NODE],
                          input=init + "\n", capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=60)
    reply = json.loads(proc.stdout.splitlines()[0])
    assert reply["body"]["type"] == "init_ok"
