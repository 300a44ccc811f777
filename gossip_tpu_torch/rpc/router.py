"""Replicated serving: a failover router in front of N sidecar replicas.

The port of the JAX package's ``rpc/router.py``.  The router probes its
replicas' ``Health``, sends ``Run`` / ``Ensemble`` to a healthy one (the
least loaded), and when a replica's transport fails under a request it
sends the same bytes to a survivor: a request is a pure function of its
payload (seeded draws, no server state), so the replay's reply is the
same, byte for byte.

The reference's contract: the router passes request and reply bytes
through untouched (failover shows in the ledger's ``replica_down`` /
``failover`` / ``replica_up`` events, never in a reply); only a
transport failure (UNAVAILABLE or CANCELLED, or a closed channel) is
redispatched, and any well-formed reply from a replica is passed on as
it is; each attempt gets the client's remaining deadline, and an expired
one is DEADLINE_EXCEEDED, never replayed; with no healthy replica under
its in-flight cap the router sheds (RESOURCE_EXHAUSTED and a ``shed``
event) and holds no queue; a replica goes down after ``down_after``
failed probes (or one failed dispatch) and a downed one comes back after
``up_after`` consecutive healthy probes.

The control plane is a replicated log (:mod:`gossip_tpu_torch.ops.logs`
on host tensors, :class:`ControlPlane`): replica i owns key i, its state
changes append there, and the committed offset of its key is its config
epoch; the views merge by the log's join and are gossiped one rotating
partner a probe tick, and a replica that rejoins after a kill catches up
from the survivors' views.

Everything that needs ``grpc`` (the replicas' channels, the probes,
:func:`serve_router`, :class:`Fleet`) imports it inside the function.
:func:`spawn_replica` starts ``python -m gossip_tpu_torch serve``; the
replicas inherit the caller's ``--device`` through ``replica_argv``.
With ``FleetConfig.devices_per_replica`` K above 1 each replica serves
a K-rank megabatch mesh: its ``serve --devices K`` (plus ``--share-card``
where the host has fewer cards than K, :func:`replica_mesh_argv`) is
what the reference's ``fleet_env`` gives its children through XLA's
host device count, and every spawn and respawn is checked by
:func:`_verify_replica_devices`: a replica whose ``Health`` reports a
narrower mesh is torn down and the fleet refuses, loudly.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gossip_tpu_torch.config import FleetConfig, LogConfig

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# Admission states, appended as log values (>= 1: 0 is the empty slot).
STATE_UP = 1
STATE_DOWN = 2
_STATE_NAMES = {STATE_UP: "up", STATE_DOWN: "down"}


class ControlPlane:
    """The fleet's replicated admission log (module doc): one
    ``ops/logs`` row a replica view over ``LogConfig(keys=n,
    capacity)``, numpy ``int32``; every view operation is the log's own
    (``state_width``, ``merge_max``, ``log_len``, ``committed_of``) on
    CPU tensors.  All mutation happens under the router's lock."""

    def __init__(self, n: int, capacity: int):
        from gossip_tpu_torch.ops import logs
        self._logs = logs
        self.cfg = LogConfig(keys=n, capacity=capacity)
        self.n = n
        self.width = logs.state_width(self.cfg)
        self.views = np.zeros((n, self.width), np.int32)
        self._gtick = 0

    def _merge(self, a, b) -> np.ndarray:
        return self._logs.merge_max(torch.from_numpy(np.asarray(a)),
                                    torch.from_numpy(np.asarray(b))).numpy()

    def _merged(self) -> np.ndarray:
        out = self.views[0]
        for i in range(1, self.n):
            out = self._merge(out, self.views[i])
        return out

    def _committed(self, row) -> np.ndarray:
        return self._logs.committed_of(self.cfg,
                                       torch.from_numpy(row)).numpy()

    def append(self, owner: int, state: int) -> int:
        """Append ``state`` on ``owner``'s key in its view and commit it:
        the new epoch, taken from the merged view so a lagging owner
        never reuses an offset."""
        cap = self.cfg.capacity
        e = int(self._logs.log_len(
            self.cfg, torch.from_numpy(self._merged()))[owner])
        if e >= cap:
            # the reference's words
            raise ValueError(
                f"control-plane log for replica {owner} is full "
                f"({e}/{cap} epochs) — a ring wrap would alias epochs; "
                "raise FleetConfig.control_capacity")
        self.views[owner, owner * cap + e] = state
        com = self.cfg.keys * cap + owner
        self.views[owner, com] = max(int(self.views[owner, com]), e + 1)
        return e + 1

    def gossip_tick(self):
        """One rotating-partner pull a view: view i merges view
        ``(i + k) % n``; the fleet converges within n - 1 ticks."""
        if self.n < 2:
            return
        self._gtick += 1
        k = 1 + (self._gtick % (self.n - 1))
        for i in range(self.n):
            self.views[i] = self._merge(self.views[i],
                                        self.views[(i + k) % self.n])

    def flush(self, i: int):
        """Push view i's entries to every peer (before it is wiped)."""
        for j in range(self.n):
            if j != i:
                self.views[j] = self._merge(self.views[j], self.views[i])

    def wipe(self, i: int):
        """Replica i died: its view is gone."""
        self.views[i] = 0

    def catchup(self, i: int) -> int:
        """Rejoin: view i merges every survivor's; its recovered epoch."""
        merged = np.zeros((self.width,), np.int32)
        for j in range(self.n):
            if j != i:
                merged = self._merge(merged, self.views[j])
        self.views[i] = self._merge(self.views[i], merged)
        return self.epoch(i)

    def epoch(self, i: int) -> int:
        """Replica i's epoch in its own view."""
        return int(self._committed(self.views[i])[i])

    def epochs(self) -> list:
        """The merged epoch of every replica."""
        return [int(c) for c in self._committed(self._merged())]

    def state_of(self, i: int) -> Optional[str]:
        """Replica i's state in the merged log: its last committed
        entry."""
        e = self.epochs()[i]
        if e == 0:
            return None
        val = int(self._merged()[i * self.cfg.capacity + e - 1])
        return _STATE_NAMES.get(val, f"state{val}")


class _Replica:
    """One replica: its address, raw stubs (the router owns failover, so
    no client retries), health counters and in-flight gauge."""

    def __init__(self, index: int, address: str):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.healthy = False
        self.ever_down = False
        self.wiped = False
        self.consec_ok = 0
        self.consec_fail = 0
        self.inflight = 0
        self._connect(address)

    def _connect(self, address: str):
        from gossip_tpu_torch.rpc.sidecar import SidecarClient
        self.address = address
        self.client = SidecarClient(address, max_attempts=1)
        self.stubs = {"run": self.client._run,
                      "ensemble": self.client._ensemble,
                      "health": self.client._health,
                      "metrics": self.client._metrics}

    def close(self):
        try:
            self.client.close()
        except Exception:
            pass


class Router:
    """Health-gated failover dispatch over a replica set (module doc).
    ``start_probes()`` runs the prober thread; tests feed
    :meth:`observe_probe` directly."""

    def __init__(self, addresses: Sequence[str],
                 cfg: Optional[FleetConfig] = None):
        from gossip_tpu_torch.utils import telemetry
        if not addresses:
            raise ValueError("router needs at least one replica address")
        self.cfg = cfg or FleetConfig()
        self._lock = threading.Lock()
        self.replicas = [_Replica(i, a) for i, a in enumerate(addresses)]
        self.control = ControlPlane(len(self.replicas),
                                    self.cfg.control_capacity)
        self.counters = {"dispatched": 0, "failovers": 0, "sheds": 0,
                         "deadline_rejects": 0, "downs": 0, "ups": 0,
                         "catchups": 0}
        self.metrics = telemetry.MetricsWindow()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- health ---------------------------------------------------------------

    def observe_probe(self, r: _Replica, ok: bool):
        """One probe outcome into the hysteresis: re-admission after a
        down takes ``up_after`` consecutive healthy probes, the first
        admission one."""
        with self._lock:
            if ok:
                r.consec_fail = 0
                r.consec_ok += 1
                need = self.cfg.up_after if r.ever_down else 1
                if not r.healthy and r.consec_ok >= need:
                    self._mark_up_locked(r)
            else:
                r.consec_ok = 0
                r.consec_fail += 1
                if r.healthy and r.consec_fail >= self.cfg.down_after:
                    self._mark_down_locked(
                        r, f"{r.consec_fail} consecutive probe failures")

    def _control_append(self, index: int, state: int):
        """Record a transition; a full log is counted and ledgered, and
        the health gating goes on with the epochs frozen."""
        from gossip_tpu_torch.utils import telemetry
        try:
            return self.control.append(index, state)
        except ValueError as e:
            self.counters["control_plane_full"] = \
                self.counters.get("control_plane_full", 0) + 1
            telemetry.current().event(
                "control_plane_full", sync=False, replica=index,
                state=_STATE_NAMES.get(state, state),
                error=str(e).splitlines()[0][:200])
            return None

    def _mark_down_locked(self, r: _Replica, reason: str):
        from gossip_tpu_torch.utils import telemetry
        if not r.healthy:
            return
        r.healthy = False
        r.ever_down = True
        r.consec_ok = 0
        self.counters["downs"] += 1
        epoch = self._control_append(r.index, STATE_DOWN)
        telemetry.current().event(
            "replica_down", sync=False, replica=r.index,
            address=r.address, reason=reason, epoch=epoch)

    def _mark_up_locked(self, r: _Replica):
        from gossip_tpu_torch.utils import telemetry
        if r.wiped:
            # rejoin: catch up from the survivors' views
            epoch = self.control.catchup(r.index)
            r.wiped = False
            self.counters["catchups"] += 1
            telemetry.current().event(
                "control_catchup", sync=False, replica=r.index,
                epoch=epoch, epochs=self.control.epochs())
        r.healthy = True
        r.consec_fail = 0
        self.counters["ups"] += 1
        epoch = self._control_append(r.index, STATE_UP)
        telemetry.current().event(
            "replica_up", sync=False, replica=r.index,
            address=r.address, epoch=epoch)

    def mark_down(self, r: _Replica, reason: str):
        with self._lock:
            self._mark_down_locked(r, reason)

    def drain_replica(self, i: int, wait_s: float = 10.0) -> bool:
        """Take replica i out of rotation, then wait for its in-flight
        requests: True once none is left."""
        r = self.replicas[i]
        self.mark_down(r, "drain")
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._lock:
                if r.inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def replace_replica(self, i: int, address: str,
                        proc: Optional[subprocess.Popen] = None):
        """Replica i's process was replaced: point it at ``address``,
        push its view out and wipe it, and leave it down until the
        hysteresis re-admits it."""
        r = self.replicas[i]
        with self._lock:
            self._mark_down_locked(r, "replaced")
            r.close()
            r._connect(address)
            r.proc = proc
            r.consec_ok = r.consec_fail = 0
            self.control.flush(i)
            self.control.wipe(i)
            r.wiped = True
        return r

    # -- probing ---------------------------------------------------------------

    def _probe(self, r: _Replica) -> bool:
        import grpc
        try:
            r.stubs["health"](b"{}", timeout=self.cfg.probe_timeout_s)
            return True
        except (grpc.RpcError, ValueError):
            # ValueError: the channel was closed under the call
            return False

    def probe_once(self):
        for r in list(self.replicas):
            self.observe_probe(r, self._probe(r))
        with self._lock:
            self.control.gossip_tick()

    def start_probes(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="gossip-fleet-prober",
                                        daemon=True)
        self._thread.start()

    def _probe_loop(self):
        interval = self.cfg.probe_interval_ms / 1e3
        while not self._stop.wait(interval):
            self.probe_once()

    def wait_healthy(self, count: int, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.healthy_count() >= count:
                return True
            time.sleep(0.02)
        return False

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.healthy)

    def stats(self) -> dict:
        with self._lock:
            return {**self.counters,
                    "replicas": len(self.replicas),
                    "healthy": sum(1 for r in self.replicas if r.healthy),
                    "inflight": [r.inflight for r in self.replicas],
                    "epochs": self.control.epochs(),
                    "states": [self.control.state_of(i)
                               for i in range(len(self.replicas))]}

    # -- dispatch --------------------------------------------------------------

    def _pick(self, tried) -> Optional[_Replica]:
        """The least-loaded healthy replica not tried yet (ties to the
        lowest index), with an in-flight slot reserved."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.healthy and r.index not in tried
                     and r.inflight < self.cfg.max_inflight]
            if not cands:
                return None
            r = min(cands, key=lambda x: (x.inflight, x.index))
            r.inflight += 1
            self.counters["dispatched"] += 1
            return r

    def dispatch(self, method: str, payload: bytes, context) -> bytes:
        """Route one call with failover (module doc); refusals go through
        ``context.abort`` with a :class:`~gossip_tpu_torch.rpc.sidecar.
        StatusCode`.  The incoming trace id is stamped on every event and
        forwarded to the replica."""
        import grpc

        from gossip_tpu_torch.rpc import batcher as B
        from gossip_tpu_torch.rpc.sidecar import (StatusCode, trace_id_of,
                                                  trace_metadata)
        from gossip_tpu_torch.utils import telemetry
        deadline = B.deadline_of(context)
        trace_id = trace_id_of(context)
        metadata = trace_metadata(trace_id)
        t_start = time.monotonic()
        tried: list = []
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.counters["deadline_rejects"] += 1
                    telemetry.current().event(
                        "deadline_exceeded", sync=False, source="router",
                        method=method, tried=list(tried),
                        trace_id=trace_id)
                    context.abort(
                        StatusCode.DEADLINE_EXCEEDED,
                        "deadline expired before a replica could "
                        f"serve the request (tried {len(tried)} "
                        "replicas)")
            r = self._pick(tried)
            if r is None:
                with self._lock:
                    healthy = sum(1 for x in self.replicas if x.healthy)
                    inflight = [x.inflight for x in self.replicas]
                    self.counters["sheds"] += 1
                self.metrics.bump("sheds")
                reason = ("no healthy replica" if healthy == 0
                          else "all replicas at the in-flight cap")
                telemetry.current().event(
                    "shed", sync=False, method=method, reason=reason,
                    healthy=healthy, inflight=inflight, tried=list(tried),
                    trace_id=trace_id)
                context.abort(
                    StatusCode.RESOURCE_EXHAUSTED,
                    f"fleet shed: {reason} ({healthy}/"
                    f"{len(self.replicas)} healthy); back off and retry")
            if trace_id is not None:
                telemetry.current().event(
                    "dispatch_attempt", sync=False, trace_id=trace_id,
                    method=method, attempt=len(tried) + 1,
                    replica=r.index, consec_ok=r.consec_ok,
                    consec_fail=r.consec_fail,
                    remaining_s=(None if remaining is None
                                 else round(remaining, 3)))
            try:
                try:
                    reply = r.stubs[method](payload, timeout=remaining,
                                            metadata=metadata)
                finally:
                    with self._lock:
                        r.inflight -= 1
            except (grpc.RpcError, ValueError) as e:
                code = e.code() if callable(getattr(e, "code", None)) \
                    else None
                if code in (grpc.StatusCode.UNAVAILABLE,
                            grpc.StatusCode.CANCELLED) \
                        or isinstance(e, ValueError):
                    # the replica is gone (or its channel closed under
                    # the call): replay on a survivor, safe because a
                    # request is a pure function of its payload
                    self.mark_down(r, f"dispatch {method}: "
                                   f"{code or type(e).__name__}")
                    tried.append(r.index)
                    with self._lock:
                        self.counters["failovers"] += 1
                    self.metrics.bump("failovers")
                    telemetry.current().event(
                        "failover", sync=False, method=method,
                        from_replica=r.index, tried=list(tried),
                        remaining_s=(None if remaining is None
                                     else round(remaining, 3)),
                        trace_id=trace_id)
                    continue
                # a well-formed reply, or the client's deadline: as it is
                details = e.details() if callable(
                    getattr(e, "details", None)) else str(e)
                context.abort(StatusCode[getattr(code, "name", "UNKNOWN")],
                              details or str(code))
            proxy_ms = (time.monotonic() - t_start) * 1e3
            self.metrics.record(proxy_ms)
            if trace_id is not None:
                budget_s = None if deadline is None else deadline - t_start
                telemetry.current().event(
                    "request_trace", sync=False, trace_id=trace_id,
                    source="router", method=method, replica=r.index,
                    retries=len(tried), proxy_ms=round(proxy_ms, 1),
                    deadline_consumed=(
                        None if not budget_s
                        else round(proxy_ms / 1e3 / budget_s, 4)))
            return reply

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for r in self.replicas:
            r.close()


def serve_router(addresses: Sequence[str], port: int = 0,
                 max_workers: int = 16, cfg: Optional[FleetConfig] = None,
                 host: str = "127.0.0.1", start_probes: bool = True):
    """Start the router over ``addresses``: ``(server, bound port,
    router)``.  It serves the sidecar's ``gossip.Simulator`` service, so
    a :class:`~gossip_tpu_torch.rpc.sidecar.SidecarClient` calls it as it
    calls a replica; its ``Health`` reply is the fleet's summary and its
    ``Metrics`` reply its own window plus one row a replica.
    ``start_probes=False`` leaves probing to the caller
    (``router.probe_once()``)."""
    from gossip_tpu_torch.rpc.sidecar import SERVICE, generic_server
    router = Router(addresses, cfg)

    def health(request, context):
        s = router.stats()
        return json.dumps({
            "ok": s["healthy"] > 0, "router": True,
            "replicas": s["replicas"], "healthy": s["healthy"],
            "epochs": s["epochs"], "states": s["states"],
            "service": SERVICE}).encode()

    def metrics(request, context):
        s = router.stats()
        rows = []
        for r in list(router.replicas):
            row = {"replica": r.index, "address": r.address,
                   "healthy": r.healthy, "state": s["states"][r.index],
                   "epoch": s["epochs"][r.index],
                   "inflight": s["inflight"][r.index]}
            try:
                raw = r.stubs["metrics"](
                    b"{}", timeout=router.cfg.probe_timeout_s)
                row["metrics"] = json.loads(raw)
            except Exception as e:          # noqa: BLE001 -- a dead
                # replica's row says why
                row["error"] = (f"{type(e).__name__}: "
                                + str(e).splitlines()[0][:200]
                                if str(e) else type(e).__name__)
            rows.append(row)
        return json.dumps({
            "ok": s["healthy"] > 0, "router": True,
            "service": SERVICE, "role": "router",
            "replicas": s["replicas"], "healthy": s["healthy"],
            "window": router.metrics.snapshot(),
            "counters": {k: s[k] for k in
                         ("dispatched", "failovers", "sheds",
                          "deadline_rejects", "downs", "ups",
                          "catchups") if k in s},
            "fleet": rows}).encode()

    methods = {"Run": lambda req, ctx: router.dispatch("run", req, ctx),
               "Ensemble": lambda req, ctx: router.dispatch("ensemble", req,
                                                            ctx),
               "Health": health, "Metrics": metrics}
    try:
        server, bound = generic_server(methods, port, max_workers, host)
    except Exception:
        router.close()
        raise
    if start_probes:
        router.start_probes()
    server.gossip_router = router
    return server, bound, router


# -- spawned fleets ------------------------------------------------------------

def _start_replica(workdir: str, name: str, extra_argv=(),
                   env: Optional[dict] = None):
    """Start one replica process: ``(proc, stdout path, stderr path)``."""
    os.makedirs(workdir, exist_ok=True)
    out_path = os.path.join(workdir, name + ".out")
    err_path = os.path.join(workdir, name + ".err")
    argv = [sys.executable, "-m", "gossip_tpu_torch", "serve", "--port",
            "0", *extra_argv]
    with open(out_path, "wb") as fo, open(err_path, "wb") as fe:
        # a session of its own, so a kill reaches its mesh ranks too
        proc = subprocess.Popen(argv, stdout=fo, stderr=fe, env=env,
                                cwd=_REPO, start_new_session=True)
    return proc, out_path, err_path


def kill_replica(proc: subprocess.Popen) -> None:
    """SIGKILL a replica started by :func:`spawn_replica` and every
    process of its session (a ``serve --devices K`` replica's ranks),
    then reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _await_port(name: str, proc: subprocess.Popen, out_path: str,
                err_path: str, timeout_s: float = 90.0) -> int:
    """The port a started replica reports on its first JSON line."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(err_path, errors="replace") as f:
                err = f.read()
            raise RuntimeError(f"replica {name} died during startup "
                               f"rc={proc.returncode}:\n{err[-2000:]}")
        try:
            with open(out_path) as f:
                line = f.readline().strip()
            if line:
                return int(json.loads(line)["port"])
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.05)
    kill_replica(proc)
    raise RuntimeError(f"replica {name} did not report a port within "
                       f"{timeout_s}s")


def spawn_replica(workdir: str, name: str, extra_argv=(),
                  env: Optional[dict] = None, timeout_s: float = 90.0
                  ) -> Tuple[subprocess.Popen, int]:
    """Start one ``python -m gossip_tpu_torch serve --port 0`` replica
    and read its port from the command's first JSON line.  Its output
    goes to ``<workdir>/<name>.out`` / ``.err`` (files, never pipes: an
    undrained pipe would block a chatty child)."""
    proc, out_path, err_path = _start_replica(workdir, name, extra_argv,
                                              env)
    return proc, _await_port(name, proc, out_path, err_path, timeout_s)


def fleet_env(compile_cache_dir: Optional[str] = None) -> dict:
    """A replica's environment: the caller's, with this repository on
    ``PYTHONPATH`` and, optionally, a shared kernel store
    (``GOSSIP_COMPILE_CACHE``) so a respawned replica loads its
    predecessors' builds.  The reference's XLA platform pins and host
    device count have no counterpart: a replica takes its device from
    ``--device`` and its mesh width from :func:`replica_mesh_argv`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if compile_cache_dir is not None:
        env["GOSSIP_COMPILE_CACHE"] = compile_cache_dir
    return env


def replica_mesh_argv(devices: int, device: Optional[str] = None) -> list:
    """The ``serve`` flags a replica needs to serve a ``devices``-rank
    megabatch mesh on ``device`` (default CUDA): ``--devices K``, plus
    ``--share-card`` on a host with fewer cards than K (gloo ranks on one
    card); nothing for one device.  The port's counterpart of the
    reference's ``fleet_env(devices=K)`` (ROADMAP queue 3 item 8(g))."""
    if devices <= 1:
        return []
    argv = ["--devices", str(devices)]
    if (device or "cuda") == "cuda" and torch.cuda.device_count() < devices:
        argv.append("--share-card")
    return argv


def _verify_replica_devices(addr: str, name: str, want: int,
                            timeout_s: float = 30.0):
    """The devices-per-replica check: a freshly spawned replica must
    report, in its ``Health`` reply's ``serving_devices``, at least the
    mesh width the fleet requires, or this raises (the reference's
    words, with the port's remedy)."""
    if want <= 1:
        return
    from gossip_tpu_torch.rpc.sidecar import SidecarClient
    client = SidecarClient(addr)
    try:
        h = client.health(timeout=timeout_s)
    finally:
        client.close()
    got = int(h.get("serving_devices", h.get("devices", 1)))
    if got < want:
        raise RuntimeError(
            f"replica {name} at {addr} reports serving_devices={got} "
            f"but the fleet requires devices_per_replica={want} — the "
            "megabatch mesh silently degraded; spawn children with serve "
            "--devices K (and --share-card where the host has fewer "
            "cards than K: replica_mesh_argv)")


class Fleet:
    """N spawned replicas behind a served router (the ``route``
    command's).  ``kill(i)`` SIGKILLs replica i; ``restart(i)`` spawns a
    replacement on a fresh port, which the hysteresis re-admits after a
    control-plane catch-up.  With ``cfg.devices_per_replica`` above 1
    every spawn and respawn goes through :func:`_verify_replica_devices`,
    and a narrower replica is killed before the fleet raises."""

    def __init__(self, n: Optional[int] = None,
                 cfg: Optional[FleetConfig] = None,
                 workdir: Optional[str] = None, replica_argv=(),
                 env: Optional[dict] = None, port: int = 0,
                 max_workers: int = 16):
        self.cfg = cfg or FleetConfig()
        n = self.cfg.replicas if n is None else n
        if workdir is None:
            import tempfile
            workdir = tempfile.mkdtemp(prefix="gossip_fleet_")
        self.workdir = workdir
        self.replica_argv = tuple(replica_argv)
        self.env = env if env is not None else fleet_env()
        self._gen = [0] * n
        procs, addrs = [], []
        try:
            # every replica starts at once (each start-up is mostly its
            # imports and its device), then each one's port is read
            started = []
            for i in range(n):
                started.append(_start_replica(workdir, f"r{i}_g0",
                                              self.replica_argv, self.env))
                procs.append(started[-1][0])
            for i, (proc, out_path, err_path) in enumerate(started):
                rport = _await_port(f"r{i}_g0", proc, out_path, err_path)
                addrs.append(f"127.0.0.1:{rport}")
                _verify_replica_devices(addrs[-1], f"r{i}_g0",
                                        self.cfg.devices_per_replica)
            self.server, self.port, self.router = serve_router(
                addrs, port=port, max_workers=max_workers, cfg=self.cfg)
        except Exception:
            for p in procs:
                kill_replica(p)
            raise
        for i, proc in enumerate(procs):
            self.router.replicas[i].proc = proc

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def kill(self, i: int) -> int:
        """SIGKILL replica i; its pid."""
        r = self.router.replicas[i]
        if r.proc is None or r.proc.poll() is not None:
            raise ValueError(f"replica {i} has no live process")
        pid = r.proc.pid
        kill_replica(r.proc)
        return pid

    def restart(self, i: int) -> str:
        """Spawn a replacement for replica i on a fresh port."""
        self._gen[i] += 1
        name = f"r{i}_g{self._gen[i]}"
        proc, rport = spawn_replica(self.workdir, name, self.replica_argv,
                                    self.env)
        addr = f"127.0.0.1:{rport}"
        try:
            _verify_replica_devices(addr, name,
                                    self.cfg.devices_per_replica)
        except Exception:
            # a narrower replacement never joins the rotation
            kill_replica(proc)
            raise
        self.router.replace_replica(i, addr, proc)
        return addr

    def close(self):
        self.server.stop(grace=None)
        self.router.close()
        for r in self.router.replicas:
            if r.proc is not None and r.proc.poll() is None:
                kill_replica(r.proc)
