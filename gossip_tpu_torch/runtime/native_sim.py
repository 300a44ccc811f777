"""ctypes wrapper presenting the C++ event core with the GoNativeSim API
(``runtime/gonative.py`` is the semantics contract).

``make_event_sim(topology, net, horizon, prefer_native=True)`` returns the
C++ core, or raises where it cannot be built (``native.load_eventsim``);
the Python engine runs only when the caller asks for it with
``prefer_native=False``.  The reference's factory falls back to the Python
engine without a compiler; the port's does not.  Both engines expose the
subset of the GoNativeSim surface the backend and the parity tests use:
``partition``, ``broadcast``, ``run``, ``read``, ``hop_depths``,
``coverage_by_hop``, ``coverage_at``, ``msgs_sent``, ``now``, ``nodes``
(seen-sets).  Equivalence between the two engines is held event for event
in tests/test_torch_gonative.py.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from gossip_tpu_torch.runtime.gonative import GoNativeSim, NetConfig


class _SeenView:
    """Duck-types GoNativeNode for `msg in sim.nodes[i].seen` checks."""

    __slots__ = ("_sim", "_nid")

    def __init__(self, sim, nid):
        self._sim = sim
        self._nid = nid

    @property
    def seen(self):
        return set(self._sim.read(self._nid))

    @property
    def log(self):
        return self._sim.read(self._nid)


class NativeGoSim:
    """C++-backed event simulator (see gossip_tpu_torch/native/eventsim.cpp)."""

    def __init__(self, topology: Dict[int, List[int]],
                 net: NetConfig = NetConfig(), horizon: float = 120.0):
        from gossip_tpu_torch.native import load_eventsim
        lib = load_eventsim()
        self._lib = lib
        self.net = net
        self.horizon = horizon
        self.n = (max(topology) + 1) if topology else 0
        self._h = lib.gsim_create(self.n)
        lib.gsim_config(self._h, net.latency, net.rpc_timeout,
                        net.backoff_base, int(net.faithful_ctx_bug),
                        net.max_backoff_doublings, horizon)
        for node, nbrs in topology.items():
            arr = (ctypes.c_int32 * len(nbrs))(*nbrs)
            lib.gsim_set_neighbors(self._h, node, arr, len(nbrs))
        self.nodes = {i: _SeenView(self, i) for i in range(self.n)}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gsim_destroy(self._h)
            self._h = None

    # -- GoNativeSim API --------------------------------------------------

    def partition(self, a: int, b: int, t0: float, t1: float) -> None:
        self._lib.gsim_partition(self._h, a, b, t0, t1)

    def broadcast(self, origin: int, message: int, t: float = 0.0) -> None:
        self._lib.gsim_broadcast(self._h, origin, message, t)

    def run(self, until: Optional[float] = None) -> None:
        self._lib.gsim_run(self._h, -1.0 if until is None else until)

    @property
    def msgs_sent(self) -> int:
        return int(self._lib.gsim_msgs_sent(self._h))

    @property
    def now(self) -> float:
        return float(self._lib.gsim_now(self._h))

    @property
    def deliveries(self):
        cnt = self._lib.gsim_delivery_count(self._h)
        times = (ctypes.c_double * cnt)()
        nodes = (ctypes.c_int32 * cnt)()
        msgs = (ctypes.c_int64 * cnt)()
        hops = (ctypes.c_int32 * cnt)()
        self._lib.gsim_deliveries(self._h, times, nodes, msgs, hops)
        return [(times[i], nodes[i], msgs[i], hops[i]) for i in range(cnt)]

    def read(self, node: int) -> List[int]:
        ln = self._lib.gsim_read_len(self._h, node)
        out = (ctypes.c_int64 * ln)()
        self._lib.gsim_read(self._h, node, out)
        return list(out)

    def delivery_count(self) -> int:
        return int(self._lib.gsim_delivery_count(self._h))

    def hop_depths(self, message: int) -> Dict[int, int]:
        out = {}
        for i in range(self.n):
            h = self._lib.gsim_min_hop(self._h, i, message)
            if h >= 0:
                out[i] = h
        return out

    def coverage_by_hop(self, message: int, max_hops: int) -> List[float]:
        depths = self.hop_depths(message)
        return [sum(1 for d in depths.values() if d <= h) / self.n
                for h in range(max_hops + 1)]

    def coverage_at(self, message: int, t: float) -> float:
        holders = {nid for (tt, nid, m, _) in self.deliveries
                   if m == message and tt <= t}
        return len(holders) / self.n


def make_event_sim(topology: Dict[int, List[int]],
                   net: NetConfig = NetConfig(), horizon: float = 120.0,
                   prefer_native: bool = True):
    """The C++ core (raising where it cannot be built), or with
    ``prefer_native=False`` the Python engine."""
    if prefer_native:
        return NativeGoSim(topology, net, horizon)
    return GoNativeSim(topology, net, horizon)
