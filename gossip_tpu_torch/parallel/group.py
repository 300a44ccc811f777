"""The node mesh of the port: one process per rank over ``torch.distributed``.

The port of the JAX package's ``make_mesh`` and of the ``Mesh`` its
sharded drivers take (``gossip_tpu/parallel/sharded.py``).  The reference
drives K devices from one process with ``shard_map``; PyTorch's idiom is
one process per rank, so a :class:`Group` is one rank's view of the mesh:
its rank, the world size, its device, the backend, and the collectives
the drivers use.

* **Backend.**  NCCL when every rank has a card of its own; gloo when the
  caller asks for the CPU, and when the ranks share one card
  (``MeshConfig.shared_card``: NCCL refuses two ranks on one GPU).  Gloo
  carries CUDA tensors through every collective used here; it copies them
  through the host itself.  The report's meta names the backend.
* **Launch.**  :func:`launch` spawns K ranks (``torch.multiprocessing``,
  spawn context) joined through a ``file://`` store in a fresh temporary
  directory, never a fixed port, and returns every rank's result; a rank
  that fails makes it raise with that rank's error.  Inside a group that
  is already up (``torchrun``), :func:`current` is this process's rank;
  :func:`local` opens a one-rank group in this process.
* **Row split.**  Nodes pad to a multiple of K (:func:`pad_to_mesh`); rank
  r holds the rows ``[r * nl, (r + 1) * nl)`` (:meth:`Group.rows`).
  Padding rows are dead: they never sample, send or receive, and no
  coverage counts them.
* **Collectives**, on int32 words (the reference's uint32 bits: gloo
  refuses ``uint32``) and bytes: :meth:`Group.all_gather` is the
  reference's ``all_gather(tiled=True)``, :meth:`Group.reduce_scatter_sum`
  its ``psum_scatter``, :meth:`Group.all_reduce_sum` an integer ``psum``,
  :meth:`Group.all_reduce_max` its ``pmax`` (SWIM's wire merge),
  :meth:`Group.all_reduce_min` its ``pmin`` (the fused planes' stop
  test),
  :meth:`Group.combine_f32` its float32 ``psum`` of ``msgs`` and
  ``lost``: the K partials gathered and added in rank order
  (:func:`~gossip_tpu_torch.ops.common.rank_order_sum`, the float32 rule
  of :mod:`gossip_tpu_torch.ops.common`), :meth:`Group.all_to_all` its
  ``all_to_all(tiled=False)`` (the sparse exchange's requests and
  responses) and :meth:`Group.ppermute` its ``ppermute`` by a ring shift
  (the halo exchange's boundary rows).  Both of the last two are one
  ``all_to_all_single``, which NCCL and gloo carry alike; ``ppermute``
  gives it uneven splits (the rows to one rank, nothing to the others).
  Each collective's device time is kept per name
  (:meth:`Group.collective_ms`).  A group is the world's ranks unless
  it holds a sub-group's handle (``pg``, from ``dist.new_group``:
  :func:`gossip_tpu_torch.parallel.multislice.make_hybrid_mesh`), which
  every collective passes on; ``rank`` and ``size`` are then the
  sub-group's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from gossip_tpu_torch.ops.common import rank_order_sum, resolve_device

# The tiled collectives; newer torch renames them (``*_single``) and warns
# on the old names, which older torch alone has.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# A rank waits this long in a collective before it gives up; the launcher
# ends every rank as soon as one fails, long before.
TIMEOUT = datetime.timedelta(minutes=20)


def pad_to_mesh(n: int, size: int) -> int:
    """The node count padded to a multiple of the mesh size."""
    return -(-n // size) * size


def pad_rows(x: torch.Tensor, n_pad: int, fill) -> torch.Tensor:
    """``x`` with rows of ``fill`` appended up to ``n_pad`` rows."""
    n = x.shape[0]
    if n == n_pad:
        return x
    tail = torch.full((n_pad - n,) + tuple(x.shape[1:]), fill,
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


@dataclasses.dataclass
class Group:
    """One rank of the mesh: its place, its device, the backend, and the
    device time its collectives took."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Optional[object] = None     # the process group; None: the world
    _spans: Dict[str, list] = dataclasses.field(default_factory=dict,
                                                repr=False)

    def rows(self, n: int):
        """``(n_pad, nl, lo)``: the padded node count, the rows a rank
        holds, and this rank's first row."""
        n_pad = pad_to_mesh(n, self.size)
        nl = n_pad // self.size
        return n_pad, nl, self.rank * nl

    def _run(self, name: str, fn):
        """``fn()`` with its device time (CUDA events, read later) or host
        time (the CPU's collectives block) kept under ``name``."""
        spans = self._spans.setdefault(name, [])
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            spans.append((start, stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            spans.append(time.perf_counter() - t0)
        return out

    def collective_ms(self, reset: bool = False) -> Dict[str, dict]:
        """``{name: {"calls": c, "ms": total}}`` since the last reset."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for name, spans in self._spans.items():
            ms = sum(sp[0].elapsed_time(sp[1]) if isinstance(sp, tuple)
                     else sp * 1e3 for sp in spans)
            out[name] = {"calls": len(spans), "ms": ms}
        if reset:
            self._spans.clear()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size * nl, ...]``: every rank's rows in rank order (bool
        rows travel as bytes)."""
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty((self.size * wire.shape[0],) + tuple(
            wire.shape[1:]), dtype=wire.dtype, device=wire.device)
        self._run("all_gather",
                  lambda: _ALL_GATHER(out, wire, group=self.pg))
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``[nl, ...]``: this rank's rows of the sum over ranks of
        ``x`` ``[size * nl, ...]``."""
        src = x.contiguous()
        out = torch.empty((src.shape[0] // self.size,) + tuple(
            src.shape[1:]), dtype=src.dtype, device=src.device)
        self._run("reduce_scatter",
                  lambda: _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM,
                                          group=self.pg))
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The integer sum over ranks of ``x``, on every rank."""
        out = x.clone()
        self._run("all_reduce", lambda: dist.all_reduce(out, group=self.pg))
        return out

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ranks of ``x``, on every rank (the
        reference's ``pmax``)."""
        out = x.contiguous().clone()
        self._run("all_reduce_max",
                  lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX,
                                          group=self.pg))
        return out

    def all_reduce_min(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise min over ranks of ``x``, on every rank (the
        fused planes' stop test: the least count of any rank's
        planes)."""
        out = x.contiguous().clone()
        self._run("all_reduce_min",
                  lambda: dist.all_reduce(out, op=dist.ReduceOp.MIN,
                                          group=self.pg))
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x[d]`` (``x`` of shape ``[size, cap, ...]``) goes to rank d;
        ``out[s]`` is what rank s sent here (bool rows travel as
        bytes)."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.size}, got shape {tuple(x.shape)}")
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty_like(wire)
        self._run("all_to_all",
                  lambda: dist.all_to_all_single(out, wire, group=self.pg))
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """``x`` goes to rank ``(rank + shift) mod size``; the result is
        what rank ``(rank - shift) mod size`` sent, of ``x``'s shape (bool
        rows travel as bytes)."""
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty_like(wire)
        rows = wire.shape[0]
        send = [0] * self.size
        recv = [0] * self.size
        send[(self.rank + shift) % self.size] = rows
        recv[(self.rank - shift) % self.size] = rows
        self._run("ppermute",
                  lambda: dist.all_to_all_single(out, wire, recv, send,
                                                 group=self.pg))
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def barrier(self) -> None:
        """Wait until every rank gets here (a one-word all-reduce, which
        NCCL and gloo carry alike)."""
        self.all_reduce_sum(torch.zeros(1, dtype=torch.int32,
                                        device=self.device)).cpu()

    def combine_f32(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's float32 ``psum`` of ``x``: the ranks' partials
        added in rank order in float32, the same value on every rank."""
        parts = self.all_gather(x.to(torch.float32).reshape(1, -1))
        return rank_order_sum(parts).reshape(x.shape)


def plan(size: int, device=None, shared_card: bool = False):
    """``(backend, per-rank devices)`` of a K-rank launch on ``device``
    (default CUDA): gloo on the CPU or on one shared card, else NCCL with
    one card a rank; more ranks than cards are refused in the reference's
    words (``make_mesh``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu" or shared_card:
        return "gloo", [dev] * size
    have = torch.cuda.device_count()
    if size > have:
        raise ValueError(f"requested {size} devices, only {have} available")
    return "nccl", [torch.device("cuda", r) for r in range(size)]


def _init(rank: int, size: int, backend: str, dev: torch.device,
          init_method: str) -> Group:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank, timeout=TIMEOUT,
                            **kw)
    return Group(rank, size, dev, backend)


def _to_host(x):
    """A result with every tensor moved to the CPU, so it can be sent."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, size, backend, device, init_method, fn, args, kwargs,
               results, ledger=None):
    """One spawned rank: join the group, run ``fn(*args, group=...)``,
    send its result (or its error) to the launcher.  ``ledger`` is the
    launcher's run ledger hand-off (rank 0 writes, the others are peers:
    :func:`~gossip_tpu_torch.utils.telemetry.adopt`)."""
    from gossip_tpu_torch.utils import telemetry
    try:
        telemetry.adopt(ledger, rank)
        group = _init(rank, size, backend, torch.device(device),
                      init_method)
        out = fn(*args, group=group, **kwargs)
        # pickled to bytes here: a tensor sent as itself would travel as
        # shared memory that dies with this process
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException as e:      # noqa: BLE001 - sent to the launcher
        results.put((rank, False, (type(e).__name__, str(e),
                                   traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, size: int, *args, device=None, shared_card: bool = False,
           **kwargs) -> List:
    """Run ``fn(*args, group=<Group>, **kwargs)`` on ``size`` spawned
    ranks and return their results in rank order.  ``fn`` must be a
    module-level function (it is pickled by name); its result comes back
    with every tensor on the CPU.  A rank that raises makes this raise:
    a ``ValueError`` as itself, anything else as a ``RuntimeError`` with
    the rank's traceback.  Under a run ledger, rank 0 writes into it
    and the other ranks write nothing."""
    import torch.multiprocessing as mp

    from gossip_tpu_torch.utils import telemetry
    backend, devices = plan(size, device, shared_card)
    ledger = telemetry.handoff()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="gossip_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, size, backend, str(devices[r]),
                                   init_method, fn, args, kwargs, results,
                                   ledger))
                 for r in range(size)]
        for p in procs:
            p.start()
        got: Dict[int, object] = {}
        try:
            while len(got) < size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if gone:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} before it reported")
                    continue
                if not ok:
                    kind, msg, tb = payload
                    if kind == "ValueError":
                        raise ValueError(msg)
                    raise RuntimeError(f"rank {rank} failed: {kind}: {msg}"
                                       f"\n{tb}")
                got[rank] = pickle.loads(payload)
            for p in procs:
                p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [got[r] for r in range(size)]


def current(device=None) -> Group:
    """This process's rank of a group that is already up (``torchrun``):
    NCCL ranks take ``cuda:LOCAL_RANK``; gloo ranks ``device`` (default
    CUDA)."""
    if not dist.is_initialized():
        raise ValueError("no process group is up; launch() or local() one")
    backend = dist.get_backend()
    rank, size = dist.get_rank(), dist.get_world_size()
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    return Group(rank, size, dev, backend)


@contextlib.contextmanager
def local(device=None):
    """A one-rank group in this process on ``device`` (default CUDA):
    NCCL on a card, gloo on the CPU.  The group is torn down on exit."""
    backend, (dev,) = plan(1, device)
    with tempfile.TemporaryDirectory(prefix="gossip_mesh_") as tmp:
        group = _init(0, 1, backend, dev,
                      "file://" + os.path.join(tmp, "store"))
        try:
            yield group
        finally:
            dist.destroy_process_group()


def peak_memory(group: Group) -> Optional[List[int]]:
    """Every rank's peak allocated device memory in bytes, in rank order
    (None on the CPU)."""
    if group.device.type != "cuda":
        return None
    mine = torch.tensor([torch.cuda.max_memory_allocated(group.device)],
                        dtype=torch.int64, device=group.device)
    return group.all_gather(mine).tolist()
