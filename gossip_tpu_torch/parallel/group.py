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
* **Launch.**  A :class:`Pool` spawns K ranks (``torch.multiprocessing``,
  spawn context) joined through a ``file://`` store in a fresh temporary
  directory, never a fixed port, keeps them for its whole lifetime and
  feeds them one job at a time (the serving batcher's request-axis mesh);
  :func:`launch` is one job of a pool of its own.  A rank that fails
  makes the job raise with that rank's error, and a rank ends when its
  spawner does.  The caller stays outside the group.  Inside a group
  that is already up (``torchrun``), :func:`current` is this process's
  rank; :func:`local` opens a one-rank group in this process.
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
import threading
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


def _rank_error(rank: int, payload):
    """A rank's reported error as the caller raises it: a ``ValueError``
    as itself, anything else as a ``RuntimeError`` with the rank's
    traceback."""
    kind, msg, tb = payload
    if kind == "ValueError":
        return ValueError(msg)
    return RuntimeError(f"rank {rank} failed: {kind}: {msg}\n{tb}")


def _error(e: BaseException) -> tuple:
    return type(e).__name__, str(e), traceback.format_exc()


def _watch_parent() -> None:
    """End this rank as soon as the process that spawned it is gone (its
    sentinel pipe closes), whatever the rank is doing: a SIGKILLed or
    SIGTERMed launcher leaves no rank behind."""
    import multiprocessing
    parent = multiprocessing.parent_process()
    if parent is None:
        return

    def watch():
        parent.join()
        os._exit(1)
    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def _pool_main(rank, size, backend, device, init_method, jobs, results,
               threads, ledger):
    """One rank of a :class:`Pool`: continue the launcher's run ledger
    (``ledger``: rank 0 writes, the others are peers:
    :func:`~gossip_tpu_torch.utils.telemetry.adopt`), join the group
    once, report ready (job id -1), then run each job ``(i, fn, args,
    kwargs)`` from ``jobs`` until a None arrives, sending ``(i, rank, ok,
    payload)``.  A failed start-up is reported under job id None."""
    from gossip_tpu_torch.utils import telemetry
    _watch_parent()
    if threads:
        torch.set_num_threads(threads)
    try:
        telemetry.adopt(ledger, rank)
        group = _init(rank, size, backend, torch.device(device), init_method)
    except BaseException as e:      # noqa: BLE001 - sent to the pool
        results.put((None, rank, False, _error(e)))
        return
    results.put((-1, rank, True, b""))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            i, fn, args, kwargs = job
            try:
                out = fn(*args, group=group, **kwargs)
                # pickled to bytes here: a tensor sent as itself would
                # travel as shared memory that dies with this process
                results.put((i, rank, True, pickle.dumps(_to_host(out))))
            except BaseException as e:      # noqa: BLE001 - sent back
                results.put((i, rank, False, _error(e)))
    finally:
        dist.destroy_process_group()


def launch(fn, size: int, *args, device=None, shared_card: bool = False,
           **kwargs) -> List:
    """Run ``fn(*args, group=<Group>, **kwargs)`` on ``size`` spawned
    ranks and return their results in rank order: one job of a
    :class:`Pool` started for it.  ``fn`` must be a module-level function
    (it is pickled by name); its result comes back with every tensor on
    the CPU.  The first rank that raises makes this raise (a
    ``ValueError`` as itself, anything else as a ``RuntimeError`` with
    the rank's traceback) and ends every rank.  Under a run ledger, rank
    0 writes into it and the other ranks write nothing."""
    pool = Pool(size, device, shared_card, split_threads=False)
    try:
        out = pool._job(fn, args, kwargs, first_error=True)
    except BaseException:
        pool._teardown("the job failed")
        raise
    pool.close()
    return out


class Pool:
    """K spawned ranks kept for the pool's lifetime, on the devices
    :func:`plan` gives (gloo on the CPU or on one shared card, NCCL with
    a card a rank), fed one job at a time.

    :meth:`run` hands every rank ``fn(*args, group=<Group>, **kwargs)``
    and returns their results in rank order, under :func:`launch`'s
    rules: a rank's ``ValueError`` comes back as itself, anything else as
    a ``RuntimeError`` with the rank's traceback.  When every rank
    answers, errors included, the group is intact and the pool serves
    the next job.  When one does not (it exited, or the others were left
    in a collective for :data:`ERROR_GRACE_S` after a rank's error), the
    pool tears every rank down and raises; each later job raises too.
    Construction waits until every rank has joined the group
    (:data:`START_TIMEOUT_S` at most), and refuses more ranks than cards
    as :func:`plan` does.  :meth:`close` stops the ranks and leaves no
    live child; a rank also ends by itself when this process is gone.
    Under a run ledger, rank 0 writes into it and the other ranks write
    nothing, as under :func:`launch`.  CPU ranks split this process's
    intra-op threads between them unless ``split_threads`` is False."""

    ERROR_GRACE_S = 10.0
    START_TIMEOUT_S = 300.0

    def __init__(self, size: int, device=None, shared_card: bool = False,
                 split_threads: bool = True):
        import torch.multiprocessing as mp

        from gossip_tpu_torch.utils import telemetry
        backend, devices = plan(size, device, shared_card)
        self.size, self.backend, self.devices = size, backend, devices
        self.down: Optional[str] = None     # why the ranks were torn down
        self._lock = threading.Lock()
        self._next = 0
        self._tmp = tempfile.mkdtemp(prefix="gossip_pool_")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        threads = (max(1, torch.get_num_threads() // size)
                   if split_threads and devices[0].type == "cpu" else None)
        ledger = telemetry.handoff()
        init_method = "file://" + os.path.join(self._tmp, "store")
        self._procs = [ctx.Process(target=_pool_main, daemon=True,
                                   args=(r, size, backend, str(devices[r]),
                                         init_method, self._jobs[r],
                                         self._results, threads, ledger))
                       for r in range(size)]
        for p in self._procs:
            p.start()
        try:
            self._collect(-1, self.START_TIMEOUT_S)
        except BaseException:
            self._teardown("start-up failed")
            raise

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def alive(self) -> bool:
        """Every rank is up and the pool is open."""
        return self.down is None and all(p.is_alive() for p in self._procs)

    def _collect(self, i: int, timeout: Optional[float],
                 first_error: bool = False) -> List:
        """Every rank's answer to job ``i`` (class rules above); with
        ``first_error``, the first rank's error is raised at once."""
        got: Dict[int, object] = {}
        errs: Dict[int, tuple] = {}
        t0 = time.monotonic()
        first_err = None
        while len(got) + len(errs) < self.size:
            try:
                j, rank, ok, payload = self._results.get(timeout=0.2)
            except queue.Empty:
                now = time.monotonic()
                gone = [r for r, p in enumerate(self._procs)
                        if r not in got and r not in errs
                        and p.exitcode is not None]
                if gone:
                    raise RuntimeError(
                        f"rank {gone[0]} of the pool exited with code "
                        f"{self._procs[gone[0]].exitcode} before it "
                        "reported")
                if first_err is not None and \
                        now - first_err > self.ERROR_GRACE_S:
                    r = min(errs)
                    raise RuntimeError(
                        f"rank {r} failed and the others did not answer "
                        f"within {self.ERROR_GRACE_S:.0f} s: "
                        f"{_rank_error(r, errs[r])}")
                if timeout is not None and now - t0 > timeout:
                    raise RuntimeError(
                        f"the pool's ranks did not answer within "
                        f"{timeout:.0f} s ({len(got) + len(errs)}/"
                        f"{self.size} did)")
                continue
            if j is None:
                raise _rank_error(rank, payload)
            if j != i:
                continue
            if ok:
                got[rank] = payload
            elif first_error:
                raise _rank_error(rank, payload)
            else:
                errs[rank] = payload
                first_err = first_err or time.monotonic()
        if errs:
            r = min(errs)
            raise _rank_error(r, errs[r])
        return [got[r] for r in range(self.size)]

    def run(self, fn, *args, **kwargs) -> List:
        """``fn(*args, group=<Group>, **kwargs)`` on every rank: the
        results in rank order (class doc).  ``fn`` must be a module-level
        function; its result comes back with every tensor on the CPU."""
        return self._job(fn, args, kwargs)

    def _job(self, fn, args, kwargs, first_error: bool = False) -> List:
        with self._lock:
            if self.down is not None:
                raise RuntimeError(f"the rank pool is down: {self.down}")
            i, self._next = self._next, self._next + 1
            for q in self._jobs:
                q.put((i, fn, args, kwargs))
            try:
                out = self._collect(i, None, first_error)
            except ValueError:
                if not self.alive():
                    self._teardown("a rank failed")
                raise
            except BaseException as e:
                self._teardown(str(e).splitlines()[0] if str(e)
                               else type(e).__name__)
                raise
            return [pickle.loads(p) for p in out]

    def _teardown(self, why: str) -> None:
        import shutil
        self.down = self.down or why
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for q in self._jobs + [self._results]:
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def close(self) -> None:
        """Stop every rank (a None job each, then a join; a rank that
        does not stop within 30 s is killed).  Idempotent."""
        with self._lock:
            if self.down is None:
                for q in self._jobs:
                    q.put(None)
                for p in self._procs:
                    p.join(timeout=30)
            self._teardown("closed")


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
