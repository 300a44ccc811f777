"""Build, bind and launch the port's hand-written CUDA kernels.

Each kernel source under ``gossip_tpu_torch/csrc/`` has a plain C entry
point.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``gossip_tpu_torch/_build/`` (named by a hash of
the source, every ``csrc/`` header it includes and the flags, so an
edited source or header never loads a stale build) and bound with
``ctypes``.  A wrapper checks device, dtype, shape and
contiguity, launches on PyTorch's current stream, raises if the entry
point returns an error, and counts its launches twice: in a plain
process-wide integer (``Kernel.launches``) and in a tally of the calling
thread (:func:`thread_launches`), so a run report counts its own
launches only.  In a serving process the device lock
(``rpc/batcher.DEVICE_LOCK``) already makes the global difference
per-call; the tally is for library callers that run drivers from
several threads without that lock.
:func:`build_all` builds under one process-wide lock: two first requests
never start ``nvcc`` on the same library twice.

Nothing here is built or launched for a CPU tensor; a build starts at
the first launch (or :func:`build_all`), never at import.

The library store is the port's only build cache (the counterpart of the
reference's XLA executable store): :func:`build_dir` is the directory
set by :func:`set_build_dir` (the commands' ``--compile-cache DIR``), else
``$GOSSIP_COMPILE_CACHE`` when it names one, else ``_build/``;
:func:`use_fresh_build_dir` (``--no-compile-cache``) builds into a new
temporary directory removed at exit, so every build is a cold ``nvcc``.
Each library built or loaded writes one ``kernel_build`` event to the
ambient run ledger: ``kernel``, ``library``, ``cache``
(``hit|miss|disabled``) and ``build_s``.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
CACHE_ENV = "GOSSIP_COMPILE_CACHE"
_STORE = {"dir": None, "fresh": False}
_BUILD_LOCK = threading.Lock()
_BUILD_EVENTS = [0]       # kernel_build events written by this process
_TALLY = threading.local()


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from
    (module doc)."""
    if _STORE["dir"] is not None:
        return _STORE["dir"]
    env = os.environ.get(CACHE_ENV)
    return Path(env) if env else BUILD_DIR


def set_build_dir(path) -> Path:
    """Build into and load from ``path`` from now on (not yet loaded
    kernels only); the environment variable is set too, so spawned ranks
    use the same store."""
    _STORE["dir"], _STORE["fresh"] = Path(path).resolve(), False
    os.environ[CACHE_ENV] = str(_STORE["dir"])
    return _STORE["dir"]


def use_fresh_build_dir() -> Path:
    """Build into a new temporary directory, removed at exit: the cache
    is off, every library a cold ``nvcc`` build (``cache``
    ``disabled``)."""
    tmp = tempfile.mkdtemp(prefix="gossip_kernels_")
    atexit.register(shutil.rmtree, tmp, True)
    set_build_dir(tmp)
    _STORE["fresh"] = True
    return _STORE["dir"]




def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


class Kernel:
    """One CUDA source and its C entry point.  ``launches`` counts the
    wrapper's launches; ``build_s`` is the first-use build and load time
    (None before), ``ptxas`` the compiler's register report."""

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_s = None
        self.ptxas = ""
        self._fn = None

    def sources(self):
        """The source and every file it includes with ``#include "..."``,
        transitively (all under ``csrc/``), each once, in a fixed order."""
        found, todo = set(), [self.source]
        while todo:
            path = todo.pop()
            if path not in found:
                found.add(path)
                todo += [CSRC / name
                         for name in _INCLUDE.findall(path.read_text())]
        return sorted(found)

    def library(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.sources():
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        return build_dir() / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source; None when the library is built.
        The output lands under a private name and is renamed into place,
        so concurrent builds never load a half-written file."""
        lib = self.library()
        if lib.exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

    def finish_build(self, started, t0: float):
        if started is not None:
            proc, tmp, lib = started
            self.ptxas = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                                   f"{self.ptxas}")
            os.replace(tmp, lib)
        fn = getattr(ctypes.CDLL(str(self.library())), self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        self.build_s = time.perf_counter() - t0

    def fn(self):
        if self._fn is None:
            build_all([self])
        return self._fn

    def entry_point(self, entry: str, argtypes):
        """Another C entry point of this kernel's build, one that launches
        nothing (it is not counted)."""
        self.fn()
        fn = getattr(ctypes.CDLL(str(self.library())), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


FUSED_ROUND = Kernel(
    "fused_round", "fused_round.cu", "fused_round_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _U, _U, _U, _I, _P])
FUSED_MR_ROUND = Kernel(
    "fused_mr_round", "fused_mr_round.cu", "fused_mr_round_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _I, _P])
MR_GATHER = Kernel(
    "mr_gather", "mr_gather.cu", "mr_gather_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _I, _P])
SAMPLER = Kernel(
    "sampler", "sampler.cu", "sampler_launch",
    [_P, _P, ctypes.c_ulonglong, _U, _U, _I, _U, _P])
# the roofline's three calibration microkernels: one source, three entry
# points, one build (build_all)
CAL_PRNG = Kernel("cal_prng", "calibrate.cu", "cal_prng_launch",
                  [_P, _P, _I, _U, _U, _P])
CAL_PRNG_GATHER = Kernel("cal_prng_gather", "calibrate.cu",
                         "cal_prng_gather_launch", [_P, _P, _I, _U, _U, _P])
CAL_VPU = Kernel("cal_vpu", "calibrate.cu", "cal_vpu_launch",
                 [_P, _I, _U, _P])
# the kernels a run launches (a run report counts these), and all of them
ROUND_KERNELS = (FUSED_ROUND, FUSED_MR_ROUND, MR_GATHER, SAMPLER)
KERNELS = ROUND_KERNELS + (CAL_PRNG, CAL_PRNG_GATHER, CAL_VPU)
# measurement variants of the value kernel's operand path (chip_smoke.py's
# mr_parts phase); no run launches them
FUSED_MR_PARTS = Kernel(
    "fused_mr_parts", "fused_mr_parts.cu", "fused_mr_parts_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _I, _P])
MR_MAX_FANOUT = 64        # the value kernel keeps fanout x 128 shifts in
                          # shared memory (csrc/fused_mr_ops.cuh)
_OCC = ctypes.POINTER(ctypes.c_int)


def build_all(kernels=KERNELS):
    """Build every given kernel that is not loaded yet, one nvcc per
    source (entry points of one source share its build), all started
    together; then load them.  One call at a time in a process: a
    second caller waits, then finds the kernels loaded."""
    from gossip_tpu_torch.utils import telemetry
    with _BUILD_LOCK:
        todo = [k for k in kernels if k._fn is None]
        t0 = time.perf_counter()
        builds = {}
        for k in todo:
            if k.library() not in builds:
                builds[k.library()] = (k, k.start_build())
        for k in todo:
            first, started = builds[k.library()]
            k.finish_build(started if k is first else None, t0)
            k.ptxas = first.ptxas
            if k is first:
                cache = ("disabled" if _STORE["fresh"]
                         else "miss" if started is not None else "hit")
                _BUILD_EVENTS[0] += 1
                telemetry.current().event(
                    "kernel_build", kernel=k.name,
                    library=str(k.library()), cache=cache,
                    build_s=k.build_s)


def build_events() -> int:
    """How many ``kernel_build`` events this process has written: the
    serving layer's compile count (a request that built or loaded
    nothing ran warm)."""
    return _BUILD_EVENTS[0]


def count_launch(kernel: Kernel) -> None:
    """Count one launch of ``kernel``: process-wide and in the calling
    thread's tally."""
    kernel.launches += 1
    tally = _TALLY.__dict__.setdefault("counts", {})
    tally[kernel.name] = tally.get(kernel.name, 0) + 1


def thread_launches(kernels=None) -> dict:
    """The calling thread's launches of each kernel (default: every
    round kernel) since the thread started."""
    tally = _TALLY.__dict__.get("counts", {})
    return {k.name: tally.get(k.name, 0)
            for k in (ROUND_KERNELS if kernels is None else kernels)}


def _check(name: str, t, rows: int, shape=None):
    """Raise unless ``t`` is a contiguous int32 CUDA tensor of ``shape``
    (default ``[rows, 128]``)."""
    shape = tuple(shape or (rows, 128))
    if t.device.type != "cuda" or t.dtype != torch.int32 \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 CUDA tensor "
                         f"of shape {list(shape)}, got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")


def _check_sm90(dev, what: str):
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise ValueError(f"the {what} kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(dev)} is "
                         f"sm_{major}{minor}")


def _same_device(dev, operands, what: str):
    if any(t.device != dev for t in operands):
        raise ValueError(f"all operands of the {what} must be on {dev}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(kernel: Kernel, dev, *args):
    """Call ``kernel``'s entry point on ``dev``'s current stream; raise on
    a nonzero CUDA error, else count the launch."""
    fn = kernel.fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{kernel.entry} failed: CUDA error {err}")
    count_launch(kernel)


def fused_round(table, n: int, fanout: int, key, drop_threshold: int,
                plane_sharing: int, inject_bits=None, alive_table=None,
                cut_words=None, out=None, pop=None):
    """Launch ``fused_round_launch`` once: one round from ``table`` into
    ``out`` (allocated when None; never ``table``).  ``pop`` (int32[1])
    gets the new table's popcount added."""
    rows = table.shape[0]
    _check("table", table, rows)
    dev = table.device
    _check_sm90(dev, "fused round")
    if out is None:
        out = torch.empty_like(table)
    _check("out", out, rows)
    if out.data_ptr() == table.data_ptr():
        raise ValueError("out must not be the input table: other blocks "
                         "read the pre-round table while the round writes")
    operands = [table, out]
    for name, t in (("alive_table", alive_table), ("cut_words", cut_words)):
        if t is not None:
            _check(name, t, rows)
            operands.append(t)
    sbits = rbits = None
    if inject_bits is not None:
        sbits, rbits = inject_bits
        _check("sbits", sbits, rows, (8, 128))
        _check("rbits", rbits, rows, (fanout * 32 // plane_sharing, rows, 128))
        operands += [sbits, rbits]
    if pop is not None:
        _check("pop", pop, rows, (1,))
        operands.append(pop)
    _same_device(dev, operands, "fused round")
    n_valid_words = -(-n // 32)
    tail = n % 32
    k0, k1 = key
    _launch(FUSED_ROUND, dev, _ptr(table), _ptr(out), _ptr(alive_table),
            _ptr(cut_words), _ptr(sbits), _ptr(rbits), _ptr(pop), rows,
            fanout, plane_sharing, k0, k1, drop_threshold & 0xFFFFFFFF,
            n_valid_words, ((1 << tail) - 1) if tail else 0, dev.index)
    return out


def fused_mr_round(lanes, n: int, fanout: int, key, drop_threshold: int,
                   rumors: int, inject_bits=None, alive_lanes=None,
                   cut_lanes=None, out=None, pop=None, variant=None):
    """Launch ``fused_mr_round_launch`` once: one multi-rumor round from
    the lane-major table ``lanes`` (int32[128, rows], word (i, j) of the
    reference's layout at [j, i]) into ``out`` (allocated when None;
    never ``lanes``).  ``alive_lanes``, ``cut_lanes`` and
    ``inject_bits`` (sbits int32[fanout, 8, 128], rbits
    int32[fanout, 128, rows]) are lane-major too; ``pop`` (int32[32])
    gets the count of each of the first ``rumors`` bits of the new table
    added.  ``variant``: launch that measurement variant of
    ``csrc/fused_mr_parts.cu`` instead (counted on
    :data:`FUSED_MR_PARTS`)."""
    rows = lanes.shape[1] if lanes.dim() == 2 else 0
    shape = (128, rows)
    _check("table", lanes, rows, shape)
    dev = lanes.device
    _check_sm90(dev, "multi-rumor round")
    if not 0 < fanout <= MR_MAX_FANOUT:
        raise ValueError(f"the multi-rumor round kernel takes fanout 1 to "
                         f"{MR_MAX_FANOUT}, got {fanout}")
    if out is None:
        out = torch.empty_like(lanes)
    _check("out", out, rows, shape)
    if out.data_ptr() == lanes.data_ptr():
        raise ValueError("out must not be the input table: other blocks "
                         "read the pre-round table while the round writes")
    operands = [lanes, out]
    for name, t in (("alive_lanes", alive_lanes), ("cut_lanes", cut_lanes)):
        if t is not None:
            _check(name, t, rows, shape)
            operands.append(t)
    sbits = rbits = None
    if inject_bits is not None:
        sbits, rbits = inject_bits
        _check("sbits", sbits, rows, (fanout, 8, 128))
        _check("rbits", rbits, rows, (fanout, 128, rows))
        operands += [sbits, rbits]
    if pop is not None:
        _check("pop", pop, rows, (32,))
        operands.append(pop)
    _same_device(dev, operands, "multi-rumor round")
    k0, k1 = key
    kernel, head = ((FUSED_MR_ROUND, ()) if variant is None
                    else (FUSED_MR_PARTS, (int(variant),)))
    _launch(kernel, dev, *head, _ptr(lanes), _ptr(out), _ptr(alive_lanes),
            _ptr(cut_lanes), _ptr(sbits), _ptr(rbits), _ptr(pop), rows,
            fanout, k0, k1, drop_threshold & 0xFFFFFFFF, n, rumors)
    return out


def _occupancy(fn, *args, cls=None) -> dict:
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    extra = () if cls is None else (ctypes.byref(cls),)
    err = fn(*args, *extra, ctypes.byref(smem), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def fused_mr_occupancy(fanout: int, alive: bool = False, cut: bool = False,
                       inject: bool = False, drop_threshold: int = 0) -> dict:
    """The value kernel's instantiation for a call with these operands
    (``fanout_class`` 0: the fast kernel; 1, 4, or -1 for the general
    one: ``csrc/fused_mr_ops.cuh``), its dynamic shared memory and its
    resident blocks per SM on the current device
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = FUSED_MR_ROUND.entry_point("fused_mr_round_occupancy",
                                    [_I, _I, _I, _I, _U, _OCC, _OCC, _OCC])
    cls = ctypes.c_int()
    out = _occupancy(fn, fanout, int(alive), int(cut), int(inject),
                     drop_threshold & 0xFFFFFFFF, cls=cls)
    return {"fanout_class": cls.value, **out}


def fused_mr_parts_occupancy(variant: int, fanout: int, alive: bool = False,
                             cut: bool = False) -> dict:
    """A measurement variant's dynamic shared memory and resident blocks
    per SM, as :func:`fused_mr_occupancy`."""
    fn = FUSED_MR_PARTS.entry_point("fused_mr_parts_occupancy",
                                    [_I, _I, _I, _I, _I, _OCC, _OCC])
    return _occupancy(fn, variant, fanout, int(alive), int(cut), 0)


def sampler(out, n_total: int, exclude_self: bool, seed_scalar: int,
            inject_bits=None):
    """Launch ``sampler_launch`` once: uniform peers into ``out``
    (int32[n_rows, k]) from the sampler stream keyed by the int32
    ``seed_scalar``, or from ``inject_bits`` (int32[n_rows, k] holding
    the uint32 draws)."""
    if out.dim() != 2:
        raise ValueError(f"out must be [n_rows, k], got {list(out.shape)}")
    _check("out", out, 0, out.shape)
    dev = out.device
    _check_sm90(dev, "sampler")
    if inject_bits is not None:
        _check("inject_bits", inject_bits, 0, out.shape)
        _same_device(dev, [out, inject_bits], "sampler")
    if not 0 < n_total < 1 << 31:
        raise ValueError(f"n_total must be in [1, 2^31), got {n_total}")
    _launch(SAMPLER, dev, _ptr(out), _ptr(inject_bits), out.numel(),
            out.shape[1], n_total, int(bool(exclude_self)),
            int(seed_scalar) & 0xFFFFFFFF)
    return out


def mr_gather(tin, rot, n: int, f: int, key, drop_threshold: int,
              rumors: int, rbits=None, alive_words=None, rot_cut=None,
              cut_words=None, out=None, pop=None):
    """Launch ``mr_gather_launch`` once: fanout draw ``f`` of the staged
    round, ``tin | partner`` from the pre-rotated ``rot`` into ``out``
    (allocated when None; it may be ``tin``, never ``rot``).  ``rbits``
    (int32[rows, 128]) replaces this draw's stream bits; ``pop``
    (int32[32]) gets the per-rumor counts of the output added."""
    rows = tin.shape[0]
    _check("tin", tin, rows)
    dev = tin.device
    _check_sm90(dev, "multi-rumor gather")
    if f < 0:
        raise ValueError(f"fanout draw index must be >= 0, got {f}")
    if (rot_cut is None) != (cut_words is None):
        raise ValueError("rot_cut and cut_words come together")
    if out is None:
        out = torch.empty_like(tin)
    operands = [tin]
    for name, t in (("rot", rot), ("out", out), ("alive_words", alive_words),
                    ("rot_cut", rot_cut), ("cut_words", cut_words),
                    ("rbits", rbits)):
        if t is not None:
            _check(name, t, rows)
            operands.append(t)
    if rot.data_ptr() == out.data_ptr():
        raise ValueError("out must not be rot: the pass reads any word of "
                         "rot's row while it writes")
    if pop is not None:
        _check("pop", pop, rows, (32,))
        operands.append(pop)
    _same_device(dev, operands, "multi-rumor gather")
    k0, k1 = key
    _launch(MR_GATHER, dev, _ptr(tin), _ptr(rot), _ptr(out),
            _ptr(alive_words), _ptr(rot_cut), _ptr(cut_words), _ptr(rbits),
            _ptr(pop), rows, f, k0, k1, drop_threshold & 0xFFFFFFFF, n,
            rumors)
    return out


def _calibrate(kernel: Kernel, table, key, rbits):
    """Launch one of the two drawing microkernels once, on ``table`` in
    place, on round key ``key``'s stream or on ``rbits``
    (int32[32, rows, 128])."""
    rows = table.shape[0]
    _check("table", table, rows)
    dev = table.device
    _check_sm90(dev, kernel.name)
    if rbits is not None:
        _check("rbits", rbits, rows, (32, rows, 128))
        _same_device(dev, [table, rbits], kernel.name)
    k0, k1 = key
    _launch(kernel, dev, _ptr(table), _ptr(rbits), rows, k0, k1)
    return table


def cal_prng(table, key, rbits=None):
    """Launch ``cal_prng_launch`` once: ``table |= OR of 32 draws``."""
    return _calibrate(CAL_PRNG, table, key, rbits)


def cal_prng_gather(table, key, rbits=None):
    """Launch ``cal_prng_gather_launch`` once: ``table |= OR of 32
    in-row gathers`` of the pre-call row."""
    return _calibrate(CAL_PRNG_GATHER, table, key, rbits)


def cal_geometry(name: str, rows: int) -> dict:
    """The launch geometry of the drawing microkernel ``name``
    (``cal_prng`` or ``cal_prng_gather``, its timed instantiation) on
    ``[rows, 128]`` on the current device, as ``csrc/calibrate.cu``'s
    ``cal_geometry`` reports it: blocks, threads a block, resident
    blocks an SM, SMs, and the waves those make."""
    if name not in (CAL_PRNG.name, CAL_PRNG_GATHER.name):
        raise ValueError(f"no drawing microkernel {name!r}")
    fn = CAL_PRNG.entry_point("cal_geometry", [_I, _I, _OCC])
    out = (ctypes.c_int * 4)()
    err = fn(int(name == CAL_PRNG_GATHER.name), rows, out)
    if err:
        raise RuntimeError(f"cal_geometry failed: CUDA error {err}")
    geo = dict(zip(("blocks", "threads_per_block", "blocks_per_sm", "sms"),
                   out))
    geo["waves"] = geo["blocks"] / (geo["blocks_per_sm"] * geo["sms"])
    return geo


def cal_vpu(table, s: int):
    """Launch ``cal_vpu_launch`` once: the 256-step chain on every word
    of ``table``, in place, with seed word ``s``."""
    rows = table.shape[0]
    _check("table", table, rows)
    dev = table.device
    _check_sm90(dev, CAL_VPU.name)
    _launch(CAL_VPU, dev, _ptr(table), rows, s & 0xFFFFFFFF)
    return table
