"""The C++ event core and router, built with ``g++`` and loaded with ctypes.

The port's copy of the JAX package's ``native`` loader.  Each source
beside this file is compiled at first use by one ``g++ -O2 -std=c++17``
call into the port's build directory (``ops/_kernels.build_dir()``:
``--compile-cache DIR``, else ``$GOSSIP_COMPILE_CACHE``, else
``gossip_tpu_torch/_build/``), never beside the sources.  The output is
named by a hash of its source, so an edited source never loads a stale
build, and is written to a temporary path first and moved into place with
``os.replace``, so concurrent builds (test workers, two commands on a
fresh checkout) never leave a torn file.

Nothing falls back: where the reference's loader returns ``None`` without
a compiler and its callers run the pure-Python engine, :func:`build_native`
and :func:`load_eventsim` raise a ``ValueError`` that names the compiler's
error.  The Python engine (``runtime/gonative.GoNativeSim``) runs only
when a caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
EVENTSIM_SRC = _DIR / "eventsim.cpp"
ROUTER_SRC = _DIR / "router.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def output_path(src: Path, stem: str, suffix: str = "") -> Path:
    """``stem-<hash of the source>suffix`` in the CUDA kernels' store
    (``ops/_kernels.build_dir``)."""
    from gossip_tpu_torch.ops import _kernels
    digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
    return _kernels.build_dir() / f"{stem}-{digest}{suffix}"


def build_native(src: Path, out: Path, shared: bool = True) -> Path:
    """Compile ``src`` to ``out`` (a shared library, or a program with
    ``shared=False``) with one ``g++`` call through a temporary path and
    ``os.replace``; ``out`` when it is already built.  Raises a
    ``ValueError`` naming the compiler's error when the build fails."""
    out = Path(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17"]
    if shared:
        cmd += ["-shared", "-fPIC"]
    cmd += [str(src), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
    except FileNotFoundError as e:
        raise ValueError(f"building {Path(src).name} needs g++, which is "
                         f"not on PATH ({e})") from None
    except subprocess.CalledProcessError as e:
        raise ValueError(f"g++ failed to build {Path(src).name} "
                         f"(exit {e.returncode}): {e.stderr[-2000:]}"
                         ) from None
    except (subprocess.SubprocessError, OSError) as e:
        raise ValueError(f"g++ failed to build {Path(src).name}: {e}"
                         ) from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_eventsim() -> ctypes.CDLL:
    """The event core's library, built first if needed; raises (see
    :func:`build_native`) where the reference returns ``None``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = build_native(EVENTSIM_SRC,
                          output_path(EVENTSIM_SRC, "libeventsim", ".so"))
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise ValueError(f"cannot load the event core {so}: {e}"
                             ) from None
        c = ctypes
        lib.gsim_create.restype = c.c_void_p
        lib.gsim_create.argtypes = [c.c_int32]
        lib.gsim_destroy.argtypes = [c.c_void_p]
        lib.gsim_config.argtypes = [c.c_void_p, c.c_double, c.c_double,
                                    c.c_double, c.c_int32, c.c_int32,
                                    c.c_double]
        lib.gsim_set_neighbors.argtypes = [c.c_void_p, c.c_int32,
                                           c.POINTER(c.c_int32), c.c_int32]
        lib.gsim_partition.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                       c.c_double, c.c_double]
        lib.gsim_broadcast.argtypes = [c.c_void_p, c.c_int32, c.c_int64,
                                       c.c_double]
        lib.gsim_run.argtypes = [c.c_void_p, c.c_double]
        lib.gsim_msgs_sent.restype = c.c_int64
        lib.gsim_msgs_sent.argtypes = [c.c_void_p]
        lib.gsim_now.restype = c.c_double
        lib.gsim_now.argtypes = [c.c_void_p]
        lib.gsim_read_len.restype = c.c_int32
        lib.gsim_read_len.argtypes = [c.c_void_p, c.c_int32]
        lib.gsim_read.argtypes = [c.c_void_p, c.c_int32,
                                  c.POINTER(c.c_int64)]
        lib.gsim_min_hop.restype = c.c_int32
        lib.gsim_min_hop.argtypes = [c.c_void_p, c.c_int32, c.c_int64]
        lib.gsim_delivery_count.restype = c.c_int32
        lib.gsim_delivery_count.argtypes = [c.c_void_p]
        lib.gsim_deliveries.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                        c.POINTER(c.c_int32),
                                        c.POINTER(c.c_int64),
                                        c.POINTER(c.c_int32)]
        _lib = lib
        return _lib
