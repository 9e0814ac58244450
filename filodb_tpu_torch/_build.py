"""Build and load the hand-written CUDA kernels and the host codec, and
count the kernels' launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/kernels/lib<name>-<hash>.so``,
keyed by the source's content), loaded with ``ctypes``. The first call of
``library`` builds every source at once, one ``nvcc`` process each, all
started together. Nothing builds when a module is imported: the CPU tests
import every module and have no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code. Launch counts are plain integers in
``LAUNCHES``, added to by each wrapper where it launches its kernel.

The host libraries of the write path, ``csrc/hostcodec.cpp`` (NibblePack,
the chunk vectors, the record-container scan) and ``csrc/ingestcore.cpp``
(the part-key map, the container pass, the write buffers' append and
window fold), compile with ``g++`` into the same directory on their first
use (``host_library``), on any machine. A failed build raises: nothing
falls back to the Python twins. A library that does not build or load
raises ``RuntimeError`` naming it, never the ``OSError`` beneath: a gather
takes an ``OSError`` for a lost transport and answers partially without
the child (``query/exec/plan.py``), and a failing card is no such loss.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("decode_pages", "fused_rate", "windowed_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"decode_ts_page": 0, "decode_f32_page": 0,
                            "fused_decode_rate": 0, "windowed_sum": 0}

HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
HOST_SOURCES = ("hostcodec", "ingestcore")

_libs: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextmanager
def _loading(what):
    """An ``OSError`` while ``what`` builds or loads, as ``RuntimeError``."""
    try:
        yield
    except OSError as e:
        raise RuntimeError(f"kernel library {what} failed to build or "
                           f"load: {e}") from e


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() \
        + (CSRC / "common.cuh").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source not yet built, in parallel. Returns seconds."""
    t0 = time.perf_counter()
    with _loading(", ".join(SOURCES)):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(BUILD_DIR / f"{name}.log", "w")
            procs.append((name, out, tmp, log, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                tmp.replace(out)
        if failed:
            logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        with _loading(name):
            if not _target(name).exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        lib.filodb_error_string.restype = ctypes.c_char_p
        lib.filodb_error_string.argtypes = [ctypes.c_int]
    return lib


def bind(name: str, fn: str, nargs: int):
    """A C entry point taking ``nargs`` arguments, every one passed as a
    64-bit value (pointers, the stream and sizes alike)."""
    f = getattr(library(name), fn)
    f.argtypes = [ctypes.c_void_p] * nargs
    f.restype = ctypes.c_int
    return f


def constant(name: str, fn: str) -> int:
    """A C entry point of no arguments returning a 64-bit integer."""
    f = getattr(library(name), fn)
    f.argtypes = []
    f.restype = ctypes.c_longlong
    return int(f())


def check(name: str, rc: int) -> None:
    if rc != 0:
        msg = library(name).filodb_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch in {name} failed: {msg} "
                           f"(error {rc})")


def _host_target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()
                            + " ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def host_library(name: str = "hostcodec") -> ctypes.CDLL:
    """The host C++ library ``csrc/<name>.cpp``, built with ``g++`` on
    first use. Raises if it does not build."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _host_lock, _loading(name):
        return _libs.get(name) or _build_host(name)


def _build_host(name: str) -> ctypes.CDLL:
    out = _host_target(name)
    if not out.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++) to build {name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp),
                               str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n"
                               f"{proc.stderr[-4000:]}")
        tmp.replace(out)
    lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


def host_fn(fn: str, nargs: int, name: str = "hostcodec"):
    """An entry point of the host library ``name`` taking ``nargs`` 64-bit
    arguments (pointers and sizes) and returning a 64-bit integer."""
    f = getattr(host_library(name), fn)
    f.argtypes = [ctypes.c_void_p] * nargs
    f.restype = ctypes.c_int64
    return f
