"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles in seconds
into its own shared library under ``build/repro_torch/`` at the repository
root, named by a hash of its source and flags (an edited source never
loads a stale library).  Nothing is built when a module is imported: the
first launch builds what it needs, and :func:`build_all` builds every
source at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "repro_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOAD_LOCK = threading.Lock()
_FNS: dict = {}
#: ptxas report (registers, shared memory, spills) of each built source
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    # the source and every header of csrc/ (a header edit rebuilds)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            os.path.join(CSRC, h) for h in os.listdir(CSRC)
            if h.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start the nvcc of one source; None when its library is built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: no process loads a half-written file


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all() -> float:
    """Build every source in parallel; returns the wall seconds."""
    t0 = time.time()
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (once,
    whatever number of threads asks: ranks run as threads launch
    together)."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, *,
         n_u64: int = 0, stream: bool = True):
    """A C entry point taking ``n_ptrs`` pointers, ``n_ints`` ints,
    ``n_u64`` unsigned 64-bit ints and the stream (unless
    ``stream=False``), returning an int: a launch's
    ``cudaGetLastError()``."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_uint64] * n_u64
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def build_copies(sub: str, sources: dict, flags=()) -> dict:
    """Build ``{name: source text}`` into ``build/repro_torch/<sub>/`` with
    extra ``flags`` (a profiling or floor variant of a kernel), one
    ``nvcc`` each, all started together; {name: CDLL}."""
    out = os.path.join(BUILD_DIR, sub)
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        with open(os.path.join(out, f"{name}.cu"), "w") as f:
            f.write(src)
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, f"-I{CSRC}", "-o",
               os.path.join(out, f"{name}.so"), os.path.join(out, f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        BUILD_LOG[f"{sub}/{name}"] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {sub} {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


def source(name: str) -> str:
    """The text of ``csrc/<name>``."""
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def check_launch(symbol: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {err}")
