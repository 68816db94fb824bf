"""Build and load the port's CUDA kernels (nvcc into a ctypes library).

The kernels in ``kernels/csrc/`` have a plain C interface, so they are
compiled by ``nvcc`` straight into a shared library and bound with
``ctypes`` — a build of seconds, where one that includes PyTorch's headers
takes minutes.  The build runs at first use, on the machine with the card,
into ``build/repro_torch_kernels/`` at the repository root, keyed on a hash
of the sources and flags: a changed source builds anew, an unchanged one is
loaded from the last build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "load_library"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fedavg.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, "BuiltLibrary"] = {}


class BuiltLibrary:
    """A loaded kernel library plus how it was built.

    ``seconds`` is the nvcc wall time of this process's build (0.0 when an
    earlier build with the same key was reused); ``log`` is nvcc's output,
    including ``-Xptxas -v``'s registers and shared memory per kernel.
    """

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.log = log


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels/`` at the repository root."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _key() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.repro_fedavg
    fn.argtypes = [
        ctypes.c_void_p,  # arena
        ctypes.c_int,  # dtype code
        ctypes.c_longlong,  # row stride (elements)
        ctypes.c_void_p,  # normalized weights (N,) f32
        ctypes.c_void_p,  # mask (N,) f32 or NULL
        ctypes.c_void_p,  # out (P,) f32
        ctypes.c_int,  # N
        ctypes.c_longlong,  # P
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int


def load_library() -> BuiltLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    if _loaded:  # hot path: one library per process, no re-hashing per launch
        return next(iter(_loaded.values()))
    key = _key()
    with _lock:
        built = _loaded.get(key)
        if built is not None:
            return built
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"librepro_kernels_{key}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            # Build into a temporary name and rename: a concurrent process
            # never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        built = _loaded[key] = BuiltLibrary(lib, so, seconds, log)
        return built
