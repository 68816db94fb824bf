"""Build and load the port's CUDA kernels (nvcc into a ctypes library).

The kernels in ``kernels/csrc/`` have a plain C interface, so they are
compiled by ``nvcc`` straight into one shared library and bound with
``ctypes`` — a build of seconds, where one that includes PyTorch's headers
takes minutes.  The sources are ``fedavg.cu`` (masked FedAvg),
``quantize.cu`` (int8 quantize and dequantize), ``fused_agg.cu`` (the
dequant-into-aggregate) and ``robust.cu`` (the masked trimmed mean's
sorting network).  Each source compiles in its own ``nvcc`` process, all started
together, and one more links the objects.  The build runs at first use, on
the machine with the card, into ``build/repro_torch_kernels/`` at the
repository root, keyed on a hash of the sources and flags: a changed source
builds anew, an unchanged one is loaded from the last build.  Nothing here
runs at import time.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "load_library", "count_launch"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fedavg.cu", _CSRC / "quantize.cu", _CSRC / "fused_agg.cu",
           _CSRC / "robust.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, "BuiltLibrary"] = {}
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of every C entry point (pointers and the stream are ``c_void_p``).
_SIGNATURES = {
    # arena, dtype code, row stride, raw weights, mask or NULL, out, N, P, then the
    # launch plan (grid, tile bytes, stages, dynamic shared memory bytes), stream
    "repro_fedavg": [_P, _I, _L, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P],
    # x, n, q, scales, n_groups, group, stream
    "repro_quantize": [_P, _L, _P, _P, _L, _I, _P],
    # q, scales, out, n, group, stream
    "repro_dequantize": [_P, _P, _P, _L, _I, _P],
    # q, q row stride, scales, scales row stride, w_hat, mask, out, N, P, group, stream
    "repro_fedavg_q8": [_P, _L, _P, _L, _P, _P, _P, _I, _L, _I, _P],
    # arena, dtype code, row stride, mask, out, N, P, trim_k, stream
    "repro_trimmed_mean": [_P, _I, _L, _P, _P, _I, _L, _I, _P],
}


class BuiltLibrary:
    """A loaded kernel library plus how it was built.

    ``seconds`` is the wall time of this process's build (0.0 when an
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
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _compile(out_dir: pathlib.Path, so: pathlib.Path) -> str:
    """One nvcc per source, all at once, then one link; returns nvcc's output.

    The library is linked under a temporary name and renamed, so a
    concurrent process never loads a half-written library.
    """
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        lib_tmp = pathlib.Path(tmp) / so.name
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", str(lib_tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{logs[-1]}")
        os.replace(lib_tmp, so)
    return "".join(logs)


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
            t0 = time.perf_counter()
            log = _compile(out_dir, so)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        built = _loaded[key] = BuiltLibrary(lib, so, seconds, log)
        return built


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a plain integer) after a launch.

    Learner threads launch concurrently (each upload's quantize), so the
    read-modify-write is locked: a lost update would undercount the path.
    """
    with _count_lock:
        wrapper.launches += 1
