"""Build the package's CUDA sources with nvcc on first use and bind them.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface under ``build/kernels/`` at the repository root (git-ignored), named
by a hash of the source and flags so an edited source rebuilds.  The library
is loaded with ``ctypes``: pointers and the stream travel as ``c_void_p``.
No PyTorch headers are compiled, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported C functions of each source: name -> (argtypes, restype)
SIGNATURES = {
    "fast_nms": {"fast_nms_pyramid_bf16": ([_P, _P, _P, _F, _I, _P], _I)},
    "patches": {"extract_patches_bf16": ([_P, _P, _P, _I, _I, _I, _P], _I)},
    "brief": {"brief_describe": ([_P, _P, _P, _P, _I, _P, _I, _P], _I)},
}

_libs: dict = {}
_lock = threading.Lock()
# seconds nvcc took per library in this process (absent when a cached .so was reused)
build_seconds: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled from csrc/ on first use")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_nvcc(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns the job."""
    so = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, tmp, time.perf_counter(), proc


def _finish_nvcc(name: str, so: Path, tmp: Path, t0: float, proc) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    build_seconds[name] = time.perf_counter() - t0
    (BUILD_DIR / f"{name}.ptxas.log").write_text(log)
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, compiling it if needed.
    Raises when nvcc is missing or fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.exists():
            _finish_nvcc(name, *_start_nvcc(name))
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _libs[name] = lib
        return lib


def build_all() -> dict:
    """Compile every kernel library, one nvcc per source all started
    together, and load them; returns ``{name: CDLL}``."""
    with _lock:
        jobs = {name: _start_nvcc(name) for name in SIGNATURES
                if name not in _libs and not library_path(name).exists()}
        for name, job in jobs.items():
            _finish_nvcc(name, *job)
    return {name: load(name) for name in SIGNATURES}


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
