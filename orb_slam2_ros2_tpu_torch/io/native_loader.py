"""ctypes bridge to the native prefetching PNG decoder (port of
``orb_slam2_ros2_tpu/io/native_loader.py``).

The package carries its own copy of the decoder, ``csrc/dataloader.cpp``: a
multithreaded in-order prefetch ring of libpng decodes that keeps image
decoding off the tracker's path.  On first use it is compiled with g++ into
``build/native/`` at the repository root (git-ignored), named by a hash of
the source and flags so an edited source rebuilds, as ``ops/_build.py``
builds the CUDA kernels.  Where g++ or the libpng headers are missing,
or the built library cannot be loaded, ``get_lib()`` returns None
(``build_error`` says why) and the dataset readers
decode with Pillow, the JAX package's order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")
MAX_PIXELS = 4096 * 4096

_lib = None
_lock = threading.Lock()
# why the library could not be built in this process (None: not tried, or built)
build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libslamio_{digest}.so"


def _build(so: Path) -> bool:
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        build_error = "g++ not found"
        return False
    if proc.returncode != 0:
        build_error = proc.stderr.strip().splitlines()[0] if proc.stderr.strip() else f"g++ rc {proc.returncode}"
        return False
    os.replace(tmp, so)
    return True


def get_lib():
    """The bound decoder library, compiled on first use; None when it cannot
    be built here."""
    global _lib, build_error
    with _lock:
        if _lib is not None or build_error is not None:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:  # built elsewhere, and a library it links is missing here
            build_error = f"cannot load {so.name}: {e}"
            return None
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_decode_one.restype = ctypes.c_int
        lib.dl_decode_one.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def _float_ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_png(path: str) -> Optional[np.ndarray]:
    """Synchronous native decode → f32 grayscale [H, W]; None when the
    library is unavailable or the file does not decode."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(MAX_PIXELS, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    n = lib.dl_decode_one(path.encode(), _float_ptr(buf), MAX_PIXELS, ctypes.byref(h), ctypes.byref(w))
    if n <= 0:
        return None
    return buf[:n].reshape(h.value, w.value).copy()


class PrefetchingLoader:
    """In-order multithreaded decode of a path list (bounded ring)."""

    def __init__(self, paths: List[str], n_threads: int = 4, depth: int = 8,
                 capacity: int = MAX_PIXELS):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {build_error}")
        self._lib = lib
        # the C++ loader copies the paths; the array is kept for the call only
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.dl_create(arr, len(paths), n_threads, depth)
        if not self._handle:
            raise RuntimeError("dl_create failed")
        self._cap = capacity
        self._buf = np.empty(capacity, np.float32)
        self._n = len(paths)
        self._i = 0

    def __len__(self):
        return self._n

    def next(self, shape: Tuple[int, int]) -> Optional[np.ndarray]:
        """Blocking fetch of the next frame reshaped to ``shape``; None past
        the end, on a decode failure or a frame of another size."""
        if self._i >= self._n:
            return None
        n = self._lib.dl_next(self._handle, _float_ptr(self._buf), self._cap)
        self._i += 1
        h, w = shape
        if n <= 0 or n != h * w:
            return None
        return self._buf[:n].reshape(h, w).copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
