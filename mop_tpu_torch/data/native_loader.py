"""ctypes binding of the repo's native C++ prefetching batch loader.

``native/mop_loader.cpp`` (host C++, no JAX) is built with g++ on first use
into ``mop_tpu_torch/_build/native/``, keyed by a hash of the source, and
loaded with ``ctypes``. ``NativeBatchIterator`` is a drop-in for
``BatchIterator``: a producer thread assembles shuffled uint8 batches into a
prefetch ring off the step's critical path. Its shuffle is the loader's own
(a Mersenne Twister in C++), not numpy's, so one seed gives one batch
sequence through this loader and another through ``BatchIterator``.
``is_available()`` is false where there is no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "mop_loader.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return _PKG / "_build" / "native" / f"libmop_loader_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True)
    except FileNotFoundError:
        return "g++ not found"
    except subprocess.CalledProcessError as e:
        return e.stderr[:2000]
    os.replace(tmp, so)  # atomic: a concurrent reader never sees half a library
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not SRC.is_file():
            _build_error = f"{SRC} is missing"
            return None
        so = _so_path()
        if not so.exists():
            _build_error = _build(so)
            if _build_error:
                return None
        lib = ctypes.CDLL(str(so))
        lib.mop_loader_create.restype = ctypes.c_void_p
        lib.mop_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
        ]
        lib.mop_loader_next.restype = ctypes.c_int
        lib.mop_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.mop_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


class NativeBatchIterator:
    """Infinite shuffled batch iterator backed by the C++ prefetch loader.

    Same interface as ``BatchIterator``: yields (uint8 batch, int32 labels)
    as fresh numpy arrays; the batches are assembled in a background thread.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                 queue_depth: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        # Own contiguous copies for the loader's lifetime (it borrows the pointers).
        self._x = np.ascontiguousarray(x, dtype=np.uint8)
        self._y = np.ascontiguousarray(y, dtype=np.int32)
        self.batch = int(batch)
        self.sample_shape = self._x.shape[1:]
        self._handle = lib.mop_loader_create(
            self._x.ctypes.data_as(ctypes.c_void_p), self._y.ctypes.data_as(ctypes.c_void_p),
            len(self._x), int(np.prod(self.sample_shape)), self.batch,
            int(seed) & (2**64 - 1), int(queue_depth))
        self._out_x = np.empty((self.batch,) + self.sample_shape, np.uint8)
        self._out_y = np.empty((self.batch,), np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        rc = self._lib.mop_loader_next(self._handle, self._out_x.ctypes.data_as(ctypes.c_void_p),
                                       self._out_y.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise StopIteration
        return self._out_x.copy(), self._out_y.copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.mop_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
