"""ctypes bindings for the native (C++) data-loading runtime.

``NativeDataLoader`` mirrors `data.loader.DataLoader`'s iteration protocol
but assembles batches in a C++ background thread (shuffle + gather + copy
into a prefetch ring), overlapping host batch assembly with accelerator
compute. Falls back transparently: ``is_available()`` gates usage, and the
shared library is built on demand with the baked-in g++ toolchain.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"
_LIB_PATH = _CSRC / "libregneuralde_data.so"
_lib = None

_DTYPE_MAP = {
    np.dtype(np.float32): b"f",
    np.dtype(np.float64): b"d",
    np.dtype(np.uint8): b"u",
    np.dtype(np.int64): b"i",
}


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_CSRC)], check=True,
                       capture_output=True)
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # Always run make: a no-op when the library is current, and a rebuild
    # from the committed sources whenever a copied tree brought a stale or
    # foreign binary along.
    if not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.rnde_load_npy.restype = ctypes.c_void_p
    lib.rnde_load_npy.argtypes = [ctypes.c_char_p]
    lib.rnde_load_idx.restype = ctypes.c_void_p
    lib.rnde_load_idx.argtypes = [ctypes.c_char_p]
    lib.rnde_tensor_from_buffer.restype = ctypes.c_void_p
    lib.rnde_tensor_from_buffer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int64, ctypes.c_char,
    ]
    lib.rnde_tensor_data.restype = ctypes.c_void_p
    lib.rnde_tensor_data.argtypes = [ctypes.c_void_p]
    lib.rnde_tensor_ndim.restype = ctypes.c_int
    lib.rnde_tensor_ndim.argtypes = [ctypes.c_void_p]
    lib.rnde_tensor_dim.restype = ctypes.c_int64
    lib.rnde_tensor_dim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rnde_tensor_itemsize.restype = ctypes.c_int64
    lib.rnde_tensor_itemsize.argtypes = [ctypes.c_void_p]
    lib.rnde_tensor_dtype.restype = ctypes.c_char
    lib.rnde_tensor_dtype.argtypes = [ctypes.c_void_p]
    lib.rnde_tensor_destroy.argtypes = [ctypes.c_void_p]
    lib.rnde_loader_create.restype = ctypes.c_void_p
    lib.rnde_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.rnde_loader_next.restype = ctypes.c_int64
    lib.rnde_loader_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p)]
    lib.rnde_loader_batches_per_epoch.restype = ctypes.c_int64
    lib.rnde_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.rnde_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def is_available() -> bool:
    return _load() is not None


def load_npy(path) -> Optional[np.ndarray]:
    """Parse an NPY file with the native reader (returns a copy)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rnde_load_npy(str(path).encode())
    if not h:
        return None
    try:
        return _tensor_to_numpy(lib, h)
    finally:
        lib.rnde_tensor_destroy(h)


def load_idx(path) -> Optional[np.ndarray]:
    """Parse an MNIST IDX file with the native reader."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rnde_load_idx(str(path).encode())
    if not h:
        return None
    try:
        return _tensor_to_numpy(lib, h)
    finally:
        lib.rnde_tensor_destroy(h)


def _tensor_to_numpy(lib, handle) -> np.ndarray:
    ndim = lib.rnde_tensor_ndim(handle)
    shape = tuple(lib.rnde_tensor_dim(handle, i) for i in range(ndim))
    dt = lib.rnde_tensor_dtype(handle)
    dtype = {b"f": np.float32, b"d": np.float64, b"u": np.uint8,
             b"i": np.int64}[dt]
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = ctypes.string_at(lib.rnde_tensor_data(handle), n)
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


class NativeDataLoader:
    """Prefetching minibatch loader over in-memory numpy arrays (C++)."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, prefetch_depth: int = 2,
                 source: str = "memory"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native data loader library unavailable")
        self._lib = lib
        self.batch_size = batch_size
        self.source = source
        self._arrays_meta = []
        self._handles = []
        arrays = [np.ascontiguousarray(a) for a in arrays]
        self._arrays = arrays
        self.n = arrays[0].shape[0]
        for a in arrays:
            if a.dtype not in _DTYPE_MAP:
                raise ValueError(f"unsupported dtype {a.dtype}")
            shape = (ctypes.c_int64 * a.ndim)(*a.shape)
            h = lib.rnde_tensor_from_buffer(
                a.ctypes.data_as(ctypes.c_void_p), shape, a.ndim,
                a.dtype.itemsize, _DTYPE_MAP[a.dtype])
            if not h:
                raise RuntimeError("native tensor creation failed")
            self._handles.append(h)
            self._arrays_meta.append((a.shape[1:], a.dtype))
        handles = (ctypes.c_void_p * len(self._handles))(*self._handles)
        self._loader = lib.rnde_loader_create(
            handles, len(self._handles), batch_size, int(shuffle),
            int(drop_last), seed or 1, prefetch_depth)
        if not self._loader:
            raise RuntimeError("native loader creation failed")
        self._drop_last = drop_last

    def __len__(self) -> int:
        return int(self._lib.rnde_loader_batches_per_epoch(self._loader))

    def _next_rows(self):
        bufs = [np.empty((self.batch_size,) + shp, dt)
                for shp, dt in self._arrays_meta]
        ptrs = (ctypes.c_void_p * len(bufs))(
            *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
        rows = self._lib.rnde_loader_next(self._loader, ptrs)
        if rows < 0:
            raise RuntimeError("native loader error")
        return rows, bufs

    def __iter__(self):
        # The C++ prefetch ring is a persistent epoch stream. If a prior
        # consumer stopped mid-epoch (eval sweeps `break` early), the next
        # iteration would otherwise RESUME mid-epoch — shortened "epochs",
        # and zero-batch ones once the offsets align with the boundary.
        # Fast-forward to the next epoch boundary so every ``for`` loop
        # starts a fresh epoch, like the pure-Python loader.
        while getattr(self, "_pos", 0):
            rows, _ = self._next_rows()
            if rows == 0:
                self._pos = 0
        while True:
            rows, bufs = self._next_rows()
            if rows == 0:  # epoch boundary
                self._pos = 0
                return
            self._pos = getattr(self, "_pos", 0) + 1
            out = tuple(b[:rows] for b in bufs)
            yield out if len(out) > 1 else out[0]

    def first_batch(self):
        sel = np.arange(min(self.batch_size, self.n))
        batch = tuple(a[sel] for a in self._arrays)
        return batch if len(batch) > 1 else batch[0]

    def close(self):
        if getattr(self, "_loader", None):
            self._lib.rnde_loader_destroy(self._loader)
            self._loader = None
        for h in self._handles:
            self._lib.rnde_tensor_destroy(h)
        self._handles = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
