"""ctypes bindings for the native runtime (native/euroc_runtime.cpp).

Provides the C++ fast path for dataset IO: CSV parsing and a multi-threaded
prefetching PNG decode stream.  The library is built from
``native/euroc_runtime.cpp`` by ``make -C native`` (needs libpng and zlib);
where it is not built or does not load, ``euroc.py`` falls back to the
standard-library PNG decoder (io/png.py).
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmsckf_runtime.so")

_lib = None


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # built elsewhere, or its libpng is missing here
        return None
    lib.mr_load_imu_csv.restype = ctypes.c_int
    lib.mr_load_imu_csv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    lib.mr_load_cam_csv.restype = ctypes.c_int
    lib.mr_load_cam_csv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mr_decode_png.restype = ctypes.c_int
    lib.mr_decode_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mr_stream_open.restype = ctypes.c_void_p
    lib.mr_stream_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mr_stream_next.restype = ctypes.c_int
    lib.mr_stream_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.mr_stream_errors.restype = ctypes.c_int
    lib.mr_stream_errors.argtypes = [ctypes.c_void_p]
    lib.mr_stream_close.restype = None
    lib.mr_stream_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def load_imu_csv(path: str, max_n: int = 2_000_000):
    """Returns (t_seconds, gyro (N,3), acc (N,3)) via the native parser."""
    lib = load_library()
    assert lib is not None, "native runtime unavailable (build it: make -C native)"
    t = np.empty(max_n, np.int64)
    gyro = np.empty((max_n, 3), np.float64)
    acc = np.empty((max_n, 3), np.float64)
    n = lib.mr_load_imu_csv(
        path.encode(),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gyro.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_n,
    )
    if n < 0:
        raise IOError(f"mr_load_imu_csv failed for {path}")
    return t[:n] * 1e-9, gyro[:n], acc[:n]


def decode_png(path: str, width: int, height: int) -> np.ndarray:
    lib = load_library()
    assert lib is not None
    out = np.empty((height, width), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mr_decode_png(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width,
        height,
        ctypes.byref(w),
        ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"mr_decode_png({path}) -> {rc}")
    return out[: h.value, : w.value]


class ImageStream:
    """Bounded multi-threaded prefetching decoder over a file list."""

    def __init__(
        self,
        files: List[str],
        width: int,
        height: int,
        queue_depth: int = 64,
        threads: int = 4,
    ):
        lib = load_library()
        assert lib is not None, "native runtime unavailable (build it: make -C native)"
        self._lib = lib
        self._w, self._h = width, height
        joined = b"\0".join(f.encode() for f in files) + b"\0"
        self._handle = lib.mr_stream_open(
            joined, len(files), width, height, queue_depth, threads
        )
        self._remaining = len(files)

    def next_batch(self, count: int) -> np.ndarray:
        count = min(count, self._remaining)
        out = np.empty((count, self._h, self._w), np.uint8)
        got = self._lib.mr_stream_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), count
        )
        self._remaining -= got
        return out[:got]

    @property
    def errors(self) -> int:
        return self._lib.mr_stream_errors(self._handle)

    def close(self):
        if self._handle:
            self._lib.mr_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
