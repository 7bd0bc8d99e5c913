"""ctypes binding of the native (C++) sensor runtime (port of
`cerberus_tpu/native.py`).

The streaming runtime around the estimator's device work — sensor
ring-buffer ingestion, time-synchronized interval extraction, CSV output —
is C++ (`native/sensor_sync.cpp`, shared with the JAX package), as the
reference keeps its runtime in C++ (main.cpp buffering/sync/CSV). The port
builds that source with g++ into `build/cerberus_tpu_torch/` at first use
(`_build.build_native`, keyed by the source's hash) and never loads the
prebuilt `native/libsensor_sync.so`. A failed build raises: `SensorSync()`
and `CsvWriter()` never fall back to the Python versions on their own;
`available()` says whether the library builds and loads, and a failed
build is tried once per process.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cerberus_tpu_torch import _build

_SAMPLE_DOUBLES = 1 + 3 + 3 + 12 + 12 + 4


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build_native()))
    lib.sync_create.restype = ctypes.c_void_p
    lib.sync_create.argtypes = [ctypes.c_uint64]
    lib.sync_destroy.argtypes = [ctypes.c_void_p]
    dp = ctypes.POINTER(ctypes.c_double)
    lib.sync_push.argtypes = [ctypes.c_void_p, ctypes.c_double] + [dp] * 5
    lib.sync_size.restype = ctypes.c_uint64
    lib.sync_size.argtypes = [ctypes.c_void_p]
    lib.sync_latest_time.restype = ctypes.c_double
    lib.sync_latest_time.argtypes = [ctypes.c_void_p]
    lib.sync_extract.restype = ctypes.c_int64
    lib.sync_extract.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                 ctypes.c_double, dp, ctypes.c_int64]
    lib.csv_open.restype = ctypes.c_void_p
    lib.csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.csv_row.argtypes = [ctypes.c_void_p, dp, ctypes.c_int64]
    lib.csv_close.argtypes = [ctypes.c_void_p]
    return lib


_lib = None
_error = None


def get_lib() -> ctypes.CDLL:
    """The native library, built first if needed; raises RuntimeError (or
    OSError) when it cannot be built or loaded. A failure is remembered and
    raised again, so a process tries the build once."""
    global _lib, _error
    if _error is not None:
        raise _error
    if _lib is None:
        try:
            _lib = _load()
        except (RuntimeError, OSError) as e:
            _error = e
            raise
    return _lib


def available() -> bool:
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class SensorSync:
    """Native ring buffer with time-synced interval extraction.

    Same interface as the estimator's `PySensorSync`:
    push(t, acc, gyr, phi, dphi, contact) at 500 Hz; extract(t0, t1) returns
    a packed (n, 35) array [t, acc3, gyr3, phi12, dphi12, c4] including
    interpolated boundary samples (reference: estimator.cpp:303-397 +
    utility.cpp:24-104 lerp helpers), or None before the stream reaches
    t1."""

    def __init__(self, capacity: int = 65536):
        self._lib = get_lib()
        self._h = self._lib.sync_create(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sync_destroy(self._h)
            self._h = None

    def push(self, t, acc, gyr, phi, dphi, contact):
        a = np.ascontiguousarray(acc, np.float64)
        g = np.ascontiguousarray(gyr, np.float64)
        p = np.ascontiguousarray(phi, np.float64)
        d = np.ascontiguousarray(dphi, np.float64)
        c = np.ascontiguousarray(contact, np.float64)
        self._lib.sync_push(self._h, float(t), _as_dp(a), _as_dp(g),
                            _as_dp(p), _as_dp(d), _as_dp(c))

    def size(self) -> int:
        return int(self._lib.sync_size(self._h))

    def latest_time(self) -> float:
        return float(self._lib.sync_latest_time(self._h))

    def extract(self, t0: float, t1: float, max_out: int = 4096):
        out = np.empty((max_out, _SAMPLE_DOUBLES), np.float64)
        n = self._lib.sync_extract(self._h, float(t0), float(t1),
                                   _as_dp(out), max_out)
        if n < 0:
            return None
        return out[:n].copy()


class CsvWriter:
    """Native append-only CSV writer ("%.9g" per value, flushed per row;
    the reference's 20-column result schema)."""

    def __init__(self, path: str, header: str):
        self._lib = get_lib()
        self._f = self._lib.csv_open(path.encode(), header.encode())
        if not self._f:
            raise OSError(f"cannot open {path}")

    def row(self, vals):
        v = np.ascontiguousarray(vals, np.float64)
        self._lib.csv_row(self._f, _as_dp(v), len(v))

    def close(self):
        if self._f:
            self._lib.csv_close(self._f)
            self._f = None
