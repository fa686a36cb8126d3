"""Python binding for the native rfsim IQ-exchange transport.

The radio-HAL layer analog (radio/COMMON/common_lib.h openair0_device
vtable + radio/rfsimulator): `RfSimDevice.read/write` mirror
trx_read_func/trx_write_func with sample timestamps.  The heavy lifting
(sockets, framing, timestamp-aligned ring buffering) is the C++ shared
lib in native/rfsim, loaded via ctypes; samples cross the boundary as
numpy complex64 arrays.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native", "rfsim")
_LIB_PATH = os.path.join(_DIR, "librfsim.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # built from source on first use; the lock keeps concurrent first users
    # (test workers) from loading a library another one is still writing
    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rfsim_listen.restype = ctypes.c_void_p
    lib.rfsim_listen.argtypes = [ctypes.c_uint16, ctypes.c_uint32]
    lib.rfsim_connect.restype = ctypes.c_void_p
    lib.rfsim_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                  ctypes.c_uint32, ctypes.c_int]
    lib.rfsim_write.restype = ctypes.c_int
    lib.rfsim_write.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
    lib.rfsim_read.restype = ctypes.c_int
    lib.rfsim_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
    lib.rfsim_close.argtypes = [ctypes.c_void_p]
    lib.rfsim_set_channel.restype = ctypes.c_int
    lib.rfsim_set_channel.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_uint32, ctypes.c_float]
    lib.rfsim_record.restype = ctypes.c_int
    lib.rfsim_record.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_uint64]
    lib.rfsim_replay.restype = ctypes.c_int64
    lib.rfsim_replay.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_uint64]
    _lib = lib
    return lib


class RfSimDevice:
    """One endpoint of an IQ link (openair0_device analog)."""

    def __init__(self, handle, n_ant: int):
        self._h = handle
        self.n_ant = n_ant

    @classmethod
    def listen(cls, port: int, n_ant: int = 1) -> "RfSimDevice":
        lib = _load()
        h = lib.rfsim_listen(port, n_ant)
        if not h:
            raise OSError(f"rfsim_listen({port}) failed")
        return cls(h, n_ant)

    @classmethod
    def connect(cls, host: str, port: int, n_ant: int = 1,
                timeout_ms: int = 5000) -> "RfSimDevice":
        lib = _load()
        h = lib.rfsim_connect(host.encode(), port, n_ant, timeout_ms)
        if not h:
            raise OSError(f"rfsim_connect({host}:{port}) failed")
        return cls(h, n_ant)

    def write(self, timestamp: int, samples: np.ndarray) -> None:
        """samples: (n_ant, n) or (n,) complex64 (trx_write_func analog)."""
        s = np.ascontiguousarray(
            np.atleast_2d(samples).astype(np.complex64).T)  # (n, n_ant)
        n = s.shape[0]
        f = s.view(np.float32)
        rc = _load().rfsim_write(
            self._h, timestamp, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if rc != 0:
            raise OSError("rfsim_write failed")

    def read(self, timestamp: int, n_samples: int) -> np.ndarray:
        """Blocking read of (n_ant, n_samples) complex64 at `timestamp`."""
        buf = np.zeros((n_samples, self.n_ant), np.complex64)
        f = buf.view(np.float32)
        rc = _load().rfsim_read(
            self._h, timestamp, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_samples)
        if rc != 0:
            raise OSError("rfsim_read: peer closed before data available")
        return buf.T.copy()

    def set_channel(self, taps: np.ndarray | None,
                    noise_sigma: float = 0.0) -> None:
        """Apply a channel model to RECEIVED samples inside the native hub
        (the rfsimulator `rfsimu_setchanmod_cmd` telnet-command analog,
        radio/rfsimulator/apply_channelmod.c): static complex FIR `taps`
        + AWGN with per-component std `noise_sigma`.  taps=None clears."""
        lib = _load()
        if taps is None:
            rc = lib.rfsim_set_channel(self._h, None, 0, 0.0)
        else:
            t = np.ascontiguousarray(np.atleast_1d(taps).astype(np.complex64))
            f = t.view(np.float32)
            rc = lib.rfsim_set_channel(
                self._h, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t.size, float(noise_sigma))
        if rc != 0:
            raise OSError("rfsim_set_channel failed")

    def close(self):
        if self._h:
            _load().rfsim_close(self._h)
            self._h = None


def record_iq(path: str, samples: np.ndarray) -> None:
    """iqplayer-analog capture: write complex64 samples to file."""
    s = np.ascontiguousarray(samples.astype(np.complex64)).view(np.float32)
    rc = _load().rfsim_record(path.encode(),
                              s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              s.size)
    if rc != 0:
        raise OSError("rfsim_record failed")


def replay_iq(path: str, n_samples: int) -> np.ndarray:
    buf = np.zeros(n_samples, np.complex64)
    f = buf.view(np.float32)
    n = _load().rfsim_replay(path.encode(),
                             f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             f.size)
    if n < 0:
        raise OSError("rfsim_replay failed")
    return buf[: n // 2]
