"""ctypes bindings of the native real-time runtime (port of
qppvm_tpu/runtime/native.py).

``native/rt_runtime.cpp`` provides what the reference gets from XCM /
Xenomai and MatLogger: absolute-deadline pacing with latency accounting, a
wait-free single-producer single-consumer trace ring so the control thread
never blocks on IO, and a seqlock float channel over POSIX shared memory.
The source is compiled with the host's C++ compiler at first use into
``qppvm_tpu_torch/_build/``, named by a hash of the source and flags;
nothing is written under ``native/``. Tensors go to the ring and the
channel as host float32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[2] / "native" / "rt_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")

_TICK_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64, ctypes.c_double,
                            ctypes.c_void_p)

_lib = None


def library_path() -> Path:
    """The built runtime library (built if absent)."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"rt_runtime_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(library_path()))
    lib.rt_executor_create.restype = ctypes.c_void_p
    lib.rt_executor_create.argtypes = [ctypes.c_int64]
    lib.rt_executor_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_executor_run.restype = ctypes.c_int64
    lib.rt_executor_run.argtypes = [ctypes.c_void_p, _TICK_CB,
                                    ctypes.c_int64, ctypes.c_void_p]
    lib.rt_executor_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_uint64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                              ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_uint32]
    lib.ring_dropped.restype = ctypes.c_uint64
    lib.ring_dropped.argtypes = [ctypes.c_void_p]
    lib.shm_channel_create.restype = ctypes.c_void_p
    lib.shm_channel_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.shm_channel_open.restype = ctypes.c_void_p
    lib.shm_channel_open.argtypes = [ctypes.c_char_p]
    lib.shm_channel_size.restype = ctypes.c_uint32
    lib.shm_channel_size.argtypes = [ctypes.c_void_p]
    lib.shm_channel_write.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_uint32]
    lib.shm_channel_read.restype = ctypes.c_int64
    lib.shm_channel_read.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint32]
    lib.shm_channel_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the runtime builds and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _host_f32(data) -> np.ndarray:
    """``data`` (a tensor on any device, an array or a list) as a flat
    contiguous host float32 array."""
    if isinstance(data, torch.Tensor):
        data = data.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(data, np.float32).ravel())


class NativeExecutor:
    """Paced periodic executor (the Xenomai thread's counterpart)."""

    def __init__(self, period_s: float = 1e-3):
        self._lib = _load()
        self._h = self._lib.rt_executor_create(int(period_s * 1e9))

    def run(self, callback: Callable[[int, float], bool], n_ticks: int) -> int:
        """callback(tick, t_s) -> keep_running. Returns the ticks completed;
        a callback that raises stops the run, as one that returns False."""
        def _cb(tick, t_s, _user):
            try:
                return 0 if callback(tick, t_s) else 1
            except Exception:
                return 1
        cb = _TICK_CB(_cb)
        return self._lib.rt_executor_run(self._h, cb, n_ticks, None)

    def stats(self):
        p50 = ctypes.c_double()
        p99 = ctypes.c_double()
        mean = ctypes.c_double()
        misses = ctypes.c_int64()
        self._lib.rt_executor_stats(self._h, ctypes.byref(p50),
                                    ctypes.byref(p99), ctypes.byref(mean),
                                    ctypes.byref(misses))
        return dict(p50_s=p50.value, p99_s=p99.value, mean_s=mean.value,
                    deadline_misses=misses.value)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_executor_destroy(self._h)
            self._h = None


class NativeTraceRing:
    """Wait-free single-producer single-consumer trace channel."""

    def __init__(self, capacity_bytes: int = 1 << 22):
        self._lib = _load()
        self._h = self._lib.ring_create(capacity_bytes)

    def push(self, channel: int, data) -> bool:
        """Push one record; False when the ring is full (it counts the drop
        and keeps every record it holds intact)."""
        arr = _host_f32(data)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return self._lib.ring_push(self._h, channel, ptr, arr.size) == 0

    def pop(self, max_floats: int = 4096):
        """(channel, float32 array) of the oldest record, or None."""
        ch = ctypes.c_uint32()
        out = np.empty(max_floats, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = self._lib.ring_pop(self._h, ctypes.byref(ch), ptr, max_floats)
        if n < 0:
            return None
        return int(ch.value), out[:n].copy()

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


class NativeSharedObject:
    """Cross-process float channel over POSIX shared memory, the native
    counterpart of XBot's SharedObject (a simulator process publishes the
    floating-base position and velocity; the controller reads them).
    Seqlock: one writer, any readers, wait-free writes, readers retry torn
    reads.

    >>> pub = NativeSharedObject("/qppvm_fb_pos", size=3, create=True)
    >>> sub = NativeSharedObject("/qppvm_fb_pos")        # another process
    >>> pub.write([0.0, 0.0, 0.9]); sub.read()
    """

    def __init__(self, name: str, size: Optional[int] = None,
                 create: bool = False):
        self._lib = _load()
        if create:
            if size is None:
                raise ValueError("size required when create=True")
            self._h = self._lib.shm_channel_create(name.encode(), size)
        else:
            self._h = self._lib.shm_channel_open(name.encode())
        if not self._h:
            raise OSError(f"shm channel {name!r} unavailable")
        self.name = name
        self.size = int(self._lib.shm_channel_size(self._h))

    def write(self, data) -> None:
        arr = _host_f32(data)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.shm_channel_write(self._h, ptr, arr.size)

    def read(self):
        """(seq, float32 array); seq 0 means never written."""
        out = np.empty(self.size, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        seq = self._lib.shm_channel_read(self._h, ptr, self.size)
        if seq < 0:
            raise RuntimeError("torn read persisted (writer wedged?)")
        return int(seq), out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.shm_channel_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
