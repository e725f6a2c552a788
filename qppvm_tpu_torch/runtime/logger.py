"""Signal logging and a severity console logger (port of
qppvm_tpu/runtime/logger.py).

``TraceBuffer`` is the reference's MatLogger: named channels in host
arrays preallocated at first use (no allocation in the loop), flushed to
``.npz`` and to MATLAB ``.mat``. ``scan_with_stream`` runs a loop on the
device and streams its channels into a TraceBuffer a chunk at a time.
``ConsoleLogger`` is its XBot::Logger.
"""
from __future__ import annotations

import enum
import logging
import sys
from typing import Dict

import numpy as np
import torch

from qppvm_tpu_torch import telemetry


def _host(value) -> np.ndarray:
    """``value`` (a tensor on any device, an array or a number) as a host
    array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class TraceBuffer:
    """Preallocated named-channel signal logger.

    >>> log = TraceBuffer("out/qppvm_log", capacity=30000)
    >>> log.add("tau_qp", tau)   # one sample of a channel
    >>> log.flush()              # out/qppvm_log.npz and .mat

    Each channel keeps its first ``capacity`` samples; later ones are
    dropped."""

    def __init__(self, path: str, capacity: int = 30000):
        self.path = path
        self.capacity = capacity
        self._buffers: Dict[str, np.ndarray] = {}
        self._idx: Dict[str, int] = {}

    def _channel(self, name: str, shape) -> int:
        if name not in self._buffers:
            self._buffers[name] = np.zeros((self.capacity,) + tuple(shape),
                                           dtype=np.float64)
            self._idx[name] = 0
        return self._idx[name]

    def add(self, name: str, value) -> None:
        """Append one sample to channel ``name``."""
        value = _host(value)
        i = self._channel(name, value.shape)
        if i < self.capacity:
            self._buffers[name][i] = value
            self._idx[name] = i + 1

    def add_block(self, name: str, block) -> None:
        """Append a (T, ...) block of samples to channel ``name``."""
        block = _host(block)
        i = self._channel(name, block.shape[1:])
        n = min(block.shape[0], self.capacity - i)
        if n > 0:
            self._buffers[name][i:i + n] = block[:n]
            self._idx[name] = i + n

    def tick(self) -> None:
        """Kept for the reference's API: ``add`` advances each channel."""

    def data(self) -> Dict[str, np.ndarray]:
        return {k: v[: self._idx[k]] for k, v in self._buffers.items()}

    def flush(self) -> str:
        """Write ``<path>.npz`` and, where scipy is installed,
        ``<path>.mat``; returns the ``.npz`` path. A failed write raises."""
        data = self.data()
        np.savez(self.path + ".npz", **data)
        try:
            import scipy.io
        except ImportError:   # scipy is optional: the .npz is the trace
            return self.path + ".npz"
        scipy.io.savemat(self.path + ".mat",
                         {k.replace("/", "_"): v for k, v in data.items()})
        return self.path + ".npz"


def scan_with_stream(body, carry, length: int, trace: TraceBuffer,
                     chunk: int = 64, ordered: bool = True):
    """Run ``length`` ticks of ``body(carry, None) -> (carry, channels)``
    (channels: a dict of named tensors) and stream the channels into
    ``trace``: each chunk of ``chunk`` ticks is stacked on the device and
    crosses to the host in one copy, then lands in ``trace.add_block``.
    The reference's loop runs as one device program with a host callback
    a chunk; this one is eager, its ticks dispatched from the host.
    ``ordered`` is kept for the reference's signature: an eager loop
    delivers its chunks in order. ``length`` must be a multiple of
    ``chunk``. Returns the final carry. Each copy counts one
    ``logger.host_copy`` (``telemetry``)."""
    if length % chunk != 0:
        raise ValueError(f"length {length} not a multiple of chunk {chunk}")
    for _ in range(length // chunk):
        ticks = []
        for _ in range(chunk):
            carry, channels = body(carry, None)
            ticks.append(channels)
        names = list(ticks[0])
        stacked = [torch.stack([t[k] for t in ticks]) for k in names]
        # every channel as float64 columns of one block: one copy a chunk
        block = torch.cat([v.reshape(chunk, -1).to(torch.float64)
                           for v in stacked], dim=1).cpu().numpy()
        telemetry.count("logger.host_copy")
        col = 0
        for name, v in zip(names, stacked):
            width = v[0].numel()
            trace.add_block(name, block[:, col:col + width].reshape(v.shape))
            col += width
    return carry


class Severity(enum.IntEnum):
    DEBUG = 10
    LOW = 15
    MID = 20
    HIGH = 30
    FATAL = 50


class ConsoleLogger:
    """Severity-leveled console logger (XBot::Logger analog)."""

    def __init__(self, name: str = "qppvm"):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "[%(asctime)s %(levelname)s %(name)s] %(message)s"))
            self._log.addHandler(h)
            self._log.setLevel(logging.INFO)

    def info(self, msg, *args, severity: Severity = Severity.MID):
        self._log.log(int(severity), msg, *args)

    def error(self, msg, *args):
        self._log.error(msg, *args)

    def warning(self, msg, *args):
        self._log.warning(msg, *args)

    def debug(self, msg, *args):
        self._log.debug(msg, *args)


_LOGGERS: Dict[str, ConsoleLogger] = {}


def get_logger(name: str = "qppvm") -> ConsoleLogger:
    """The process's one ConsoleLogger called ``name``."""
    if name not in _LOGGERS:
        _LOGGERS[name] = ConsoleLogger(name)
    return _LOGGERS[name]
