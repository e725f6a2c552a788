"""The control tick as one CUDA graph: captured once for each layout of its
inputs, then replayed, so the host dispatches one graph launch where the
eager tick dispatches every operation of every layer.

``TickGraph(body, settings=plugin)`` wraps a plugin's tick body,
``body(state, refs, warm) -> (tau, warm_new, aux)``, and is called as the
body is. The routing rule,
read off the inputs alone: the graph takes a tick when every tensor of
``state``, ``refs`` and ``warm`` is float32 on one CUDA device and none
needs a gradient, and no Python dispatch mode is active (a mode that counts
or rewrites operations has to see them run). Any other tick runs the body
eagerly, as do the CPU, float64 and autograd.

The key of a graph is the inputs' layout (``layout``): the tree's structure
(dicts with their keys in order, tuples, lists, dataclasses), each tensor's
shape and dtype, the value of every other leaf, the device, and the float32
matmul settings a capture bakes in. The first tick of a key runs eagerly, so
that the libraries the body calls are initialised before a capture; the
second captures the body (counted ``tick_graph.capture``) and replays it;
every later tick of the key replays it (each replay counted
``tick_graph.replay``). A key whose eager tick hands back a tensor that
needs a gradient, or whose capture fails, stays eager. ``CAPACITY`` graphs
are kept, the least recently used dropped first.

A replay is one ``torch._foreach_copy_`` of the inputs into the graph's
static buffers (a second one for inputs whose strides the buffers lack: an
expanded reference), one graph launch, and a contiguous clone of each
output, in memory of its own: a caller may keep the outputs of a tick
across later ticks.

What the body reads besides its inputs, a graph reads as it was at the
capture: the settings of the plugin, its stack, tasks and constraints
(gains, weights, bounds, solver options), and the tensors they were made
into. So assigning a setting of ``settings`` or of any object it holds
(``device.Settings``: ``task.weight = w``, ``set_stiffness_damping``,
``plugin.iters = n``, ``stack << c``) drops every graph of the tick: the
next tick runs eagerly and the one after captures anew, as for a new
layout. A tick first compares one counter of the process
(``device.generation``) and walks ``settings`` (``device.changes``) only
when that has moved. A setting changed in place inside a list or a dict is
not seen (the plugins' solver options are read-only for that reason). A
graph also records the tensors its constants were converted from
(``device.constant``) and is dropped, its tick run eagerly, once one of
them has changed in place. A tensor setting already on the tick's device
in its dtype is read where it lies, so a change of it in place reaches the
replay. A graph keeps the settings' attributes as they were at its capture
(``device.attributes``), so no tensor it reads is freed while it lives. A
function the body calls, patched after the capture, does not reach it.

Telemetry: the span ``tick.graph`` covers the copies, the capture and the
replay; what the body counts while it is captured (kernel launches, levels,
plain routes) is held back (``telemetry.held``) and added again at every
replay, so a counter reads what ran.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import warnings
from typing import Any, Callable, List, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch import telemetry

# graphs kept per TickGraph; keys seen once (eagerly) kept per TickGraph
CAPACITY = 4
SEEN = 16


@functools.lru_cache(maxsize=None)
def _field_names(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def _flatten(tree, leaves: List[torch.Tensor]):
    """The structure of ``tree`` with each tensor's (shape, dtype) and
    every other leaf's value; appends the tensors to ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return tree.shape, tree.dtype
    if isinstance(tree, dict):
        return dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_flatten(v, leaves) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree), tuple(_flatten(getattr(tree, f), leaves)
                                 for f in _field_names(type(tree)))
    return type(tree), tree


def _rebuild(tree, tensors):
    """``tree`` with its tensors, in ``_flatten``'s order, replaced by the
    next ones of the iterator ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, tensors) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f: _rebuild(getattr(tree, f), tensors)
                             for f in _field_names(type(tree))})
    return tree


def refusal(leaves: List[torch.Tensor]) -> Optional[str]:
    """Why the graph does not take a tick with tensors ``leaves``, or
    None where it takes it (the routing rule, without the dispatch
    mode)."""
    if not leaves:
        return "no tensor"
    device = leaves[0].device
    for t in leaves:
        if t.requires_grad:
            return "a tensor needs a gradient"
        if t.dtype != torch.float32:
            return f"a tensor is {t.dtype}"
        if not t.is_cuda or t.device != device:
            return "the tensors are not on one CUDA device"
    return None


def layout(state, refs, warm):
    """(key, tensors) of a tick's inputs; the key is None where a leaf
    that is not a tensor cannot be hashed."""
    leaves: List[torch.Tensor] = []
    key = _flatten((state, refs, warm), leaves)
    key = (key, leaves[0].device if leaves else None,
           torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32)
    try:
        hash(key)
    except TypeError:
        return None, leaves
    return key, leaves


class _Graph:
    """One captured tick: its graph, its static input buffers, its outputs
    (the captured body's, which every replay writes), the counts its body
    held back, the
    tensors its constants were converted from, with their versions, and the
    settings' attributes at the capture, which keep every tensor it reads
    alive."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.static = [
            torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                device=t.device) if t.is_contiguous()
            else torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in leaves]
        self.strides = [s.stride() for s in self.static]
        self.graph = None        # the torch.cuda.CUDAGraph, once captured
        self.template = None     # the outputs' tree
        self.outs: List[torch.Tensor] = []
        self.counts = collections.Counter()
        self.sources = ()
        self.kept = ()           # the settings' attributes at the capture

    def current(self) -> bool:
        """Whether no tensor a constant of the capture came from has
        changed in place since."""
        return all(t._version == v for t, v in self.sources)

    def copy_in(self, leaves: List[torch.Tensor]) -> None:
        fast_dst, fast_src, slow_dst, slow_src = [], [], [], []
        for dst, stride, src in zip(self.static, self.strides, leaves):
            if src.stride() == stride:
                fast_dst.append(dst)
                fast_src.append(src)
            else:
                slow_dst.append(dst)
                slow_src.append(src)
        if fast_dst:
            torch._foreach_copy_(fast_dst, fast_src)
        if slow_dst:
            torch._foreach_copy_(slow_dst, slow_src)

    def keep(self, outs) -> None:
        """Record the captured body's outputs ``outs``."""
        self.template = outs
        self.outs = []
        _flatten(outs, self.outs)

    def outputs(self):
        """The last replay's outputs, in memory of their own."""
        return _rebuild(self.template, iter([
            t.clone(memory_format=torch.contiguous_format)
            for t in self.outs]))

    def replay(self, leaves: List[torch.Tensor]):
        self.copy_in(leaves)
        self.graph.replay()
        for name, k in self.counts.items():
            telemetry.count(name, k)
        telemetry.count("tick_graph.replay")
        return self.outputs()


class TickGraph:
    """A tick body through CUDA graphs where the routing rule takes its
    inputs (the module's docstring), else eagerly. ``settings``: the object
    whose settings the body reads (its plugin)."""

    def __init__(self, body: Callable[..., Any], settings=None):
        self.body = body
        self.settings = settings
        self._graphs: "collections.OrderedDict[Any, _Graph]" = \
            collections.OrderedDict()
        # key -> whether the key may be captured, from its eager tick
        self._seen: "collections.OrderedDict[Any, bool]" = \
            collections.OrderedDict()
        self._generation = device_lib.generation()
        self._changes = device_lib.changes(settings)

    def __call__(self, state, refs, warm):
        key, leaves = layout(state, refs, warm)
        if (key is None or refusal(leaves) is not None
                or _get_current_dispatch_mode() is not None):
            return self.body(state, refs, warm)
        if self._generation != device_lib.generation():
            self._generation = device_lib.generation()
            changes = device_lib.changes(self.settings)
            if changes != self._changes:
                # a setting the body reads changed: every graph read it
                self._changes = changes
                self._graphs.clear()
                self._seen.clear()
        graph = self._graphs.get(key)
        if graph is not None:
            if graph.current():
                self._graphs.move_to_end(key)
                with telemetry.span("tick.graph"):
                    return graph.replay(leaves)
            # a source changed in place: this tick makes the constants
            # anew eagerly, the next one captures
            del self._graphs[key]
            return self.body(state, refs, warm)
        capturable = self._seen.get(key)
        if capturable is None:
            outs = self.body(state, refs, warm)
            self._remember(key, _capturable(outs, leaves[0].device))
            return outs
        if not capturable:
            return self.body(state, refs, warm)
        with telemetry.span("tick.graph"):
            graph = self._capture((state, refs, warm), leaves)
            if graph is not None:
                self._graphs[key] = graph
                if len(self._graphs) > CAPACITY:
                    self._graphs.popitem(last=False)
                return graph.replay(leaves)
        self._seen[key] = False
        return self.body(state, refs, warm)

    def _remember(self, key, capturable: bool) -> None:
        self._seen[key] = capturable
        if len(self._seen) > SEEN:
            self._seen.popitem(last=False)

    def _capture(self, inputs, leaves) -> Optional[_Graph]:
        graph = _Graph(leaves)
        graph.copy_in(leaves)
        static = _rebuild(inputs, iter(graph.static))
        graph.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream()
        device_lib.sources = sources = []
        # no collection inside the capture: a graph freed there (a dead
        # plugin's, held in a cycle) releases its memory, which a capture
        # forbids, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            with telemetry.held() as held:
                with torch.cuda.graph(graph.graph,
                                      capture_error_mode="thread_local"):
                    graph.keep(self.body(*static))
        except Exception as e:  # noqa: BLE001 - any failed capture
            torch.cuda.set_stream(stream)
            warnings.warn(f"the tick's CUDA graph capture failed ({e!r}); "
                          "this input layout runs eagerly", RuntimeWarning)
            return None
        finally:
            device_lib.sources = None
            if collecting:
                gc.enable()
        graph.counts = held
        graph.sources = tuple(sources)
        graph.kept = device_lib.attributes(self.settings)
        telemetry.count("tick_graph.capture")
        return graph


def _capturable(outs, device) -> bool:
    """Whether a graph can hand back ``outs`` (the eager tick's): every
    tensor on ``device``, none that needs a gradient."""
    tensors: List[torch.Tensor] = []
    _flatten(outs, tensors)
    return all(t.device == device and not t.requires_grad for t in tensors)
