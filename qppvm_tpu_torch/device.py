"""Where the port's entry points put their tensors.

Every public entry point takes ``device`` and defaults to the CUDA card.
Where torch has no CUDA device that default raises: nothing drops silently
to the CPU. CPU callers, the tests among them, pass ``device="cpu"``.

Below: the settings of a plugin, its stack, tasks and constraints, and the
constants on the device made from them.
"""
from __future__ import annotations

import collections.abc

import torch

DEFAULT = torch.device("cuda")


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device where torch
    has none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return device


# --- settings and the constants made from them ---------------------------
#
# A plugin, its stack, tasks and constraints hold settings (gains, weights,
# bounds, row selections, solver options) that a tick reads and turns into
# tensors. ``constant`` makes such a tensor once and keeps it on the object
# it is made from, so the tick copies nothing from the host. Assigning an
# attribute of a ``Settings`` object drops its constants and counts a change
# on it (``changed``); a captured CUDA graph of the tick
# (runtime/tick_graph.py) compares ``changes`` of its plugin to see one.

_generation = 0
# while a tick is captured: the (tensor, version) its constants came from
sources = None


def generation() -> int:
    """How many changes of settings this process has counted."""
    return _generation


def changed(owner) -> None:
    """Count a change of a setting of ``owner`` and drop its constants
    (``Settings`` calls this on every assignment; a change made in place
    calls it itself)."""
    global _generation
    _generation += 1
    owner.__dict__["_changes"] = owner.__dict__.get("_changes", 0) + 1
    owner.__dict__.pop("_constants", None)


class Settings:
    """An object whose attributes are settings: assigning one anew counts a
    change (``changed``). A setting changed in place inside a list or a
    dict is not seen: assign it anew."""

    def __setattr__(self, name, value):
        changed(self)
        object.__setattr__(self, name, value)


def _objects(root) -> list:
    """``root``, if it is a ``Settings`` object, and every one it holds
    through attributes, lists, tuples and mappings, each once, in order."""
    seen, out = set(), []

    def walk(x):
        if isinstance(x, Settings):
            if id(x) in seen:
                return
            seen.add(id(x))
            out.append(x)
            for k, v in x.__dict__.items():
                if k != "_constants":
                    walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, collections.abc.Mapping):
            for v in x.values():
                walk(v)

    walk(root)
    return out


def changes(root) -> tuple:
    """(id, changes counted) of each ``Settings`` object of ``root``
    (``_objects``): it differs after any change of a setting that
    ``root``'s tick reads."""
    return tuple((id(o), o.__dict__.get("_changes", 0))
                 for o in _objects(root))


def attributes(root) -> list:
    """The attributes of each ``Settings`` object of ``root`` as they are
    now, their constants' table copied: whatever holds them holds every
    tensor that a tick could read through them."""
    return [{k: dict(v) if k == "_constants" else v
             for k, v in vars(o).items()} for o in _objects(root)]


def constant(owner, key, make, source=None):
    """``make()``, kept on ``owner`` under ``key`` (which names the value
    and holds the dtype and device it is made for) until a setting of
    ``owner`` is assigned anew. ``source``: the tensor the value is
    converted from; an in-place change of it makes the value anew."""
    values = owner.__dict__.setdefault("_constants", {})
    version = None if source is None else source._version
    if source is not None and sources is not None:
        sources.append((source, version))
    hit = values.get(key)
    if hit is None or hit[0] != version:
        hit = values[key] = (version, make())
    return hit[1]
