"""Checkpoint and resume of a control session (port of
qppvm_tpu/runtime/checkpoint.py).

A session's whole state (robot state, task references, the QP warm states
with their carried KKT inverses and adapted rho, an MPC plan) is a tree of
dicts, tuples, lists and dataclasses over tensors. ``save`` writes its
leaves to one ``.npz`` under their paths in the tree; ``load`` restores
them into the structure, dtypes and devices of a live example, so a resumed
session continues bit-identically.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from qppvm_tpu_torch.tree import leaves, rebuild


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any) -> str:
    """Save the leaves of ``tree`` to ``path`` (.npz appended if missing);
    returns the file's path."""
    path = _npz(path)
    np.savez(path, **{k: (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
                      for k, v in leaves(tree)})
    return path


def load(path: str, example: Any) -> Any:
    """The tree saved at ``path``, in the structure of ``example``, each
    leaf with its example's dtype and device. A leaf missing from the file
    raises KeyError; one of another shape raises ValueError."""
    values = {}
    with np.load(_npz(path)) as data:
        for key, ex in leaves(example):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            shape = tuple(ex.shape) if hasattr(ex, "shape") else np.shape(ex)
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                                 f"{arr.shape} vs live {shape}")
            values[key] = (torch.as_tensor(arr, dtype=ex.dtype,
                                           device=ex.device)
                           if isinstance(ex, torch.Tensor)
                           else np.asarray(arr, dtype=np.asarray(ex).dtype))
    return rebuild(example, values)


def save_session(path: str, *, state, refs, warm, plan=None) -> str:
    """Checkpoint a whole control or MPC session."""
    session = {"state": state, "refs": refs, "warm": warm}
    if plan is not None:
        session["plan"] = plan
    return save(path, session)


def load_session(path: str, *, state, refs, warm, plan=None):
    """(state, refs, warm[, plan]) of a session saved by ``save_session``,
    in the structure of the live ones given."""
    example = {"state": state, "refs": refs, "warm": warm}
    if plan is not None:
        example["plan"] = plan
    out = load(path, example)
    if plan is not None:
        return out["state"], out["refs"], out["warm"], out["plan"]
    return out["state"], out["refs"], out["warm"]
