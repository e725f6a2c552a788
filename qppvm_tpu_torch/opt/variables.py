"""Optimization-variable algebra (port of qppvm_tpu/opt/variables.py):
named segments of the stacked QP decision variable and affine views over
it. ``AffineExpr.M`` / ``.c`` are unbatched structural tensors; composing
them with batched task data broadcasts over the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from qppvm_tpu_torch import device as devices


@dataclasses.dataclass(frozen=True)
class AffineExpr:
    """value(x) = M @ x + c."""

    M: torch.Tensor  # (k, n)
    c: torch.Tensor  # (k,)

    @property
    def size(self) -> int:
        return self.M.shape[0]

    def value(self, x):
        """This expression's value at solutions x (B, n) -> (B, k)."""
        return x @ self.M.transpose(-1, -2) + self.c

    def rows(self, idx) -> "AffineExpr":
        """The expression's rows ``idx``."""
        idx = list(idx)
        return AffineExpr(M=self.M[idx], c=self.c[idx])


class Optvar:
    """Named segments of one stacked decision variable."""

    def __init__(self, variables: Sequence[Tuple[str, int]],
                 dtype=torch.float32, device=devices.DEFAULT):
        self._slices: Dict[str, slice] = {}
        self.dtype = dtype
        self.device = devices.resolve(device)
        off = 0
        for name, sz in variables:
            if name in self._slices:
                raise ValueError(f"duplicate variable {name!r}")
            self._slices[name] = slice(off, off + sz)
            off += sz
        self.size = off

    def __getitem__(self, name: str) -> AffineExpr:
        s = self._slices[name]
        k = s.stop - s.start
        M = np.zeros((k, self.size))
        M[:, s] = np.eye(k)
        kw = dict(dtype=self.dtype, device=self.device)
        return AffineExpr(M=torch.as_tensor(M, **kw), c=torch.zeros(k, **kw))
