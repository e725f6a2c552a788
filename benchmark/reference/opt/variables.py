"""Optimization-variable algebra (port of qppvm_tpu/opt/variables.py):
named segments of the stacked QP decision variable and affine views over
it. ``AffineExpr.M`` / ``.c`` are unbatched structural tensors; composing
them with batched task data broadcasts over the batch. The algebra is the
reference's (OpenSoT's AffineHelper): ``/`` stacks rows, ``+`` / ``-``
combine expressions or shift by a constant, ``A @ expr`` composes on the
left, and ``AffineExpr.zero`` pads a stack with rows that select nothing
(the source system's ForceAcc.cpp:81).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import device as devices


@dataclasses.dataclass(frozen=True)
class AffineExpr:
    """value(x) = M @ x + c."""

    M: torch.Tensor  # (k, n)
    c: torch.Tensor  # (k,)

    # numpy defers ``array @ expr`` to __rmatmul__
    __array_ufunc__ = None

    @property
    def size(self) -> int:
        return self.M.shape[0]

    @property
    def input_size(self) -> int:
        return self.M.shape[1]

    def _const(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.M.dtype, device=self.M.device)

    def __truediv__(self, other: "AffineExpr") -> "AffineExpr":
        """Vertical stack: self's rows, then other's."""
        return AffineExpr(M=torch.cat([self.M, other.M]),
                          c=torch.cat([self.c, other.c]))

    def __add__(self, other) -> "AffineExpr":
        if isinstance(other, AffineExpr):
            return AffineExpr(M=self.M + other.M, c=self.c + other.c)
        return AffineExpr(M=self.M, c=self.c + self._const(other))

    def __sub__(self, other) -> "AffineExpr":
        if isinstance(other, AffineExpr):
            return AffineExpr(M=self.M - other.M, c=self.c - other.c)
        return AffineExpr(M=self.M, c=self.c - self._const(other))

    def __neg__(self) -> "AffineExpr":
        return AffineExpr(M=-self.M, c=-self.c)

    def __rmatmul__(self, A) -> "AffineExpr":
        """Left composition with a matrix: A @ expr."""
        A = self._const(A)
        return AffineExpr(M=A @ self.M, c=A @ self.c)

    def value(self, x):
        """This expression's value at solutions x (B, n) -> (B, k)."""
        return x @ self.M.transpose(-1, -2) + self.c

    def rows(self, idx) -> "AffineExpr":
        """The expression's rows ``idx``."""
        idx = list(idx)
        return AffineExpr(M=self.M[idx], c=self.c[idx])

    @staticmethod
    def zero(input_size: int, k: int, dtype=torch.float32,
             device=devices.DEFAULT) -> "AffineExpr":
        """k rows of zeros over an input of ``input_size``."""
        kw = dict(dtype=dtype, device=devices.resolve(device))
        return AffineExpr(M=torch.zeros((k, input_size), **kw),
                          c=torch.zeros(k, **kw))


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

    def slice_of(self, name: str) -> slice:
        """Where segment ``name`` lies in the decision variable."""
        return self._slices[name]

    def names(self) -> List[str]:
        """The segments' names, in order."""
        return list(self._slices)
