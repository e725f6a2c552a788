"""Horizon-parallel rollout: multiple shooting over a ring of ranks (port
of qppvm_tpu/parallel/ring_horizon.py).

The horizon ``T`` splits into ``S`` contiguous segments, one per rank of
mesh axis ``axis``. One sweep: every rank scans its segment from its
boundary guess, then hands its end carry to the next rank (a ring shift,
rank i to i + 1); rank 0 pins the true initial carry. After k sweeps the
first k segments are exact, so ``sweeps = S`` is the sequential rollout
run as S parallel scans a sweep; warm boundary guesses from the previous
plan make one or two sweeps enough.

Differentiation. The ring shift is an autograd function whose backward
shifts the gradient the other way round, and the final carry is a
broadcast from the last rank whose backward averages the ranks'
cotangents. The rule: every rank calls backward on the same loss of the
replicated final carry (plus, if it likes, terms of its own segment's
outputs), and the result is the gradient of that one loss, not of S copies
of it. Each rank's U.grad is nonzero on its own segment only; that slice
is the sequential rollout's gradient there. The backward runs
collectives, so every rank must run it, in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from qppvm_tpu_torch import tree as trees
from qppvm_tpu_torch.parallel.mesh import comm_device


class RingRolloutInfo(NamedTuple):
    """Diagnostics of a multiple-shooting rollout.

    defect: max-abs mismatch between each segment's settled entry guess
      and its predecessor's end carry, the largest over the ranks (0 when
      the rollout is exact); a 0-d tensor, detached.
    boundaries: this rank's settled entry carry with a leading axis of 1
      (its share of the reference's (S, ...) boundaries): feed it back as
      ``boundary_guess`` next plan for a warm one- or two-sweep rollout.
    """

    defect: torch.Tensor
    boundaries: Any


def _pack(xs):
    """One flat buffer per dtype, in order of first appearance."""
    groups = {}
    for x in xs:
        groups.setdefault(x.dtype, []).append(x.reshape(-1))
    return [torch.cat(v) for v in groups.values()]


def _unpack(bufs, like):
    out, offs = [], {}
    by_dtype = {b.dtype: b for b in bufs}
    for x in like:
        o = offs.get(x.dtype, 0)
        out.append(by_dtype[x.dtype][o:o + x.numel()].view(x.shape))
        offs[x.dtype] = o + x.numel()
    return out


def _shift(xs, group, step: int):
    """Each rank's tensors ``xs`` sent ``step`` ranks on along the ring of
    ``group``; returns what this rank receives, on xs's devices."""
    size = dist.get_world_size(group)
    if size == 1:
        return [x.detach().clone() for x in xs]
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % size)
    src = dist.get_global_rank(group, (r - step) % size)
    comm = comm_device(group)
    send = [b.to(comm) for b in _pack([x.detach() for x in xs])]
    recv = [torch.empty_like(b) for b in send]
    ops = ([dist.P2POp(dist.isend, b, dst, group, tag=i)
            for i, b in enumerate(send)]
           + [dist.P2POp(dist.irecv, b, src, group, tag=i)
              for i, b in enumerate(recv)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [y.to(x.device) for y, x in zip(_unpack(recv, xs), xs)]


def _from_last(xs, group):
    """The last rank of ``group``'s tensors ``xs`` on every rank."""
    size = dist.get_world_size(group)
    if size == 1:
        return [x.detach().clone() for x in xs]
    comm = comm_device(group)
    bufs = [b.to(comm) for b in _pack([x.detach() for x in xs])]
    src = dist.get_global_rank(group, size - 1)
    for b in bufs:
        dist.broadcast(b, src, group=group)
    return [y.to(x.device) for y, x in zip(_unpack(bufs, xs), xs)]


def _float_grads(ctx, grads, fn):
    """``fn`` over the gradients of the floating inputs only (the others
    have none), None in the other places."""
    fl = [i for i, x in enumerate(ctx.floating) if x]
    out = [None] * len(grads)
    for i, g in zip(fl, fn([grads[i] for i in fl])):
        out[i] = g
    return out


class _RingShift(torch.autograd.Function):
    """Send to rank + 1, receive from rank - 1; the gradient goes back."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.floating = [x.is_floating_point() for x in xs]
        return tuple(_shift(xs, group, +1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_float_grads(
            ctx, grads, lambda gs: _shift(gs, ctx.group, -1)))


class _FromLast(torch.autograd.Function):
    """The last rank's tensors on every rank; the backward averages the
    ranks' cotangents and hands them to the last rank (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.floating = [x.is_floating_point() for x in xs]
        return tuple(_from_last(xs, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_float_grads(
            ctx, grads, lambda gs: _mean_to_last(gs, ctx.group)))


def _mean_to_last(grads, group):
    """The ranks' mean of ``grads`` on the last rank, zeros elsewhere."""
    size = dist.get_world_size(group)
    if size == 1:
        return list(grads)
    comm = comm_device(group)
    bufs = [b.to(comm) for b in _pack(grads)]
    for b in bufs:
        dist.all_reduce(b, group=group)
        b /= size
    mean = [y.to(g.device) for y, g in zip(_unpack(bufs, grads), grads)]
    if dist.get_rank(group) != size - 1:
        mean = [torch.zeros_like(g) for g in mean]
    return mean


def _tensors(tree) -> Tuple[list, list]:
    """(paths, tensors) of the tree's tensor leaves."""
    items = [(p, v) for p, v in trees.leaves(tree)
             if isinstance(v, torch.Tensor)]
    return [p for p, _ in items], [v for _, v in items]


def _through(fn, group, tree):
    """``tree`` with its tensor leaves passed through the autograd
    function ``fn``."""
    paths, xs = _tensors(tree)
    values = dict(trees.leaves(tree))
    values.update(zip(paths, fn.apply(group, *xs)))
    return trees.rebuild(tree, values)


def _scan(step_fn, carry, U_seg, length: int, keep_outs: bool):
    """``lax.scan`` of ``step_fn`` over the segment's ``length`` steps;
    outputs stacked on a leading time axis."""
    outs = []
    for t in range(length):
        carry, out = step_fn(carry, trees.tree_map(lambda u: u[t], U_seg))
        if keep_outs:
            outs.append(out)
    if not keep_outs:
        return carry, None
    return carry, trees.tree_map(lambda *o: torch.stack(o), *outs)


def ring_rollout(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    x0: Any,
    U: Any,
    mesh,
    *,
    axis: str = "seg",
    sweeps: Optional[int] = None,
    boundary_guess: Optional[Any] = None,
) -> Tuple[Any, Any, RingRolloutInfo]:
    """Multiple-shooting rollout of ``step_fn`` with the horizon sharded
    over mesh axis ``axis``; every rank of the axis calls it.

    Args:
      step_fn: ``(carry, u_t) -> (carry, out_t)``, the body of a scan.
      x0: initial carry tree, the same on every rank.
      U: control tree, the same (whole) on every rank; every leaf has a
        leading time axis ``T`` divisible by the axis size ``S``. This
        rank rolls out segment ``rank``.
      mesh: DeviceMesh with ``axis``.
      sweeps: ring sweeps; None or >= S is exact (the sequential rollout).
      boundary_guess: this rank's entry-carry guess, each leaf with a
        leading axis of S (every segment's; this rank takes its own) or 1
        (this rank's, as ``info.boundaries`` returns it). Defaults to x0.

    Returns:
      ``(final_carry, outs, info)``: the final carry on every rank, this
      rank's segment of the outputs (leading axis T / S) and
      ``RingRolloutInfo``. The module docstring gives the gradient's rule.
    """
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    n_sweeps = S if sweeps is None else min(int(sweeps), S)
    if n_sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    T = _tensors(U)[1][0].shape[0]
    if T % S != 0:
        raise ValueError(f"horizon T={T} not divisible by segments S={S}")
    L = T // S
    U_seg = trees.tree_map(lambda u: u[idx * L:(idx + 1) * L], U)

    if boundary_guess is None:
        b = x0
    else:
        def own(g):
            if g.shape[0] not in (S, 1):
                raise ValueError(f"boundary_guess leaf of leading size "
                                 f"{g.shape[0]}: need {S} or 1")
            return g[idx] if g.shape[0] == S else g[0]
        b = trees.tree_map(own, boundary_guess)

    first = torch.tensor(idx == 0)

    def pin_first(prev_end):
        # a where, not a branch: rank 0's graph holds the received carry
        # too, so every rank's backward runs the same ring shifts
        return trees.tree_map(
            lambda g, p: torch.where(first.to(p.device), g, p), x0, prev_end)

    for _ in range(n_sweeps - 1):
        end, _ = _scan(step_fn, b, U_seg, L, keep_outs=False)
        b = pin_first(_through(_RingShift, group, end))

    # the final pass produces the outputs from the settled boundaries
    end, outs = _scan(step_fn, b, U_seg, L, keep_outs=True)
    with torch.no_grad():   # a monitor of the rollout, not part of it
        inc = pin_first(_through(_RingShift, group, end))
        gaps = [torch.max(torch.abs(a.double() - c.double()))
                for a, c in zip(_tensors(inc)[1], _tensors(b)[1])]
        defect = torch.stack(gaps).max() if gaps else torch.zeros(
            (), dtype=torch.float64)
        if S > 1:
            buf = defect.to(comm_device(group))
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
            defect = buf
        defect = defect.to(_tensors(end)[1][0].device)
    final = _through(_FromLast, group, end)
    settled = trees.tree_map(lambda x: x[None], b)
    return final, outs, RingRolloutInfo(defect=defect, boundaries=settled)
