"""Process groups, device meshes and sharding over torch.distributed (port
of qppvm_tpu/parallel/mesh.py).

The reference shards the MPC rollout batch over a JAX device mesh. Here
one process is one rank, a mesh is a ``DeviceMesh`` over every rank of the
default process group, and each rank computes on its own device, the one
its caller passes. The mesh's collectives run where the group's backend
reaches: NCCL on the cards when every rank of the host has a card of its
own, gloo through host memory otherwise (any number of ranks, several on
one card, or the CPU). A mesh of one rank takes the same code, so a
single-card run is no special case.

The reference's names: ``initialize_distributed``, ``make_mesh``,
``make_2d_mesh``, ``shard_batch``, ``replicate``, ``batch_spec``.
``run_ranks`` starts n ranks on this host, each a spawned process with its
own group timeout, for the multi-rank dryrun and the tests.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from qppvm_tpu_torch.tree import tree_map

# seconds a collective (and the group's rendezvous) may wait for its peers
GROUP_TIMEOUT_S = 60.0


def default_backend(num_processes: int) -> str:
    """NCCL where this host has a card for each of its ranks, else gloo
    (NCCL refuses two ranks on one card)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join the default process group; a no-op for one process.
    ``coordinator`` is ``host:port`` (TCP), a ``tcp://`` or ``file://``
    URL, or None for the ``env://`` variables a launcher such as torchrun
    sets. Under NCCL the rank's card becomes the current device
    (LOCAL_RANK, else the rank modulo the cards)."""
    if num_processes is None or num_processes <= 1:
        return
    init = coordinator or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    backend = default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _ensure_group() -> None:
    """A process outside any group starts a one-rank gloo group (an
    in-process store: nothing leaves the process)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_group()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    comm = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(comm, shape, mesh_dim_names=axes)


def make_mesh(n_devices: Optional[int] = None, axis: str = "rollout"):
    """1-D mesh over the group's ranks (``n_devices``, when given, must be
    the group's size)."""
    _ensure_group()
    return _mesh((n_devices or dist.get_world_size(),), (axis,))


def make_2d_mesh(shape: Sequence[int], axes=("host", "rollout")):
    """2-D mesh over the group's ranks, row-major."""
    return _mesh(tuple(int(s) for s in shape), tuple(axes))


class BatchSpec(NamedTuple):
    """Where a batch lives: its leading axis split over ``axis`` of
    ``mesh`` (the reference's NamedSharding(mesh, P(axis)))."""

    mesh: Any
    axis: Union[str, Tuple[str, ...]]


def batch_spec(mesh, axis: Union[str, Tuple[str, ...]] = "rollout"
               ) -> BatchSpec:
    return BatchSpec(mesh, axis)


def share(mesh, axis: Union[str, Tuple[str, ...]] = "rollout"
          ) -> Tuple[int, int]:
    """(this rank's index, the number of shares) over ``axis``, or over
    several axes flattened row-major (the reference's P(mesh.axis_names))."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    index, count = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        index, count = index * size + mesh.get_local_rank(a), count * size
    return index, count


def shard_batch(tree, mesh, axis: Union[str, Tuple[str, ...]] = "rollout"):
    """This rank's contiguous share of every leaf's leading (batch) axis
    over ``axis``; ValueError where that axis does not divide."""
    index, count = share(mesh, axis)

    def take(x):
        if x.shape[0] % count:
            raise ValueError(f"batch of {x.shape[0]} does not divide over "
                             f"{count} shares of mesh axis {axis!r}")
        k = x.shape[0] // count
        return x[index * k:(index + 1) * k]
    return tree_map(take, tree)


def comm_device(group=None) -> torch.device:
    """Where ``group``'s collectives take their tensors: the card under
    NCCL, host memory under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate(tree, mesh):
    """Every tensor leaf as the mesh's first rank holds it, on each rank
    (a broadcast over the whole mesh); each leaf keeps its own device."""
    src = int(mesh.mesh.flatten()[0])
    comm = comm_device()

    def bcast(x):
        buf = x.detach().to(comm).clone()
        dist.broadcast(buf, src)
        return buf.to(x.device)
    return tree_map(bcast, tree)


def all_gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The leading-axis concatenation of every rank's ``x`` in the mesh's
    row-major order, on x's device (same shape on every rank)."""
    comm = comm_device()
    wire = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = x.detach().to(comm, wire).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    order = [int(r) for r in mesh.mesh.flatten()]
    return torch.cat([parts[r] for r in order]).to(x.device, x.dtype)


def _rank_main(fn, rank, n_ranks, init, timeout_s, args, results):
    try:
        initialize_distributed(init, n_ranks, rank, timeout_s)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n_ranks: int, args: tuple = (), *,
              timeout_s: float = 600.0, group_timeout_s: float = 30.0,
              init_file: Optional[str] = None) -> list:
    """``fn(rank, *args)`` on ``n_ranks`` spawned processes of one process
    group (rendezvous through ``init_file``, a path that must not exist
    yet; a fresh temporary one by default). ``fn`` must be importable by
    its module path and return a picklable host value; returns the values
    in rank order. Raises, with each failed rank's traceback, when a rank
    fails or the ranks are not all done within ``timeout_s``; every
    process is ended before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = None
    if init_file is None:
        tmp = tempfile.TemporaryDirectory()
        init_file = os.path.join(tmp.name, "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, n_ranks, f"file://{os.path.abspath(init_file)}",
        group_timeout_s, args, results)) for r in range(n_ranks)]
    done, errors, started = {}, {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(done) < n_ranks and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                errors.update({r: f"exit code {p.exitcode}"
                               for r, p in enumerate(procs)
                               if p.exitcode and r not in done})
                continue
            (done if ok else errors)[rank] = value
    finally:
        for p in started:
            p.join(timeout=5.0 if len(done) == n_ranks else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            tmp.cleanup()
    if len(done) < n_ranks:
        msg = "".join(f"\nrank {r}: {e}" for r, e in sorted(errors.items()))
        if not errors:
            msg = (f"\nranks {sorted(set(range(n_ranks)) - set(done))} not "
                   f"done within {timeout_s} s")
        raise RuntimeError(f"run_ranks({n_ranks}) failed:{msg}")
    return [done[r] for r in range(n_ranks)]
