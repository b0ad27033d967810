"""Runs over several processes (port of
`blindshadowremoval_tpu/parallel/distributed.py`), and the collectives the
port's sharded paths reduce with.

Every process calls `initialize()` (the coordinator's address from the
arguments or from torchrun's environment), builds the same mesh over all
ranks with `global_mesh`, and feeds only its own rows of each batch
(`host_local_batch`).  Inside `with mesh:` the train step all-reduces what
XLA all-reduces in the JAX package: the BatchNorm moments, the masked
losses' denominators, the gradients and the returned losses.  One process
drives one device; the backend follows it (NCCL for CUDA, gloo for the
CPU), unless the caller names one (gloo also reduces CUDA tensors, so
several gloo ranks can share one card).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None, device=None) -> None:
    """Join the job's process group (no-op for a single process, apart from
    recording this process's device for `local_device`).

    Defaults come from torchrun's environment: MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE, RANK; the device is CUDA (cuda:LOCAL_RANK, or the rank
    modulo the local cards) unless `device` says otherwise, and the backend
    NCCL for CUDA, gloo for the CPU."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    nproc = num_processes or int(os.environ.get("WORLD_SIZE", "0") or 0)
    pid = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    one = not addr or nproc <= 1
    dev = _rank_device(device, 0 if one else pid)
    _LOCAL.device = dev
    if one:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid)


@dataclasses.dataclass
class _Local:
    device: torch.device | None = None


_LOCAL = _Local()   # the device `initialize` bound this process to


def _rank_device(device, pid: int) -> torch.device:
    """`resolve_device(device)`, a CUDA device without an index made
    cuda:LOCAL_RANK (torchrun), else cuda:(pid modulo the local cards) on a
    rank other than the first."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            dev = torch.device("cuda", int(local))
        elif pid:
            dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def local_device() -> torch.device:
    """The device `initialize` bound this process to; before it, CUDA
    (cuda:LOCAL_RANK under torchrun), as every entry point of the port
    defaults."""
    return _LOCAL.device or _rank_device(None, 0)


def global_mesh(shape: Sequence[int] | None = None,
                axis_names: Sequence[str] = ("data", "frame"),
                device=None) -> Mesh:
    """Mesh over ALL ranks of the job, rank r at position r in row-major
    order, with a process group for each axis and for all of them (none
    before `initialize`, on a single process).  Every rank calls it, with
    the same arguments; `device` is this rank's (default: the one
    `initialize` bound)."""
    joined = dist.is_initialized()
    n = dist.get_world_size() if joined else 1
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} global devices")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} for axes "
                         f"{tuple(axis_names)}")
    rank = dist.get_rank() if joined else 0
    devs = [torch.device(device) if device is not None else local_device()]
    if joined:
        names = [None] * n
        dist.all_gather_object(names, str(devs[0]))
        devs = [torch.device(d) for d in names]
    ranks = np.arange(n).reshape(tuple(shape))
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    groups = {tuple(axis_names): dist.group.WORLD if joined else None}
    for i, name in enumerate(axis_names):
        # every rank creates every group, in the same order
        for members in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in members]) if joined \
                else None
            if rank in members:
                groups[name] = g
    return Mesh(grid.reshape(tuple(shape)), tuple(axis_names), ranks=ranks,
                groups=groups, rank=rank)


def host_local_batch(global_batch_size: int) -> tuple[int, int]:
    """(local_batch_size, local_offset) for this process's rows of a batch
    laid out contiguously across processes."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if global_batch_size % nproc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{nproc} processes")
    local = global_batch_size // nproc
    return local, pid * local


@dataclasses.dataclass
class LocalShard:
    """This process's rows of a batch split over the ranks: `data` on the
    rank's device, rows [offset, offset + len(data)) of `global_rows`."""

    data: torch.Tensor
    offset: int
    global_rows: int


def make_global_array(local_data, mesh: Mesh,
                      spec=("data",)) -> LocalShard:
    """This process's shard of a batch split over `spec[0]`'s axes
    (jax.make_array_from_process_local_data).  torch has no global
    tensor: the result is the local rows on this rank's device, tagged
    with their place in the global batch (the shard index of this rank
    along those axes, in mesh order, times the local rows)."""
    data = torch.as_tensor(np.asarray(local_data)).to(mesh.local_device)
    first = spec[0]
    axes = (first,) if isinstance(first, str) else tuple(first)
    names = mesh.axis_names
    pos = np.argwhere(mesh.ranks == mesh.rank)[0]
    index, count = 0, 1
    for a in axes:
        size = mesh.devices.shape[names.index(a)]
        index = index * size + int(pos[names.index(a)])
        count *= size
    rows = data.shape[0]
    return LocalShard(data, index * rows, count * rows)


# ---------------------------------------------------------------- collectives
class _AllMax(torch.autograd.Function):
    """Max over the group's ranks; the summed output gradient goes to the
    ranks holding the max, split evenly between ties (as a local max's)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ctx.group = group
        ctx.save_for_backward((x == out).to(x.dtype))
        return out

    @staticmethod
    def backward(ctx, grad):
        (hit,) = ctx.saved_tensors
        both = torch.stack([grad.contiguous(), hit])
        dist.all_reduce(both, group=ctx.group)
        return both[0] * hit / both[1], None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`'s ranks, on every rank; the backward
    sums the gradient over the ranks."""
    return dist_nn.all_reduce(x, group=group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over `group`'s ranks, differentiable."""
    return _AllMax.apply(x, group)


def mean_gradients(grads: Sequence[torch.Tensor], group) -> list:
    """The mean of each gradient over `group`'s ranks: the list flattened
    into one tensor, one all-reduce.  The result is bitwise the same on
    every rank."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [part.view_as(g) for g, part in
            zip(grads, flat.split([g.numel() for g in grads]))]
