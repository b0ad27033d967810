"""Device meshes and batch layouts (port of
`blindshadowremoval_tpu/parallel/mesh.py`).

The JAX package expresses parallelism through `jax.sharding`: a Mesh of
devices with named axes, a PartitionSpec per array, and XLA's partitioner
inserting the collectives:

  * axis "data": data parallelism, batch groups split over devices and the
    gradients all-reduced;
  * axis "frame": the TSM frame axis split over devices, ShareLayer's max
    and mean becoming collectives.

PyTorch has no partitioner, so the port does by hand what XLA does there.
A `Mesh` is a named grid of devices.  Built by `make_mesh` it holds local
devices, and `shard_batch` / `gather` split a batch over them and put it
back together (the service's replicas).  Built by
`parallel/distributed.py:global_mesh` it is a grid of processes, one
device each, with one process group per axis; inside `with mesh:` the
train-mode BatchNorms (models/blocks.py), the masked losses'
denominators (train/losses.py), the train step's draws and gradients
(train/trainer.py) and the collective ShareLayer (models/generator_tsm.py)
reduce over those groups.  `NamedSharding` and `PartitionSpec` keep the
JAX package's names for what a batch is split over.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Sequence

import numpy as np
import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec: entry i names the mesh axis (or tuple of
    axes) that dimension i is split over; () is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh).

    `devices` holds a torch.device per position.  On a mesh over processes
    (`global_mesh`), `ranks` holds each position's rank, `groups` maps each
    axis name, and the tuple of all of them, to its process group, and
    `rank` is this process's rank; on a local mesh they are None and
    empty.  `with mesh:` makes it the active mesh (`active_mesh`)."""

    devices: np.ndarray
    axis_names: tuple
    ranks: np.ndarray | None = None
    groups: dict = dataclasses.field(default_factory=dict)
    rank: int | None = None

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self._tokens: list = []

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (as jax's Mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axes: str | Sequence[str]):
        """The process group of this process over `axes` (one name, or a
        tuple of names flattened in mesh order); a mesh over processes
        only."""
        key = axes if isinstance(axes, str) else tuple(axes)
        if self.ranks is None:
            raise ValueError("a local mesh has no process groups: build it "
                             "over processes (distributed.global_mesh)")
        if key not in self.groups:
            raise ValueError(f"no mesh axis {key!r} in {self.axis_names}")
        return self.groups[key]

    @property
    def local_device(self) -> torch.device:
        """This process's device on a mesh over processes."""
        pos = np.argwhere(self.ranks == self.rank)[0]
        return self.devices[tuple(pos)]

    def __enter__(self) -> "Mesh":
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())


def active_mesh() -> Mesh | None:
    """The mesh of the innermost `with mesh:` of this thread, or None."""
    return _ACTIVE.get()


def batch_group():
    """The process group a train-mode batch is split over: every rank of
    the active mesh over processes (the batch is split over all its axes,
    as the JAX train step's P(("data", "frame"))).  None outside such a
    mesh, or on a process that has not joined a process group."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.ranks is None:
        return None
    return mesh.group(mesh.axis_names)


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data", "frame"),
              devices: Sequence | None = None) -> Mesh:
    """A Mesh over `devices` (default: every local CUDA device; raises
    without one).  Default shape: all devices on the first axis, the
    others of size 1.  A device may stand at several positions (two
    entries on one card)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass devices="
                               "[torch.device('cpu'), ...] for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), tuple(axis_names))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """How a [B, ...] array lies on a mesh (jax.sharding.NamedSharding):
    dimension 0 split over the axes `spec[0]` names, replicated over the
    others."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def split_axes(self) -> tuple:
        if not self.spec or self.spec[0] is None:
            return ()
        first = self.spec[0]
        return (first,) if isinstance(first, str) else tuple(first)

    @property
    def num_shards(self) -> int:
        shape = self.mesh.shape
        return int(np.prod([shape[a] for a in self.split_axes]))

    @property
    def devices(self) -> list:
        """The device of each shard, in order: the mesh position with the
        other axes at 0 (the JAX package keeps a copy at each of the other
        positions; here only the first is made)."""
        names = self.mesh.axis_names
        for a in self.split_axes:
            if a not in names:
                raise ValueError(f"no mesh axis {a!r} in {names}")
        order = [names.index(a) for a in self.split_axes]
        rest = [i for i in range(len(names)) if i not in order]
        grid = np.transpose(self.mesh.devices, order + rest)
        return list(grid.reshape(self.num_shards, -1)[:, 0])


def batch_sharding(mesh: Mesh, *, frame_axis: bool = False) -> NamedSharding:
    """Sharding for [B, ...] batches: B split over data (and optionally
    the flattened frame groups over frame)."""
    if frame_axis:
        return NamedSharding(mesh, P(("data", "frame")))
    return NamedSharding(mesh, P("data"))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x: torch.Tensor, sharding: NamedSharding) -> list:
    """`x` [B, ...] cut into `sharding.num_shards` contiguous row blocks,
    block i on `sharding.devices[i]` (a view where it already lies
    there)."""
    n = sharding.num_shards
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} not divisible by the "
                         f"{n} shards of {sharding.spec}")
    return [part.to(dev) for part, dev in
            zip(x.chunk(n), sharding.devices)]


def gather(shards: Sequence[torch.Tensor],
           device: torch.device | None = None) -> torch.Tensor:
    """The row blocks of `shard_batch` put back in order, on `device`
    (default: the first block's)."""
    dev = shards[0].device if device is None else device
    return torch.cat([s.to(dev) for s in shards])
