"""Device meshes of the port: named axes over a grid of ranks.

The counterpart of ``music_analyst_tpu/parallel/mesh.py``.  JAX's mesh is
one process addressing every device; in PyTorch a mesh is a grid of
*ranks* — one process per device, the layout of Megatron and of
``torch.distributed.device_mesh`` — with one process group per mesh axis.
Axis names and their meaning are JAX's:

* ``dp`` — data parallel (batch / corpus shards), the outermost axis;
* ``tp`` — tensor parallel (weight shards over heads, hidden and vocab);
* ``sp``, ``ep``, ``pp`` — named by :func:`factor_devices` as in JAX.

Rank ``r`` sits where device ``r`` sits in JAX's
``np.asarray(devices).reshape(spec.shape)`` (row-major, ``dp`` slowest),
so a rank's shard of a sharded array is the JAX device's shard.  It
computes on ``cuda:(r % device_count)`` (several ranks may share one
card), or on the CPU for the tests.

Without a process group a mesh has one device, and every collective of
this module is the identity: engine code runs unchanged on one device.
Collectives over an axis stage through host memory when the group's
backend is gloo (``multihost.transport_device``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named axis→size assignment; its product is the device count."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(size for _, size in self.axes)

    def size(self) -> int:
        return math.prod(self.shape)


def factor_devices(
    n_devices: int,
    axis_names: Sequence[str] = ("dp", "tp", "sp"),
    fixed: Optional[Dict[str, int]] = None,
) -> MeshSpec:
    """Factor ``n_devices`` across named axes, largest factors first
    (JAX's greedy rule, step for step: ``fixed`` sizes first, then
    near-even divisors of the rest, the largest to the earliest free
    axis)."""
    fixed = dict(fixed or {})
    remaining = n_devices
    for name, size in fixed.items():
        if remaining % size != 0:
            raise ValueError(
                f"fixed axis {name}={size} does not divide {remaining}"
            )
        remaining //= size
    free_axes = [a for a in axis_names if a not in fixed]
    factors: List[int] = []
    for i in range(len(free_axes)):
        slots_left = len(free_axes) - i
        if slots_left == 1:
            factors.append(remaining)
            remaining = 1
            break
        target = max(1, round(remaining ** (1.0 / slots_left)))
        best = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                best = cand
                break
        for cand in range(target + 1, remaining + 1):
            if remaining % cand == 0:
                if abs(cand - target) < abs(best - target):
                    best = cand
                break
        factors.append(best)
        remaining //= best
    sizes: Dict[str, int] = dict(fixed)
    for name, factor in zip(free_axes, sorted(factors, reverse=True)):
        sizes[name] = factor
    return MeshSpec(tuple((name, sizes[name]) for name in axis_names))


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:(rank % count)`` for
    an unindexed ``"cuda"``, else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Ranks on named axes.

    ``devices`` lists every rank's device in rank (mesh) order, as JAX's
    ``mesh.devices.flatten()``; ``rank`` is this process's place in it and
    ``groups`` maps each axis of size > 1 to the process group of the
    ranks that share this rank's other coordinates.
    """

    devices: Tuple[torch.device, ...]
    axes: Tuple[Tuple[str, int], ...] = ()
    rank: int = 0
    groups: Dict[str, object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (("dp", len(self.devices)),))
        if math.prod(s for _, s in self.axes) != len(self.devices):
            raise ValueError(f"mesh axes {self.axes} do not cover "
                             f"{len(self.devices)} devices")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        idx = np.unravel_index(self.rank, tuple(s for _, s in self.axes))
        return {name: int(i) for (name, _), i in zip(self.axes, idx)}

    def axis_size(self, axis: str) -> int:
        """Size of ``axis`` (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` (``None`` for a size-1 axis)."""
        return self.groups.get(axis)


def _axis_lines(shape: Tuple[int, ...], axis: int) -> List[List[int]]:
    """Every line of ranks along ``axis`` (the other coordinates fixed),
    in a deterministic order: the groups every rank must create alike."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
    return [list(map(int, line)) for line in lines]


def build_mesh(
    spec: Optional[MeshSpec] = None,
    device: DeviceLike = "cuda",
    axis_names: Sequence[str] = ("dp",),
) -> DeviceMesh:
    """A mesh over the ranks of the process group (one device without
    one).  ``spec`` defaults as in JAX: one axis over every rank, or
    :func:`factor_devices` over ``axis_names``.  Creates one group per
    axis of size > 1; every rank must call this alike."""
    world = multihost.process_count()
    if spec is None:
        spec = (MeshSpec(((axis_names[0], world),)) if len(axis_names) == 1
                else factor_devices(world, axis_names))
    if spec.size() != world:
        if world == 1:
            raise RuntimeError(
                f"a mesh of {spec.size()} devices runs one process per rank: "
                f"join a process group of {spec.size()} ranks first "
                "(`python -m music_analyst_tpu_torch ... --devices N` "
                "launches them)")
        raise ValueError(
            f"mesh spec {spec.axes} needs {spec.size()} ranks, the process "
            f"group has {world}")
    rank = multihost.process_index()
    devices = tuple(rank_device(device, r) for r in range(world))
    groups: Dict[str, object] = {}
    for i, (name, size) in enumerate(spec.axes):
        if size == 1:
            continue
        for line in _axis_lines(spec.shape, i):
            group = dist.new_group(
                line, timeout=multihost.group_timeout())
            if rank in line:
                groups[name] = group
    if devices[rank].type == "cuda":
        if multihost.backend() == "nccl":
            torch.cuda.set_device(devices[rank])
        # Create the card's context now, as building a JAX mesh
        # initialises its backend.
        torch.zeros((1,), device=devices[rank])
    return DeviceMesh(devices, spec.axes, rank, groups)


def data_parallel_mesh(
    n_devices: Optional[int] = None,
    axis: str = "dp",
    device: DeviceLike = "cuda",
) -> DeviceMesh:
    """1-D data-parallel mesh over ``n_devices`` ranks (default: every
    rank of the process group, or one device without one)."""
    n = multihost.process_count() if n_devices is None else int(n_devices)
    return build_mesh(MeshSpec(((axis, n),)), device=device)


def replicated(mesh: DeviceMesh, batch):
    """A replicated input: every rank holds the whole batch."""
    return batch


def shard_bounds(n: int, mesh: DeviceMesh, axis: str = "dp"
                 ) -> Tuple[int, int, int]:
    """``(start, stop, share)`` of this rank's rows of an ``n``-row batch
    padded to a multiple of the axis size (JAX's ``P(axis)`` layout)."""
    parts = mesh.axis_size(axis)
    share = -(-n // parts) if n else 0
    start = min(n, mesh.coord(axis) * share)
    return start, min(start + share, n), share


def batch_sharding(mesh: DeviceMesh, batch, axis: str = "dp"):
    """This rank's rows of ``batch`` (an array or sequence whose length
    splits evenly over ``axis``, as JAX's ``NamedSharding(P(axis))``
    requires)."""
    n = len(batch)
    parts = mesh.axis_size(axis)
    if n % parts:
        raise ValueError(
            f"a batch of {n} rows does not split over {axis}={parts}")
    start, stop, _ = shard_bounds(n, mesh, axis)
    return batch[start:stop]


# ------------------------------------------------------------ collectives


def all_reduce(tensor: torch.Tensor, mesh: Optional[DeviceMesh],
               axis: str) -> torch.Tensor:
    """Sum ``tensor`` over ``axis`` (identity on a size-1 axis).  Under
    gloo a card tensor crosses host memory; the result comes back on
    ``tensor``'s device."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return tensor
    staged = tensor.to(multihost.transport_device(group))
    if staged is tensor:
        staged = tensor.clone()
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=group)
    return staged.to(tensor.device)


def all_gather(tensor: torch.Tensor, mesh: Optional[DeviceMesh], axis: str,
               dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's equal-shaped ``tensor`` along ``dim`` in
    the axis's coordinate order (identity on a size-1 axis)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return tensor
    staged = tensor.to(multihost.transport_device(group)).contiguous()
    parts = [torch.empty_like(staged) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts, dim=dim).to(tensor.device)
