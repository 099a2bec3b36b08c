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

For training: :func:`copy_to_axis`, :func:`reduce_from_axis` and
:func:`gather_from_axis` are the tensor-parallel collectives with a
stated backward (Megatron's f and g, and the vocabulary gather;
:func:`copy_to_axes` and :func:`reduce_from_axes` take them over several
axes, as a MoE layer does over ``ep`` and ``tp``), :func:`counts_before`
gives a ``dp`` rank its share of a global order (the MoE slots), and
:func:`reduce_scatter_rows`, :func:`all_gather_rows_` and
:func:`all_reduce_many` move a whole model's gradients and masters over
``dp`` in bounded buckets (ZeRO-1 and the plain gradient sum).
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


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensor: torch.Tensor, mesh: Optional[DeviceMesh],
               axis: str, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or take the elementwise maximum (``"max"``) of
    ``tensor`` over ``axis`` (identity on a size-1 axis).  Under gloo a
    card tensor crosses host memory; the result comes back on
    ``tensor``'s device."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return tensor
    staged = tensor.to(multihost.transport_device(group))
    if staged is tensor:
        staged = tensor.clone()
    dist.all_reduce(staged, op=_REDUCE_OPS[op], group=group)
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


# ----------------------------------------- collectives with a stated backward
#
# Megatron's f / g pair and the vocabulary gather, as autograd functions
# over one mesh axis (``tp``).  Each is the identity on a size-1 axis, and
# outside autograd (no grad, or an input that needs none) it is the plain
# collective above, so inference runs exactly what it ran before.


class _CopyToAxis(torch.autograd.Function):
    """f: identity forward; backward sums the gradient over the axis (the
    input of a column-parallel region, whose ranks each hold a partial
    gradient of the replicated activation)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    """g: sum over the axis forward (the output of a row-parallel region);
    identity backward, since what follows is replicated."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromAxis(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's slice
    of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.dim, ctx.size = dim % x.dim(), x.shape[dim]
        return all_gather(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.coord(ctx.axis) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None, None, None


def _plain(x: torch.Tensor, mesh: Optional[DeviceMesh], axis: str) -> bool:
    """Whether the collective needs no autograd node: a size-1 axis, or
    an input outside the graph."""
    return (mesh is None or mesh.group(axis) is None
            or not (torch.is_grad_enabled() and x.requires_grad))


def copy_to_axis(x: torch.Tensor, mesh: Optional[DeviceMesh],
                 axis: str = "tp") -> torch.Tensor:
    """f: ``x`` itself; its gradient is summed over ``axis``."""
    return x if _plain(x, mesh, axis) else _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh: Optional[DeviceMesh],
                     axis: str = "tp") -> torch.Tensor:
    """g: the sum of ``x`` over ``axis``; the gradient passes unchanged."""
    if _plain(x, mesh, axis):
        return all_reduce(x, mesh, axis)
    return _ReduceFromAxis.apply(x, mesh, axis)


def gather_from_axis(x: torch.Tensor, mesh: Optional[DeviceMesh],
                     axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient goes
    back as this rank's slice."""
    if _plain(x, mesh, axis):
        return all_gather(x, mesh, axis, dim=dim)
    return _GatherFromAxis.apply(x, mesh, axis, dim)


def copy_to_axes(x: torch.Tensor, mesh: Optional[DeviceMesh],
                 axes: Sequence[str]) -> torch.Tensor:
    """f over each of ``axes``: ``x`` itself; its gradient is summed over
    all of them (a replicated tensor that each rank uses for its own share
    of the work, as the MoE router's weight under ``ep`` and ``tp``)."""
    for axis in axes:
        x = copy_to_axis(x, mesh, axis)
    return x


def reduce_from_axes(x: torch.Tensor, mesh: Optional[DeviceMesh],
                     axes: Sequence[str]) -> torch.Tensor:
    """g over each of ``axes``: the sum of ``x`` over all of them."""
    for axis in axes:
        x = reduce_from_axis(x, mesh, axis)
    return x


def counts_before(counts: torch.Tensor, mesh: Optional[DeviceMesh],
                  axis: str = "dp") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(before, total)`` of per-item ``counts [n]`` over ``axis``: the
    sum of the counts of the ranks before this one on the axis (an
    exclusive prefix) and of every rank's.  One all-gather of ``n``
    counts; ``(zeros, counts)`` on a size-1 axis."""
    every = all_gather(counts[None], mesh, axis, dim=0)     # [parts, n]
    me = mesh.coord(axis) if mesh is not None else 0
    return every[:me].sum(dim=0), every.sum(dim=0)


# ------------------------------------------- bucketed collectives (ZeRO-1)
#
# The gradient sum over ``dp`` and the ZeRO-1 pair (reduce-scatter of the
# gradients, all-gather of the stepped masters) move every parameter of
# the model.  They run over a list of tensors in column buckets of at most
# BUCKET_BYTES, so under gloo a card's tensors cross host memory one
# bucket at a time (through reused pinned buffers) and never whole.  A
# "rows" tensor is viewed as ``[parts, numel / parts]``: row ``i`` is the
# flat slice that rank ``i`` of the axis owns.
#
# Routes: the reduce-scatter and the all-gather are one all-to-all each,
# which moves a row to its owner (the reduce-scatter then sums the rows
# it received on the tensor's device), on any backend: gloo's own
# reduce-scatter and all-gather ran at a third to two thirds of its
# all-to-all's rate on the same buckets, on an H100 host
# (`tools/gloo_routes_time.py`; PERF.md §6).  NCCL's own pair has not
# been measured against it.

BUCKET_BYTES = 256 << 20

# How each bucketed collective ran ("all_to_all+sum", "all_to_all",
# "all_reduce"): counts of buckets, and bytes under "<route>.bytes".
ROUTES: Dict[str, int] = {}
_PINNED: Dict[Tuple[torch.dtype, str], torch.Tensor] = {}


def reset_routes() -> None:
    ROUTES.clear()


def _route(name: str, nbytes: int) -> None:
    ROUTES[name] = ROUTES.get(name, 0) + 1
    ROUTES[f"{name}.bytes"] = ROUTES.get(f"{name}.bytes", 0) + nbytes


def _pinned(numel: int, dtype: torch.dtype, slot: str) -> torch.Tensor:
    """A reused pinned host buffer of at least ``numel`` elements."""
    key = (dtype, slot)
    buf = _PINNED.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(max(numel, BUCKET_BYTES // _itemsize(dtype)),
                          dtype=dtype, pin_memory=True)
        _PINNED[key] = buf
    return buf[:numel]


def _host_side(tensor: torch.Tensor, group) -> bool:
    """Whether ``tensor`` must cross host memory for ``group``'s backend
    (gloo, a card's tensor)."""
    return tensor.is_cuda and multihost.transport_device(group).type == "cpu"


def _buffer(shape, like: torch.Tensor, group, slot: str) -> torch.Tensor:
    """An empty tensor of ``shape`` where ``group``'s backend wants it: a
    reused pinned host buffer for a card's tensor under gloo."""
    if _host_side(like, group):
        return _pinned(math.prod(shape), like.dtype, slot).view(shape)
    return torch.empty(shape, dtype=like.dtype,
                       device=multihost.transport_device(group))


def _staged(tensor: torch.Tensor, group, slot: str) -> torch.Tensor:
    """``tensor`` where ``group``'s backend wants it: the tensor itself, or
    a copy in a reused pinned host buffer."""
    if _host_side(tensor, group):
        return _buffer(tensor.shape, tensor, group, slot).copy_(tensor)
    return tensor.to(multihost.transport_device(group))


def _column_buckets(widths: Sequence[int], limit: int):
    """Split the columns of items of ``widths`` columns into buckets of at
    most ``limit`` columns: lists of ``(item, start, stop)``."""
    bucket, room = [], limit
    for i, width in enumerate(widths):
        start = 0
        while start < width:
            take = min(width - start, room)
            bucket.append((i, start, start + take))
            start += take
            room -= take
            if room == 0:
                yield bucket
                bucket, room = [], limit
    if bucket:
        yield bucket


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _rows(tensor: torch.Tensor, parts: int) -> torch.Tensor:
    return tensor.view(parts, -1)


def _scatter_back(bucket, targets, source: torch.Tensor) -> None:
    """Copy the columns of ``source [..., w]`` back into each item's
    ``targets[i][..., a:b]``."""
    offset = 0
    for i, a, b in bucket:
        targets[i][..., a:b].copy_(source[..., offset:offset + b - a])
        offset += b - a


def reduce_scatter_rows(tensors: Sequence[torch.Tensor],
                        mesh: Optional[DeviceMesh], axis: str
                        ) -> List[torch.Tensor]:
    """For each tensor, this rank's row of its sum over ``axis`` (the
    tensor viewed as ``[parts, numel / parts]``), in f32 on the tensor's
    device; the sum runs in f32."""
    group = None if mesh is None else mesh.group(axis)
    parts = mesh.axis_size(axis) if group is not None else 1
    rows = [_rows(t, parts) for t in tensors]
    if group is None:
        return [r[0].to(torch.float32, copy=True) for r in rows]
    out = [torch.empty(r.shape[1], dtype=torch.float32, device=r.device)
           for r in rows]
    limit = max(1, BUCKET_BYTES // (parts * _itemsize(torch.float32)))
    for bucket in _column_buckets([r.shape[1] for r in rows], limit):
        send = torch.cat([rows[i][:, a:b].float() for i, a, b in bucket],
                         dim=1)
        staged = _staged(send, group, "send")
        recv = _buffer(send.shape, send, group, "recv")
        dist.all_to_all_single(recv.view(-1), staged.view(-1), group=group)
        _route("all_to_all+sum", send.numel() * send.element_size())
        _scatter_back(bucket, out, recv.to(send.device).sum(dim=0))
    return out


def all_reduce_many(tensors: Sequence[torch.Tensor],
                    mesh: Optional[DeviceMesh], axis: str
                    ) -> List[torch.Tensor]:
    """Each tensor summed over ``axis`` in f32 (a new tensor on its
    device), in buckets."""
    group = None if mesh is None else mesh.group(axis)
    out = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
           for t in tensors]
    if group is None:
        for o, t in zip(out, tensors):
            o.copy_(t)
        return out
    flats = [t.view(-1) for t in tensors]
    limit = max(1, BUCKET_BYTES // _itemsize(torch.float32))
    for bucket in _column_buckets([f.numel() for f in flats], limit):
        send = torch.cat([flats[i][a:b].float() for i, a, b in bucket])
        staged = _staged(send, group, "send")
        dist.all_reduce(staged, group=group)
        _route("all_reduce", staged.numel() * staged.element_size())
        _scatter_back(bucket, [o.view(-1) for o in out], staged)
    return out


def all_gather_rows_(tensors: Sequence[torch.Tensor],
                     mesh: Optional[DeviceMesh], axis: str) -> None:
    """Fill every row of each tensor (viewed as ``[parts, numel /
    parts]``) from the rank of ``axis`` that owns it, in place, in
    buckets: the ZeRO-1 all-gather of the stepped masters."""
    group = None if mesh is None else mesh.group(axis)
    if group is None or not tensors:
        return
    parts = mesh.axis_size(axis)
    me = mesh.coord(axis)
    rows = [_rows(t, parts) for t in tensors]
    limit = max(1, BUCKET_BYTES // (parts * rows[0].element_size()))
    for bucket in _column_buckets([r.shape[1] for r in rows], limit):
        send = torch.cat([rows[i][me, a:b] for i, a, b in bucket])
        shape = (parts, send.numel())
        # Every rank sends its row to every rank, its own included.
        staged = _buffer(shape, send, group, "send")
        staged[0].copy_(send)
        staged[1:].copy_(staged[0].expand(parts - 1, -1))
        recv = _buffer(shape, send, group, "recv")
        dist.all_to_all_single(recv.view(-1), staged.view(-1), group=group)
        _route("all_to_all", recv.numel() * recv.element_size())
        _scatter_back(bucket, rows, recv.to(send.device))
