"""Device meshes over torch.distributed, and the collectives of the port.

Counterpart of detex_tpu/parallel/mesh.py.  JAX has one controller that
drives every device of a Mesh; torch.distributed runs one process per
rank, so here a mesh is a torch.distributed.device_mesh.DeviceMesh with
the JAX mesh's axis names and row-major rank order, and the body of a JAX
shard_map is the code each rank runs on its own shard:

  dp — data/rollout parallel (MPPI rollout batch, training batch)
  tp — tensor parallel (dynamics-model hidden dims)

A DeviceMesh needs a process group.  A single process that no launcher
started (no distributed.initialize, no torchrun) gets a world of one: a
process group over an in-memory HashStore (`world_of_one`), NCCL for a
CUDA device and gloo for the CPU.  So the same code runs at one rank and
at many.

The collectives go through the helpers below (all_reduce, all_gather and
the four autograd pairs of tensor parallelism).  Each adds the bytes of
its result to COLLECTIVE_BYTES under (collective, axis): that counter is
what the tests read where the JAX tests read collectives from HLO text.
The transport is chosen by the group's backend before the call: NCCL
takes the device tensor; gloo, which torch documents only for broadcast
and all_reduce on CUDA tensors, takes a host copy of a CUDA tensor (the
buffers are small: O(H*A) for MPPI, a few (n, n) blocks for the LQT).
The JAX package's with_sharding (a compiler constraint) has no
counterpart.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from detex_tpu_torch import resolve_device

Axis = Union[str, Sequence[str]]

# Bytes of each collective's result, by (collective, axis name): an
# all_reduce counts its buffer once per axis it reduces over, an
# all_gather its gathered result.  Reset with reset_collective_bytes().
# A helper counts when it is called; under a CUDA graph's capture that
# call only records the collective, so graphs.Graph takes the capture's
# bytes back and adds them at every replay, when the collective runs.
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


def reset_collective_bytes() -> None:
    COLLECTIVE_BYTES.clear()


def world_of_one(device: torch.device) -> None:
    """Give a process that no launcher started a process group of one rank
    (an in-memory HashStore); a no-op where a group exists.  On a card the
    group is NCCL, and a CUDA graph can hold its collectives (capturable):
    that needs no setting here, since NCCL makes each group's communicator
    at its first collective, which a capture's eager warm-ups run, and the
    capture itself runs in "thread_local" mode (graphs.Graph)."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if device.index is None else device.index)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def capturable(mesh: DeviceMesh) -> bool:
    """Whether a step on `mesh` can be captured as one CUDA graph: the mesh
    is on a CUDA device and every axis's group is NCCL, whose collectives
    are kernels on the card's streams.  gloo copies a CUDA tensor through
    the host (_buffer) and waits for it there, which a capture cannot
    hold.  The answer comes from the groups' backends, before any capture;
    nothing finds it out by catching a failed one."""
    return mesh.device_type == "cuda" and all(
        dist.get_backend(mesh.get_group(a)) == "nccl"
        for a in mesh.mesh_dim_names)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              device="cuda") -> DeviceMesh:
    """A mesh over every rank of the process group (a world of one where
    there is none), on `device`'s type.

    Default: the whole world on the first axis, the others 1.  A shape
    whose product is not the world size raises ValueError."""
    device = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    world_of_one(device)
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis: Axis) -> int:
    """Ranks along `axis` (the product over a tuple of axes)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _axes(axis))


def axis_index(mesh: DeviceMesh, axis: Axis) -> int:
    """This rank's index along `axis`; over a tuple of axes the row-major
    index, which is the shard JAX's PartitionSpec((a, b)) gives it."""
    i = 0
    for a in _axes(axis):
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return i


def has_axis(mesh: Optional[DeviceMesh], axis: str) -> bool:
    """Whether `mesh` has `axis` with more than one rank on it."""
    return (mesh is not None and axis in mesh.mesh_dim_names
            and axis_size(mesh, axis) > 1)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh,
                axis: Axis = "dp") -> torch.Tensor:
    """This rank's rows of `x`, whose leading axis is the batch: the
    contiguous block JAX's NamedSharding(mesh, P(axis)) puts here."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by mesh "
                         f"axes {_axes(axis)} total size {n}")
    m = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * m:(i + 1) * m]


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """`x` as it is: every rank holds the whole tensor."""
    return x


def _buffer(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of `x` for a collective on `group`: on the host for gloo with
    a CUDA tensor, else on x's device."""
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    return x.detach().to(device="cpu" if host else x.device, copy=True)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis: Axis,
               op: str = "sum") -> torch.Tensor:
    """`x` reduced with `op` ("sum" or "min") over each axis of
    `axis`, innermost (last) first, as a new tensor; `x` is unchanged.  Over
    ("dcn", "ici") only the partial reduced on "ici" crosses "dcn"."""
    buf = None
    for a in reversed(_axes(axis)):
        group = mesh.get_group(a)
        buf = _buffer(x if buf is None else buf, group)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        COLLECTIVE_BYTES[(f"all_reduce_{op}", a)] += _nbytes(buf)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Every rank's `x` along `axis`, stacked: (n, *x.shape), in the axis's
    rank order."""
    group = mesh.get_group(axis)
    buf = _buffer(x.contiguous(), group)
    out = [torch.empty_like(buf) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, buf, group=group)
    out = torch.stack(out)
    COLLECTIVE_BYTES[("all_gather", axis)] += _nbytes(out)
    return out.to(x.device)


def piece_of(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             dim: int) -> torch.Tensor:
    """This rank's piece of `x` along `dim`, cut evenly over `axis`, as a
    tensor of its own (no view that keeps the whole alive)."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible "
                         f"by mesh axis {axis!r} size {n}")
    return x.chunk(n, dim)[axis_index(mesh, axis)].clone(
        memory_format=torch.contiguous_format)


def whole_of(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             dim: int) -> torch.Tensor:
    """The ranks' pieces along `dim` joined in `axis` order (all_gather)."""
    return torch.cat(all_gather(x, mesh, axis).unbind(0), dim)


# Tensor parallelism, Megatron style.  Every rank of the axis computes the
# same (replicated) loss; the pairs below keep each rank's gradient of a
# replicated tensor equal to the whole gradient, and of a sharded tensor
# equal to the gradient of its own piece.


class _CopyToAxis(torch.autograd.Function):
    """A replicated tensor entering a split computation: identity forward;
    backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceOverAxis(torch.autograd.Function):
    """Partial sums (a row-split product) to the replicated whole: sum
    forward; the gradient of a replicated value passes through."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOverAxis(torch.autograd.Function):
    """The ranks' pieces along `dim` to the replicated whole; backward
    keeps this rank's piece of the (whole) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return whole_of(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return piece_of(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SplitOverAxis(torch.autograd.Function):
    """A replicated tensor to this rank's piece along `dim`; backward
    gathers the pieces' gradients into the whole one."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return piece_of(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return whole_of(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def copy_to_axis(x, mesh: DeviceMesh, axis: str):
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_over_axis(x, mesh: DeviceMesh, axis: str):
    return _ReduceOverAxis.apply(x, mesh, axis)


def gather_over_axis(x, mesh: DeviceMesh, axis: str, dim: int):
    return _GatherOverAxis.apply(x, mesh, axis, dim % x.dim())


def split_over_axis(x, mesh: DeviceMesh, axis: str, dim: int):
    return _SplitOverAxis.apply(x, mesh, axis, dim % x.dim())
