"""Ambient parallel context, the collectives of the explicit parallel
blocks, and those of tensor-parallel compute over 'model'.

A port of the JAX package's `runtime/parallel.py`.  The launchers set the
context; model code reads it.  With a context and a mesh that has the
expert axis, the MoE block takes the reference's explicit paths
(`models/moe.py`: expert parallelism with all-to-all, or tensor
parallelism over the expert hidden dim); with none, the single-device
(dropless) path.

The reference runs those paths in `shard_map` with `jax.lax` collectives
over named mesh axes.  Here every rank runs them as ordinary functions,
and the collectives below take (mesh, axes) in their place: torch.distributed's
collectives over the mesh's axis groups (NCCL for CUDA tensors, gloo for
CPU ones), in autograd functions whose adjoint is the one each collective
has when the ranks' losses add up to the whole loss: what a rank's value
fed on the other ranks flows back to it summed.  Over several axes they
run one axis at a time; gathers take the minor axis first, so gathered
rows come out in JAX's major-to-minor order.

Tensor parallelism over 'model' (the dense layers' share of GSPMD's
compute, Megatron-style) uses the same convention.  A rank holds the
'model' shard of a weight that the rules shard there (`sharding.py:
compute_spec`); `model_slice` asks the rules which slice of the
weight's tensor-parallel dimension that is.  A column-parallel product runs on the rank's columns
and needs no collective in either direction: under the sum-of-ranks
convention the gradient of a replicated input is left partial on each
rank, and the sums are taken where they are needed.  A row-parallel
product is followed by `psum_model`, whose adjoint is the same sum: that
backward all-reduce stands where Megatron puts its at the block's input,
one of the same size each way per block.  Activations a rank needs whole
(heads that do not divide over 'model', a vocabulary's maximum, a
sequence-split attention's partials) are gathered by `gather_model` or
`all_gather`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh, get_abstract_mesh
from .sharding import compute_spec, shard_slices, tp_dim

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    expert_axis: str = "model"          # mesh axis carrying experts
    data_axes: Tuple[str, ...] = ("data",)
    capacity_factor: float = 1.25       # per-destination-shard row budget


def get_context() -> Optional[ParallelContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def parallel_context(ctx: ParallelContext):
    prev = get_context()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def shard_batch(x):
    """Pin an activation batch-sharded over the data axes.

    The reference constrains the activation's sharding for GSPMD.  Here a
    plain tensor is already this rank's own rows and passes unchanged; a
    DTensor is redistributed to Shard(0) over ("pod", *data_axes), the
    other mesh axes replicated, when the batch divides over them (the
    reference's rule)."""
    ctx = get_context()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    sizes = dict(zip(names, x.device_mesh.mesh.shape))
    axes = tuple(a for a in ("pod", *ctx.data_axes) if a in sizes)
    if not axes or x.ndim < 2:
        return x
    if x.shape[0] % math.prod(int(sizes[a]) for a in axes) != 0:
        return x
    return x.redistribute(x.device_mesh, [
        Shard(0) if n in axes else Replicate() for n in names])


# --------------------------------------------------------------------------
# collectives over mesh axes (the shard_map paths' jax.lax collectives)
# --------------------------------------------------------------------------

def axis_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def axis_index(mesh: Mesh, axes: Sequence[str]) -> int:
    """This rank's index along `axes` taken together, the first axis
    major (`jax.lax.axis_index` over a tuple of axes)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.index(a)
    return i


class _AllGather(torch.autograd.Function):
    """The group's x concatenated on dim 0, in rank order; the adjoint
    sums the ranks' gradients and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        # all_gather_single is the newer torch's name of the same call
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rows = g.shape[0] // dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return g[me * rows:(me + 1) * rows], None


class _AllReduce(torch.autograd.Function):
    """The group's sum of x; its adjoint is the same sum of gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """Equal blocks of dim 0 exchanged across the group; its adjoint
    sends the gradients' blocks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               dim: int = 0) -> torch.Tensor:
    """The ranks' x along `axes` concatenated on `dim`, major axis
    first (the rows of a tensor sharded P(axes) on that dim)."""
    if dim % x.ndim:
        return all_gather(x.movedim(dim, 0), mesh, axes).movedim(0, dim)
    for a in reversed(tuple(axes)):
        x = _AllGather.apply(x, mesh.group(a))
    return x


def psum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum of x over the ranks along `axes` (`jax.lax.psum`)."""
    for a in axes:
        x = _AllReduce.apply(x, mesh.group(a))
    return x


def pmax(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise maximum of x over the ranks along `axes`, without a
    gradient (`jax.lax.pmax` of a stop-gradient value)."""
    out = x.detach().contiguous().clone()
    for a in axes:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(a))
    return out


def pmean(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Mean of x over the ranks along `axes` (`jax.lax.pmean`)."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x: (n, ...) with n the size of `axis`; block j goes to rank j of
    the axis, and block j of the result came from rank j
    (`jax.lax.all_to_all(x, axis, 0, 0, tiled=False)`)."""
    if x.shape[0] != mesh.shape[axis]:
        raise ValueError(f"all_to_all over {axis!r} ({mesh.shape[axis]} "
                         f"ranks) got {x.shape[0]} blocks")
    return _AllToAll.apply(x, mesh.group(axis))


# --------------------------------------------------------------------------
# tensor parallelism over 'model' (GSPMD's dense compute, Megatron-style)
# --------------------------------------------------------------------------

def model_slice(path: str, shape: Sequence[int],
                full: int) -> Optional[slice]:
    """This rank's slice of the tensor-parallel dimension
    (`sharding.tp_dim`) of the weight at `path` ("attn/wq", "mlp/w_down",
    "embed/table", "unembed": the last also for the logits it gives),
    held at `shape`, whose whole width there is `full`: the slice that
    `compute_spec` gives it on the ambient mesh.  None when the rank
    holds all of it (off a mesh, one rank on 'model', or whole weights
    passed on a mesh)."""
    d = tp_dim(path)
    mesh = get_abstract_mesh()
    if shape[d] == full or mesh.shape.get("model", 1) == 1:
        return None
    whole = list(shape)
    whole[d] = full
    spec = compute_spec(mesh, path, tuple(whole))
    if spec[d] is None:
        raise ValueError(f"{path}: {shape[d]} of {full} entries, but the "
                         f"rules keep it whole on {dict(mesh.shape)}")
    return shard_slices(mesh, spec, tuple(whole))[d]


def psum_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel product's partial outputs over the
    ambient mesh's 'model' axis (the adjoint is the same sum)."""
    return psum(x, get_abstract_mesh(), ("model",))


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's shard of an activation along `dim` gathered whole over
    the ambient mesh's 'model' axis (the adjoint keeps the rank's part of
    the summed gradient)."""
    return all_gather(x, get_abstract_mesh(), ("model",), dim)
