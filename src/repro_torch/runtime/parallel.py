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
`all_gather`; where each rank needs only some columns of a
column-parallel output (the split-heads Mamba2 mixer's heads),
`move_model_columns` brings it just those by one all-to-all.

On a mesh the model takes its parameters as the DTensors the rules
place (`sharding.param_spec`) and gathers them where it uses them, as
GSPMD does inside the reference's scanned step: the leaves outside the
unit loop once a step (`gather_params`), each unit's one unit at a time
(`unit_shards` outside the loop, `gather_unit` inside the function
that `checkpoint` wraps, so that the recompute gathers again and a
unit's gathered weights die with it).  Each weight is gathered over the
data axes at its 'model' shard (`sharding.compute_spec`); the gradient
goes back to the shards by the gather's adjoint, the reduce-scatter.
An MoE block's expert stacks stay ungathered in the unit
(`UnitShard`): the block gathers them for the path it takes
(`gather_shard(..., moe=path)`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh, get_abstract_mesh
from .sharding import (SeqSplit, _map_named, cache_spec, compute_spec,
                       is_moe_stack, shard_slices, spec_to_placements,
                       tp_dim)

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    expert_axis: str = "model"          # mesh axis carrying experts
    data_axes: Tuple[str, ...] = ("data",)
    capacity_factor: float = 1.25       # per-destination-shard row budget


def get_context() -> Optional[ParallelContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def _scoped(name: str, value):
    prev = getattr(_state, name, None)
    setattr(_state, name, value)
    try:
        yield
    finally:
        setattr(_state, name, prev)


def parallel_context(ctx: ParallelContext):
    return _scoped("ctx", ctx)


def get_seq_split() -> Optional[SeqSplit]:
    """The split of the sequence the model computes on (`seq_split`):
    None where the rank holds its rows of the batch, or off a mesh."""
    return getattr(_state, "seq", None)


def seq_split(split: Optional[SeqSplit]):
    """Within: the model computes on `split` of its input's sequence (the
    forwards enter it, `models/transformer.py`, `models/encdec.py`)."""
    return _scoped("seq", split)


def batch_splits(splits: Dict[str, Optional[SeqSplit]]):
    """Within: each batch leaf's split, by name (`sharding.leaf_shard`;
    `train.mesh_apply` enters it, the model facade reads it)."""
    return _scoped("splits", dict(splits))


def leaf_split(name: str) -> Optional[SeqSplit]:
    """The split of batch leaf `name` (`batch_splits`), None if unset."""
    return (getattr(_state, "splits", None) or {}).get(name)


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


def cache_model_part(local: Sequence[int], whole: Sequence[int]
                     ) -> Tuple[Optional[slice], ...]:
    """For a unit's cache leaf held at `local` whose whole shape is
    `whole` (the rank's slots: the two agree on the batch dim), this
    rank's slice of each dimension the rules put 'model' on
    (`sharding.cache_spec`), None where it holds all of it."""
    if tuple(local) == tuple(whole):
        return (None,) * len(whole)
    mesh = get_abstract_mesh()
    spec = cache_spec(mesh, tuple(whole))
    cut = shard_slices(mesh, spec, tuple(whole))
    out = []
    for d, (n, w) in enumerate(zip(local, whole)):
        if n != w and spec[d] != "model":
            raise ValueError(f"cache leaf {tuple(local)} of {tuple(whole)}: "
                             f"dim {d} is split, but the rules put "
                             f"{spec[d]!r} there")
        out.append(cut[d] if n != w else None)
    return tuple(out)


def psum_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel product's partial outputs over the
    ambient mesh's 'model' axis (the adjoint is the same sum)."""
    return psum(x, get_abstract_mesh(), ("model",))


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's shard of an activation along `dim` gathered whole over
    the ambient mesh's 'model' axis (the adjoint keeps the rank's part of
    the summed gradient)."""
    return all_gather(x, get_abstract_mesh(), ("model",), dim)


@functools.lru_cache(maxsize=None)
def _column_plan(width: int, n: int, me: int, wants: Tuple) -> Tuple:
    """The all-to-all that brings each rank of a group of n the columns
    it wants of a tensor `width` wide, split in n equal blocks in rank
    order: (the local ranges this rank sends, destination-major, the
    columns sent to each rank, the columns received from each rank)."""
    block = width // n
    lo, hi = me * block, (me + 1) * block
    send, send_counts = [], []
    for ranges in wants:
        cut = [(max(a, lo) - lo, min(b, hi) - lo) for a, b in ranges
               if max(a, lo) < min(b, hi)]
        send.extend(cut)
        send_counts.append(sum(b - a for a, b in cut))
    recv_counts = [sum(max(0, min(b, (s + 1) * block) - max(a, s * block))
                       for a, b in wants[me]) for s in range(n)]
    return tuple(send), tuple(send_counts), tuple(recv_counts)


class _MoveColumns(torch.autograd.Function):
    """The columns each rank wants, from the ranks' blocks, by one
    all-to-all of uneven splits; the adjoint sends the gradients back
    the same way and adds those of a column sent to several ranks."""

    @staticmethod
    def forward(ctx, x, group, plan):
        send, send_counts, recv_counts = plan
        ctx.group, ctx.plan, ctx.shape = group, plan, x.shape
        out_dims = tuple(x.shape[:-1])
        buf = torch.cat([x[..., a:b] for a, b in send], -1) if send else \
            x.new_empty(out_dims + (0,))
        buf = buf.movedim(-1, 0).contiguous()
        out = x.new_empty((sum(recv_counts),) + out_dims)
        dist.all_to_all_single(out, buf, list(recv_counts),
                               list(send_counts), group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        send, send_counts, recv_counts = ctx.plan
        g = g.movedim(-1, 0).contiguous()
        back = g.new_empty((sum(send_counts),) + tuple(g.shape[1:]))
        dist.all_to_all_single(back, g, list(send_counts),
                               list(recv_counts), group=ctx.group)
        back = back.movedim(0, -1)
        gx = back.new_zeros(ctx.shape)
        at = 0
        for a, b in send:
            gx[..., a:b] += back[..., at:at + b - a]
            at += b - a
        return gx, None, None


def move_model_columns(x: torch.Tensor, width: int,
                       wants: Tuple[Tuple[Tuple[int, int], ...], ...]
                       ) -> torch.Tensor:
    """x: (..., width / n), this rank's block of the columns of a tensor
    `width` wide split in equal blocks over the ambient mesh's 'model'
    axis (n ranks, a column-parallel product's output).  `wants[r]`: the
    sorted, disjoint (start, stop) ranges of columns rank r of 'model'
    needs.  Returns (..., its count) this rank's, in order, moved by one
    all-to-all over 'model' (the split sizes worked out once from the
    shapes), differentiably."""
    mesh = get_abstract_mesh()
    n, me = mesh.shape["model"], mesh.index("model")
    if len(wants) != n or x.shape[-1] * n != width:
        raise ValueError(f"move_model_columns: {x.shape[-1]} of {width} "
                         f"columns, wants of {len(wants)} ranks, {n} on "
                         f"'model'")
    return _MoveColumns.apply(x, mesh.group("model"),
                              _column_plan(width, n, me, wants))


# --------------------------------------------------------------------------
# the parameters' gathers: once a step outside the unit loop, one unit at a
# time inside it
# --------------------------------------------------------------------------

def _one_rank(mesh: Mesh) -> bool:
    return all(n == 1 for n in mesh.shape.values())


def _gather_local(local, mesh: Mesh, have, want, shape):
    """A tensor whose shard `local` is placed `have` on `mesh`,
    redistributed to `want` and returned as this rank's local tensor,
    differentiably: the gradient goes back to `local` in `have`'s
    placements, summed over the ranks on each axis `want` replicates
    (the gather's adjoint, a reduce-scatter or an all-reduce).  On a
    one-rank mesh, `local` itself."""
    if _one_rank(mesh):
        return local
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dt = DTensor.from_local(local, mesh.device_mesh, have, run_check=False,
                            shape=torch.Size(shape),
                            stride=_contiguous_stride(shape))
    grads = [Partial() if w == Replicate() else w for w in want]
    return dt.redistribute(mesh.device_mesh, want).to_local(
        grad_placements=grads)


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def gather_params(params):
    """What this rank computes with, from parameter DTensors (the leaves
    that live outside the unit loop: the embedding, the final norm, a
    hybrid's shared block): each one gathered over the data axes (and
    whole over 'model' unless `compute_spec` keeps its 'model' shard),
    differentiably: the gradient goes back to the shards summed over the
    ranks that gathered them.  Plain tensors pass as they are."""
    from torch.distributed.tensor import DTensor
    mesh = get_abstract_mesh()

    def gather(name, p):
        if not isinstance(p, DTensor):
            return p
        want = spec_to_placements(mesh, compute_spec(mesh, name,
                                                     tuple(p.shape)))
        return _gather_local(p.to_local(), mesh, tuple(p.placements), want,
                             tuple(p.shape))

    return _map_named(gather, params)


@dataclasses.dataclass(frozen=True)
class UnitShard:
    """This rank's shard of one unit of a stacked parameter DTensor, not
    gathered yet.  `name` and `stacked` are the stacked parameter's path
    and whole shape, `placements` its placements, `lead` the unit axes
    taken off; `owner` is the 'model' rank that holds the unit when the
    rules put 'model' on the unit axis (a stacked dense MLP whose unit
    count 'model' divides: the rules read it as an expert stack)."""
    name: str
    local: torch.Tensor
    stacked: Tuple[int, ...]
    placements: tuple
    lead: int = 1
    owner: Optional[int] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.stacked[self.lead:])


def unit_shards(stacked, n: int, prefix: str):
    """The n units of a stacked parameter tree at `prefix` ("units",
    "dec_units"): for DTensor leaves, each unit's `UnitShard`s (this
    rank's shard of the unit, a view of one `unbind` of the local
    stack); for plain tensors, the units' views as they are."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = get_abstract_mesh()
    names = list(mesh.shape)

    def split(name, p):
        if not isinstance(p, DTensor):
            return p.unbind(0)
        local = p.to_local()
        on_units = [names[i] for i, pl in enumerate(p.placements)
                    if isinstance(pl, Shard) and pl.dim == 0]
        if on_units not in ([], ["model"]):
            raise ValueError(f"{name}: unit axis placed over {on_units}; "
                             f"a unit comes to a rank over 'model' only")
        k = local.shape[0]
        parts = local.unbind(0)
        return [UnitShard(name, parts[u % k], tuple(p.shape),
                          tuple(p.placements), 1,
                          u // k if k < n else None) for u in range(n)]

    per_leaf = _map_named(split, stacked, tuple(prefix.split("/")))
    return [_pick(per_leaf, u) for u in range(n)]


def _pick(tree, u: int):
    if isinstance(tree, dict):
        return {k: _pick(v, u) for k, v in tree.items()}
    return tree[u]


class _FromOwner(torch.autograd.Function):
    """The owner's x on every rank of the group, broadcast from the
    owner (its rank in the group).  The adjoint keeps the owner's
    gradient and adds nothing: the gather that follows (`_gather_local`,
    'model' replicated) has summed it over the group already."""

    @staticmethod
    def forward(ctx, x, owner, group):
        ctx.mine = dist.get_rank(group) == owner
        out = x.clone() if ctx.mine else torch.empty_like(x)
        dist.broadcast(out, src=dist.get_global_rank(group, owner),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def gather_shard(s, moe: Optional[str] = None) -> torch.Tensor:
    """A `UnitShard` as this rank computes with it: the unit's weight
    gathered over the data axes at its `compute_spec` (`moe` names an
    expert stack's path), brought first from its 'model' owner when the
    rules put 'model' on the unit axis (`_FromOwner`).  A plain tensor
    passes as it is."""
    if not isinstance(s, UnitShard):
        return s
    from torch.distributed.tensor import Replicate, Shard
    mesh = get_abstract_mesh()
    local = s.local
    if s.owner is not None:
        local = _FromOwner.apply(local, s.owner, mesh.group("model"))
    have = tuple(Shard(pl.dim - s.lead) if isinstance(pl, Shard)
                 and pl.dim >= s.lead else Replicate()
                 for pl in s.placements)
    spec = compute_spec(mesh, s.name, s.stacked, moe)[s.lead:]
    return _gather_local(local, mesh, have, spec_to_placements(mesh, spec),
                         s.shape)


def gather_unit(unit):
    """One unit's parameters (`unit_shards`) as this rank computes with
    them (`gather_shard`); an MoE block's expert stacks stay
    `UnitShard`s for the block to gather for its path.  Plain tensors
    pass as they are."""
    def gather(_, s):
        if isinstance(s, UnitShard) and is_moe_stack(s.name):
            return s
        return gather_shard(s)
    return _map_named(gather, unit)
