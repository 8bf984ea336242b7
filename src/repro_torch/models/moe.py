"""Mixture-of-Experts block: top-k routing + sorted grouped-GEMM compute.

Dropless MoE as in the reference (`repro.models.moe`): tokens are sorted
by their assigned expert and the expert matmuls run as one grouped GEMM
over the sorted rows, so the work done equals the *active* work.  Expert
weights are stacked (E, d, ff), keyed as in the reference so that
`convert.params_from_jax` carries them across unchanged.

The reference's grouped GEMM is `jax.lax.ragged_dot`, an XLA operation
outside any Pallas kernel; here it is PyTorch's `torch._grouped_mm` on
every device (`grouped_mm`).  `grouped_mm_plain`, a loop over experts,
is its plain version for tests and the card's checks; no model path
takes it.

`moe_block` is the reference's dispatcher.  Under a ParallelContext and
a mesh with the expert axis it takes one of the reference's explicit
parallel paths, which bucket rows by capacity and drop the rows that
overflow a bucket: `moe_block_expert_parallel` (E / n experts a rank,
rows sent to their expert's rank and back by all-to-all) or
`moe_block_tp_ff` (every rank computes its slice of the expert hidden
dim for every row; the partial outputs are summed).  Otherwise it takes
the dropless `moe_block_gspmd`.  The reference runs the parallel paths
in `shard_map`; here every rank runs them with the collectives of
`runtime/parallel.py`.  On a mesh, x is this rank's part of the global
batch: its rows over ("pod", *data_axes), the whole batch when those
axes have one rank; or, for a batch whose rows they do not divide, its
part of the sequence, or the whole batch (`parallel.get_seq_split`).
The explicit paths then compute on the reference's block of the
global batch's flattened tokens (`_data_block`: where the rank's tokens
are not that block, a gather over the data axes and a narrow, both
ways), and the dropless path on the whole sequence.  The expert stacks
reach the block as the unit's shards (`parallel.UnitShard`) and are
gathered over the data axes at the shard the path computes with, as the
reference's `shard_map`s take them: the expert-parallel path its E /
n_e experts, the TP-ff path its slice of the hidden dim
(`sharding.compute_spec(..., moe=path)`).  The
dropless path takes the stacks as placed, experts on 'model' and d on
the data axes, and sums the partial products across them, as GSPMD
compiles the reference's `ragged_dot` on sharded stacks (PERF.md has
the compiled program).  The attention beside the block computes
tensor-parallel over 'model' (`models/attention.py`), and the router is
replicated.  The explicit paths' bucketed products (`_grouped_ffn`) are
batched matmuls over (E, cap, d), as the reference's einsums are,
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch.mesh import get_abstract_mesh
from .layers import _dense_init

Params = Dict[str, torch.Tensor]


def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Router (d, E) and expert stacks (E, d, ff), (E, ff, d); each drawn
    as the reference's `moe_init` draws (scaled by the first axis)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    return {
        "router": _dense_init(gen, (d, E), device=device),
        "w_gate": _dense_init(gen, (E, d, ff), device=device),
        "w_up": _dense_init(gen, (E, d, ff), device=device),
        "w_down": _dense_init(gen, (E, ff, d), device=device),
    }


def route(params: Params, x2d: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x2d: (T, d) -> (weights (T,K), experts (T,K), aux).

    The top k is a stable descending sort cut to k: among equal
    probabilities (common, since the logits are a bf16 product) the lower
    expert index comes first, as `jax.lax.top_k` orders them;
    `torch.topk` does not promise that order."""
    logits = (x2d @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K, E = cfg.experts_per_token, cfg.n_experts
    w, idx = w[:, :K], idx[:, :K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = expert_counts(idx.reshape(-1), E).float() / idx.numel()
    aux = E * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux


def expert_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """`torch.bincount(ids, minlength=n)` of ids in [0, n): the same int64
    counts, at a size fixed by n.  bincount's size depends on the data,
    so fake tensors (`launch/roofline.py`) cannot trace it."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """Rows of x sorted by group, (N, k) @ w[g] (k, n) for each group g of
    `group_sizes[g]` consecutive rows -> (N, n); `jax.lax.ragged_dot`.

    `torch._grouped_mm` on every device; on a CUDA tensor a shape it
    refuses raises (it needs rows and widths of a multiple of 16 bytes)."""
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    return torch._grouped_mm(x, w, offs=offs)


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version of `grouped_mm`: one matmul per expert."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        out[start:start + n] = x[start:start + n] @ w[g]
        start += n
    return out


def _row_axes(mesh, ctx):
    """The mesh axes this rank's rows of the batch are sharded over."""
    data = ctx.data_axes if ctx is not None else ("data",)
    return tuple(a for a in ("pod", *data) if a in mesh.shape)


def _global_tokens(x: torch.Tensor, mesh, ctx) -> int:
    """The global batch's token count, from x, this rank's part of it:
    its rows over the data axes, or, under a `SeqSplit`, its part of
    every row's sequence (or all of it)."""
    from ..runtime.parallel import axis_size, get_seq_split
    split = get_seq_split()
    if split is None:
        return x.shape[0] * x.shape[1] * axis_size(mesh, _row_axes(mesh,
                                                                   ctx))
    return x.shape[0] * split.length


def _data_block(x: torch.Tensor, mesh, ctx):
    """(the reference's block of tokens for this rank's place on the
    data axes, (T / n_d, d), and a function that returns the block's
    outputs, (T / n_d, d), to x's positions).

    The reference's explicit paths split the global batch's flattened
    tokens, (B * S, d), over the data axes, data-major (`tok_spec`).
    Where the rank's tokens are that block (its rows of a row split, or
    its part of a single row's sequence) nothing moves.  Otherwise (a
    sequence split of several rows, or a replicated batch) the block is
    cut from the whole batch, gathered over the split's axes on the
    sequence (none when replicated), and the outputs come back by a
    gather of the blocks over the data axes and a narrow to the rank's
    positions: a gather and a narrow, whose adjoints sum the gradients
    over the ranks and keep each rank's own."""
    from ..runtime.parallel import (all_gather, axis_index, axis_size,
                                    get_seq_split)
    B, S, d = x.shape
    split = get_seq_split()
    if split is None or (split.axes and B == 1):
        return x.reshape(B * S, d), lambda y: y.reshape(B, S, d)
    rows = _row_axes(mesh, ctx)
    whole = all_gather(x, mesh, split.axes, 1) if split.axes else x
    n = whole.shape[0] * whole.shape[1] // axis_size(mesh, rows)
    block = whole.reshape(-1, d).narrow(0, axis_index(mesh, rows) * n, n)

    def back(y):
        y = all_gather(y, mesh, rows).reshape(whole.shape)
        return y.narrow(1, split.offset, S) if split.axes else y

    return block, back


def moe_path(cfg: ModelConfig, x: torch.Tensor) -> str:
    """The path `moe_block` takes for x, this rank's part of the batch
    (B, S, d): "expert", "tp_ff" or "dropless" (the keys of
    `sharding.MOE_DIMS`).

    The reference's dispatcher, its conditions read on the global token
    count T (`_global_tokens`): the expert-parallel path when a
    ParallelContext is set, the mesh has its expert axis (n_e ranks),
    n_e divides the experts and
    n_d * n_e divides T (n_d: the ranks of ctx.data_axes); else the TP-ff
    path when there are at most n_e experts, n_e divides the expert
    hidden dim and n_d divides T; else the dropless path."""
    from ..runtime.parallel import axis_size, get_context
    ctx = get_context()
    mesh = get_abstract_mesh()
    if ctx is None or ctx.expert_axis not in mesh.shape:
        return "dropless"
    n_e = mesh.shape[ctx.expert_axis]
    n_d = axis_size(mesh, [a for a in ctx.data_axes if a in mesh.shape])
    T = _global_tokens(x, mesh, ctx)
    if cfg.n_experts % n_e == 0 and T % (n_d * n_e) == 0:
        return "expert"
    if cfg.n_experts <= n_e and (cfg.moe_d_ff or cfg.d_ff) % n_e == 0 and \
            T % max(1, n_d) == 0:
        return "tp_ff"
    return "dropless"


def _whole(cfg: ModelConfig):
    d, ff, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    return {"w_gate": (E, d, ff), "w_up": (E, d, ff), "w_down": (E, ff, d)}


def _placed(mesh, k: str, shape):
    """(spec, slices) of expert stack `k` of whole `shape` as the rules
    place it on `mesh` (the dropless path's shards): whole, with no
    axes, off a mesh or on one whose axes hold one rank each."""
    from ..runtime.parallel import _one_rank
    from ..runtime.sharding import compute_spec, shard_slices
    if _one_rank(mesh):
        return (None,) * len(shape), tuple(slice(0, n) for n in shape)
    spec = compute_spec(mesh, f"moe/{k}", shape, "dropless")
    return spec, shard_slices(mesh, spec, shape)


def _path_stacks(params: Params, cfg: ModelConfig, path: str) -> Params:
    """The block's params with its expert stacks as `path` computes with
    them: a unit's `UnitShard`s gathered over the data axes at the path's
    'model' shard, or, for the dropless path, taken as placed
    (`parallel.gather_shard`); plain tensors, which must already be that
    shard, as they are.  A stack of another shape raises: no path cuts
    its own piece out of a whole stack."""
    from ..runtime.parallel import gather_shard, get_context
    from ..runtime.sharding import MOE_DIMS
    mesh = get_abstract_mesh()
    ctx = get_context()
    n = mesh.shape.get("model", 1)
    if path != "dropless" and ctx.expert_axis != "model" and n > 1:
        raise ValueError(f"expert stacks are placed over 'model'; the "
                         f"context's expert axis is {ctx.expert_axis!r}")
    out = dict(params)
    for k, shape in _whole(cfg).items():
        t = gather_shard(params[k], moe=path)
        if path == "dropless":
            want = [s.stop - s.start for s in _placed(mesh, k, shape)[1]]
        else:
            want = list(shape)
            want[MOE_DIMS[path][k]] //= n
        if list(t.shape[-3:]) != want:
            raise ValueError(f"moe/{k}: the {path} path computes on "
                             f"{want}, got {tuple(t.shape)}")
        out[k] = t
    return out


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), this rank's part of the batch -> (y, aux_loss).

    The path is `moe_path`'s; the expert stacks are taken as that path
    computes with them (`_path_stacks`).  The dropless path, on a mesh
    whose data axes hold several ranks, gathers their rows (under a
    sequence split, their parts of the sequence; a replicated batch is
    whole already), so that the routing loss is the whole batch's as in
    the reference."""
    from ..runtime.parallel import (all_gather, axis_index, axis_size,
                                    get_context, get_seq_split)
    path = moe_path(cfg, x)
    params = _path_stacks(params, cfg, path)
    if path == "expert":
        return moe_block_expert_parallel(params, x, cfg, get_context())
    if path == "tp_ff":
        return moe_block_tp_ff(params, x, cfg, get_context())
    mesh = get_abstract_mesh()
    rows = _row_axes(mesh, get_context())
    split = get_seq_split()
    if split is None and axis_size(mesh, rows) > 1:
        B = x.shape[0]
        y, aux = moe_block_gspmd(params, all_gather(x, mesh, rows), cfg)
        i = axis_index(mesh, rows)
        return y[i * B:(i + 1) * B], aux
    if split is not None and split.axes:
        y, aux = moe_block_gspmd(params, all_gather(x, mesh, split.axes, 1),
                                 cfg)
        return y.narrow(1, split.offset, x.shape[1]), aux
    return moe_block_gspmd(params, x, cfg)


def moe_block_gspmd(params: Params, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss): global sort + grouped GEMM, no
    drops, on this rank's shards of the stacks (`_dropless_on_shards`;
    whole stacks off a mesh)."""
    B, S, d = x.shape
    K, E = cfg.experts_per_token, cfg.n_experts
    x2d = x.reshape(B * S, d)
    w, idx, aux = route(params, x2d, cfg)

    # expand each token K times, sort by expert id (stable, as jnp.argsort)
    flat_e = idx.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    xs = x2d.repeat_interleave(K, dim=0)[order]            # (T*K, d)
    group_sizes = expert_counts(flat_e, E)

    out = _dropless_on_shards(params, xs, group_sizes, cfg)

    out = out[inv].reshape(B * S, K, d)                    # unsort, fold K
    y = torch.einsum("tkd,tk->td", out, w)
    return y.reshape(B, S, d), aux


def _grouped_on(xs, w, group_sizes, experts: slice):
    """`grouped_mm` of all the sorted rows against the stack's experts
    `experts` (a slice of the whole stack's, `w` holding those): the rows
    of the other experts meet a zero expert before and after them, and
    come out zero."""
    E = group_sizes.numel()
    if experts.start == 0 and experts.stop == E:
        return grouped_mm(xs, w, group_sizes)
    ends = torch.cumsum(group_sizes, 0)
    zero = ends.new_zeros(1)
    before = ends[experts.start - 1:experts.start] if experts.start else zero
    bounds = torch.cat([before, ends[experts], ends[-1:]])
    pad = w.new_zeros((1,) + tuple(w.shape[1:]))
    return grouped_mm(xs, torch.cat([pad, w, pad]),
                      torch.diff(bounds, prepend=zero))


def _dropless_on_shards(params: Params, xs, group_sizes, cfg: ModelConfig):
    """The dropless products on the expert stacks as the rules place them
    (what GSPMD compiles the reference's `ragged_dot` on sharded stacks
    into): each rank multiplies every sorted row by its experts' shard
    (its slice of d and of ff), the partial products summed over the
    axes that split the contraction and the experts, the output's d
    gathered over its axes.  xs: (N, d), every rank the same rows.  On
    whole stacks (`_placed` off a mesh) these are three `grouped_mm`s."""
    from ..runtime.parallel import all_gather, psum
    from ..runtime.sharding import _axes_of
    mesh = get_abstract_mesh()
    whole = _whole(cfg)
    (g_spec, (g_e, g_d, g_f)), (d_spec, (d_e, d_f, _)) = (
        _placed(mesh, k, whole[k]) for k in ("w_gate", "w_down"))
    if (g_e, g_f) != (d_e, d_f) or _placed(mesh, "w_up", whole["w_up"]) != \
            (g_spec, (g_e, g_d, g_f)):
        raise ValueError(f"expert stacks placed {g_spec} / {d_spec}: the "
                         f"dropless path needs their experts and hidden "
                         f"dims split alike")
    x = xs[:, g_d]
    over = _axes_of(g_spec[0]) + _axes_of(g_spec[1])
    gate = psum(_grouped_on(x, params["w_gate"], group_sizes, g_e), mesh,
                over)
    up = psum(_grouped_on(x, params["w_up"], group_sizes, g_e), mesh, over)
    h = F.silu(gate.float()).to(xs.dtype) * up
    out = psum(_grouped_on(h, params["w_down"], group_sizes, d_e), mesh,
               _axes_of(d_spec[0]) + _axes_of(d_spec[1]))
    return all_gather(out, mesh, _axes_of(d_spec[2]), -1)


# --------------------------------------------------------------------------
# explicit parallel paths: every rank runs these with collectives over
# the mesh's axes (the reference's shard_map bodies)
# --------------------------------------------------------------------------

def _local_route(router, x2, cfg: ModelConfig):
    """The reference's `_local_route`: the same arithmetic as `route`."""
    return route({"router": router}, x2, cfg)


def _expert_ffn(xs, group_sizes, wg, wu, wd):
    """Rows sorted by expert -> the experts' SwiGLU outputs (grouped)."""
    gate = grouped_mm(xs, wg, group_sizes)
    up = grouped_mm(xs, wu, group_sizes)
    h = F.silu(gate.float()).to(xs.dtype) * up
    return grouped_mm(h, wd, group_sizes)


def _bucket_positions(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's position among the earlier rows of its bucket, in row
    order (`cumsum(onehot) - 1`); an id >= n is in no bucket (it counts
    for none, and reads bucket n - 1's count)."""
    onehot = ids[:, None] == torch.arange(n, device=ids.device)[None, :]
    pos = torch.cumsum(onehot, dim=0) - 1
    return torch.gather(pos, 1, torch.clamp(ids, max=n - 1)[:, None])[:, 0]


def _grouped_ffn(rows, expert_ids, n_experts: int, cap: int, wg, wu, wd):
    """Capacity-based grouped GEMM (the reference's 'dropping' form).

    rows: (N, d); expert_ids: (N,) in [0, n_experts] (n_experts marks
    padding).  Buckets rows per expert, `cap` rows each, in row order;
    runs batched matmuls (e, cap, d) x (e, d, f); scatters the results
    back to row order.  Rows past their expert's capacity, and padding,
    get zeros.  The bucket buffer has one overflow slot per expert that
    takes every row past capacity and is cut away."""
    d = rows.shape[1]
    e_c = torch.clamp(expert_ids, max=n_experts - 1)
    pos_of = torch.where(expert_ids < n_experts,
                         _bucket_positions(expert_ids, n_experts),
                         torch.full_like(expert_ids, cap))
    valid = pos_of < cap
    slot = torch.where(valid, pos_of, cap)
    buck = rows.new_zeros((n_experts, cap + 1, d)).index_put(
        (e_c, slot), rows)[:, :cap]
    gate = torch.bmm(buck, wg)
    up = torch.bmm(buck, wu)
    h = F.silu(gate.float()).to(rows.dtype) * up
    out = torch.bmm(h, wd).reshape(n_experts * cap, d)
    got = out[e_c * cap + torch.clamp(pos_of, max=cap - 1)]
    return torch.where(valid[:, None], got, 0.0)


def moe_block_expert_parallel(params, x, cfg: ModelConfig, ctx):
    """Expert parallelism: E/n experts per rank of the expert axis; token
    rows travel to their expert's rank over all-to-all and return.

    x: (B, S, d), this rank's part of the batch; its data block of
    tokens (`_data_block`: its rows, or under a sequence split the
    reference's block) the ranks of the expert axis split in n_e equal
    parts (the reference's P((*data_axes, axis)) sharding of the tokens,
    data-major); each part's outputs are gathered back over the expert
    axis, and the block's returned to x's positions.  The expert stacks
    are this rank's E / n_e experts, (E / n_e, d, ff) and (E / n_e, ff,
    d).  Rows past a
    destination's budget C, or past an expert's capacity, contribute
    zeros."""
    from ..runtime.parallel import all_gather, all_to_all, pmean
    moe_block_expert_parallel.calls += 1
    mesh = get_abstract_mesh()
    ax = ctx.expert_axis
    n_e = mesh.shape[ax]
    data_axes = _row_axes(mesh, ctx)
    block, back_to_x = _data_block(x, mesh, ctx)
    d = x.shape[-1]
    K, E = cfg.experts_per_token, cfg.n_experts
    E_local = E // n_e
    T_loc = block.shape[0] // n_e
    N = T_loc * K                                   # local expanded rows
    C = max(1, int(-(-N // n_e) * ctx.capacity_factor))  # per-dest budget
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    x2 = block.narrow(0, mesh.index(ax) * T_loc, T_loc)

    w, idx, aux = _local_route(params["router"], x2, cfg)
    flat_e = idx.reshape(-1)                         # (N,)
    dest = flat_e // E_local
    pos_of = _bucket_positions(dest, n_e)
    valid = pos_of < C
    slot = torch.where(valid, pos_of, C)             # overflow -> dropped
    rows = x2.repeat_interleave(K, dim=0)
    send = x2.new_zeros((n_e, C + 1, d)).index_put((dest, slot), rows)
    meta = torch.full((n_e, C + 1), E_local, dtype=flat_e.dtype,
                      device=x.device).index_put((dest, slot),
                                                 flat_e % E_local)
    recv = all_to_all(send[:, :C], mesh, ax)
    rmeta = all_to_all(meta[:, :C], mesh, ax)
    cap_e = max(1, int(-(-T_loc * K // E_local) * ctx.capacity_factor))
    out = _grouped_ffn(recv.reshape(n_e * C, d), rmeta.reshape(n_e * C),
                       E_local, cap_e, wg, wu, wd).reshape(n_e, C, d)
    back = all_to_all(out, mesh, ax).reshape(n_e * C, d)
    gathered = back[dest * C + torch.clamp(pos_of, max=C - 1)]
    gathered = torch.where(valid[:, None], gathered, 0.0)
    y = torch.einsum("tkd,tk->td", gathered.reshape(T_loc, K, d), w)
    aux = pmean(aux, mesh, (*data_axes, ax))
    return back_to_x(all_gather(y, mesh, (ax,))), aux


def moe_block_tp_ff(params, x, cfg: ModelConfig, ctx):
    """Tensor parallelism over the expert hidden dim (few-expert MoE like
    mixtral where E <= n_shards): rows stay put, every rank of the expert
    axis computes its ff-slice for every token of this rank's data block
    (`_data_block`), and the partial results are summed over the axis.
    The expert stacks are this rank's slice of the hidden dim, (E, d,
    ff / n_e) and (E, ff / n_e, d)."""
    from ..runtime.parallel import pmean, psum
    moe_block_tp_ff.calls += 1
    mesh = get_abstract_mesh()
    ax = ctx.expert_axis
    data_axes = _row_axes(mesh, ctx)
    x2, back_to_x = _data_block(x, mesh, ctx)
    T_loc, d = x2.shape
    K, E = cfg.experts_per_token, cfg.n_experts
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]

    w, idx, aux = _local_route(params["router"], x2, cfg)
    rows = x2.repeat_interleave(K, dim=0)
    cap = max(1, int(-(-T_loc * K // E) * ctx.capacity_factor))
    part = _grouped_ffn(rows, idx.reshape(-1), E, cap, wg, wu, wd)
    out = psum(part, mesh, (ax,))                    # partial over ff slice
    y = torch.einsum("tkd,tk->td", out.reshape(T_loc, K, d), w)
    aux = pmean(aux, mesh, (*data_axes, ax))
    return back_to_x(y), aux


#: calls since the last reset (chip_smoke.py reads them)
moe_block_expert_parallel.calls = 0
moe_block_tp_ff.calls = 0
