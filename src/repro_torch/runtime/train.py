"""Training step: CE loss, remat, gradient accumulation, optional gradient
compression, optimizer update.

A port of the JAX package's `runtime/train.py`.  Where the reference
jits one XLA program, this runs eagerly: autograd gives the gradients
(in the params' dtype, as `jax.value_and_grad` does), a Python loop
takes the place of the microbatch `lax.scan`, and remat is the model's
`torch.utils.checkpoint` over each unit.  On the card the model's norms
and attention go through the hand-written kernels (`attention_impl`
"auto"); the RMSNorm gradient is the backward kernel, the SSD scan's
the SSD backward kernel, the attention gradient the VJP of the plain
attention, as in the reference.

On a mesh (`make_train_step(..., mesh=...)`) the step computes what the
reference's sharded `jit` computes, with the state's leaves DTensors
placed by `runtime/sharding.py: state_shardings`:

- the model takes the parameter DTensors and gathers each weight over
  the data axes where it uses it (FSDP's gather, `redistribute`,
  differentiable, whose adjoint is the reduce-scatter): the leaves
  outside the unit loop once a step, each unit's one unit at a time
  inside the remat boundary, so that the recompute gathers again
  (`runtime/parallel.py`: `gather_params`, `gather_unit`).  It keeps its
  'model' shard of the weights that the model code multiplies
  tensor-parallel (`sharding.compute_spec`: column- and row-parallel
  projections, the Mamba2 mixer's projections, the vocab-parallel
  embedding, unembedding and cross entropy, the MoE expert stacks at
  their path's shard); every other weight is gathered whole.  It runs
  its `batch_spec` shard of the batch: its rows over the data axes;
  where they do not divide the rows, its part of the sequence (context
  parallelism: the positions are the rank's own, the attention gathers
  the keys and values of the whole sequence over the data axes, the
  Mamba2 mixer carries its conv window and its state across the ranks,
  the MoE blocks take the reference's blocks of tokens); where they
  divide neither, the whole batch on every rank, as GSPMD runs the
  reference's step on a batch sharded so (`mesh_apply`);
- each rank's loss is scaled by 1 / (number of ranks), so that the
  gradients' reduction back to the parameters' shards gives the mean
  over the global batch (`runtime/parallel.py`: the collectives'
  adjoints are those of a sum of the ranks' losses);
- the optimizer updates the shards (AdamW as DTensor operations, the
  global gradient norm reducing across the shards; Adafactor on each
  rank's local shards, its means summed over the axes that split them),
  and the new state is placed by the same shardings (`out_shardings`);
- with compression, each gradient is gathered whole and quantised as
  the reference quantises the global array.

The MoE experts compute through the reference's explicit paths
(`models/moe.py`) on the shards those paths take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import get_abstract_mesh, use_mesh
from ..models import build_model
from ..optim.optimizers import OptimizerConfig, build_optimizer
from ..tree import leaves, tree_map
from .compression import CompressionConfig, compress_decompress
from .parallel import (axis_size, batch_splits, gather_model, model_slice,
                       pmax, psum, psum_model)
from .sharding import leaf_shard, place, state_shardings


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1            # gradient accumulation
    aux_loss_weight: float = 0.01    # MoE load-balance loss
    z_loss_weight: float = 1e-4      # logit normalisation loss
    compression: Optional[CompressionConfig] = None
    attention_impl: str = "auto"
    remat: bool = True
    loss_impl: str = "onehot"        # "onehot" | "gather"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss_weight: float = 0.0, impl: str = "onehot",
                  vocab_size: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over tokens (+z-loss). logits fp32 (B,S,V), labels (B,S).

    The logits may be this rank's 'model' shard of `vocab_size` entries
    (the vocab-parallel unembedding).  impl="onehot", the reference's
    shard-local form, compares the shard's vocabulary iota with the label
    and sums the masked logits; the logsumexp is taken on the shard as
    its maximum and sum of exponentials, combined over 'model' (the
    maximum, then a sum), and the label's logit is summed over 'model'.
    With the vocabulary whole the combines are skipped.  impl="gather"
    picks each label's logit by index, from logits gathered whole over
    'model' first (what GSPMD makes of the reference's
    `take_along_axis`).  Both give the same value."""
    labels = labels.long()
    V = logits.shape[-1]
    cols = model_slice("unembed", logits.shape, vocab_size or V)
    if cols is not None and impl == "gather":
        logits, cols = gather_model(logits, -1), None
    mesh = get_abstract_mesh()
    top = logits.amax(dim=-1)
    if cols is not None:
        top = pmax(top, mesh, ("model",))
    top = top.detach()
    total = torch.exp(logits - top[..., None]).sum(dim=-1)
    if impl == "gather":
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        start = 0 if cols is None else cols.start
        hit = (torch.arange(start, start + logits.shape[-1],
                            device=logits.device) == labels[..., None])
        ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    if cols is not None:
        total, ll = psum_model(total), psum_model(ll)
    lse = top + torch.log(total)
    ce = (lse - ll).mean()
    zl = (lse ** 2).mean()
    return ce + z_loss_weight * zl, ce


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, device="cuda"):
    model = build_model(cfg, impl=tcfg.attention_impl, remat=tcfg.remat,
                        device=device)

    def loss_fn(params, batch):
        logits, aux = model.apply(params, batch)
        loss, ce = cross_entropy(logits, batch["labels"],
                                 tcfg.z_loss_weight, tcfg.loss_impl,
                                 cfg.vocab_size)
        total = loss + tcfg.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of loss_fn at params: the gradients in the
    params' dtypes, a tree of params' structure; metrics detached."""
    live = []

    def track(p):
        live.append(p.detach().requires_grad_())
        return live[-1]

    with torch.enable_grad():
        loss, metrics = loss_fn(tree_map(track, params), batch)
        found = iter(torch.autograd.grad(loss, live, allow_unused=True))

    def grad_of(p):     # same traversal order as `track`
        g = next(found)
        # a leaf the loss does not reach gets zeros, as jax.grad gives
        return torch.zeros_like(p) if g is None else g

    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(grad_of, params))


def compute_grads(loss_fn, params, batch, microbatches: int = 1):
    """(loss, {"ce", "aux"}, grads) over the batch.

    With microbatches == 1 the gradients are in the params' dtypes.  With
    k > 1 the batch's leading axis is split in k; each microbatch's
    gradients are cast to float32, divided by k and summed in float32,
    and the loss, ce and aux are averaged the same way, as the reference's
    `lax.scan` does (same math, 1/k of the activation memory).  On a
    mesh each microbatch takes its shard by its own `batch_spec`
    (`mesh_apply`): one whose rows do not divide over the data axes
    splits its sequence, or is replicated, as the reference's scan body
    is sharded."""
    if microbatches <= 1:
        (loss, m), grads = value_and_grad(loss_fn, params, batch)
        return loss, m, grads
    k = microbatches
    micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])
             for name, x in batch.items()}
    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    loss_a = ce_a = aux_a = torch.zeros((), dtype=torch.float32,
                                        device=leaves(params)[0].device)
    for i in range(k):
        (loss, m), g = value_and_grad(
            loss_fn, params, {name: x[i] for name, x in micro.items()})
        acc = tree_map(lambda a, b: a + b.float() / k, acc, g)
        loss_a = loss_a + loss / k
        ce_a = ce_a + m["ce"] / k
        aux_a = aux_a + m["aux"] / k
    return loss_a, {"ce": ce_a, "aux": aux_a}, acc


def mesh_apply(fn, mesh):
    """fn(params, batch) on a mesh, under `use_mesh(mesh)`: params the
    DTensors as placed, which the model gathers where it uses them
    (`runtime/parallel.py`), batch global, each leaf's shard taken by its
    own `batch_spec` (`sharding.leaf_shard`: its rows, else its part of
    the sequence, else all of it) and its split recorded for the model
    (`parallel.batch_splits`)."""
    def apply(params, batch):
        shards = {k: leaf_shard(mesh, v) for k, v in batch.items()}
        with use_mesh(mesh), batch_splits(
                {k: split for k, (_, split) in shards.items()}):
            return fn(params, {k: x for k, (x, _) in shards.items()})

    return apply


def mesh_loss_fn(loss_fn, mesh):
    """loss_fn(params, batch) on a mesh (`mesh_apply`), the loss and
    metrics scaled by 1 / ranks, so that they, and the gradients, add up
    over the ranks to the global batch's.  Each rank's loss is the mean
    over the tokens it holds, so the sum is the global mean in each of
    `batch_spec`'s layouts: split over the rows or over the sequence,
    every rank of the data axes holds an equal share of the tokens (and
    the ranks of 'model' the same ones); replicated, every rank holds the
    whole batch."""
    world = axis_size(mesh, mesh.shape)
    apply = mesh_apply(loss_fn, mesh)

    def mesh_loss(params, batch):
        total, m = apply(params, batch)
        return total / world, {k: v / world for k, v in m.items()}

    return mesh_loss


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
                    mesh=None):
    """Returns (train_step, init_state).

    train_step(state, batch) -> (state, metrics); state = {"params",
    "opt", "step"}, the step an int32 scalar; metrics {"ce", "aux",
    "loss"} are scalar tensors on the device (reading one waits for the
    step).  batch: {"tokens" or "embeds", "labels"} tensors on `device`;
    `compute_grads` says what microbatches > 1 does.  Compression, if
    configured, quantises the gradients before the optimizer's update.
    init_state(gen) draws the params from a torch.Generator.

    With a mesh, the state's leaves are DTensors placed by
    `state_shardings` (`sharding.place`; init_state returns plain
    tensors, every rank the same), the batch is the global batch, the
    metrics are the global batch's on every rank, and the step is the
    module docstring's."""
    loss_fn = make_loss_fn(cfg, tcfg, device)
    opt = build_optimizer(tcfg.optimizer)
    if mesh is None:
        def train_step(state, batch):
            params, opt_state, step = (state["params"], state["opt"],
                                       state["step"])
            loss, metrics, grads = compute_grads(loss_fn, params, batch,
                                                 tcfg.microbatches)
            if tcfg.compression is not None:
                grads = compress_decompress(grads, tcfg.compression)
            new_params, new_opt = opt.update(grads, opt_state, params, step)
            metrics = dict(metrics, loss=loss)
            return {"params": new_params, "opt": new_opt,
                    "step": step + 1}, metrics
    else:
        train_step = _mesh_train_step(loss_fn, opt, tcfg, mesh)

    def init_state(gen: torch.Generator):
        model = build_model(cfg, impl=tcfg.attention_impl, remat=tcfg.remat,
                            device=device)
        params = model.init(gen)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    return train_step, init_state


def _mesh_train_step(loss_fn, opt, tcfg: TrainConfig, mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    mesh_loss = mesh_loss_fn(loss_fn, mesh)
    every = tuple(mesh.shape)

    def train_step(state, batch):
        shardings = state_shardings(mesh, state, tcfg.optimizer.name)
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, metrics, grads = compute_grads(mesh_loss, params, batch,
                                             tcfg.microbatches)
        loss = psum(loss, mesh, every)
        metrics = {k: psum(v, mesh, every) for k, v in metrics.items()}
        if tcfg.compression is not None:
            grads = place(compress_decompress(
                tree_map(lambda g: g.full_tensor(), grads),
                tcfg.compression), shardings["params"])
        with implicit_replication():
            new_params, new_opt = opt.update(grads, opt_state, params,
                                             step.to_local())
        new = place({"params": new_params, "opt": new_opt, "step": step + 1},
                    shardings)
        return new, dict(metrics, loss=loss)

    return train_step
