"""Training step: CE loss, remat, gradient accumulation, optional gradient
compression, optimizer update.

A port of the JAX package's `runtime/train.py`.  Where the reference
jits one XLA program, this runs eagerly: autograd gives the gradients
(in the params' dtype, as `jax.value_and_grad` does), a Python loop
takes the place of the microbatch `lax.scan`, and remat is the model's
`torch.utils.checkpoint` over each unit.  On the card the model's norms
and attention go through the hand-written kernels (`attention_impl`
"auto"); the RMSNorm gradient is the backward kernel, the attention
gradient the VJP of the plain attention, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import build_model
from ..optim.optimizers import OptimizerConfig, build_optimizer
from ..tree import leaves, tree_map
from .compression import CompressionConfig, compress_decompress


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
                  z_loss_weight: float = 0.0, impl: str = "onehot"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over tokens (+z-loss). logits fp32 (B,S,V), labels (B,S).

    impl="gather" picks each label's logit by index; impl="onehot"
    compares a vocabulary iota with the label and sums the masked logits,
    the reference's shard-local form.  Both give the same value."""
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    if impl == "gather":
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        V = logits.shape[-1]
        hit = (torch.arange(V, device=logits.device)
               == labels[..., None])
        ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    ce = (lse - ll).mean()
    zl = (lse ** 2).mean()
    return ce + z_loss_weight * zl, ce


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, device="cuda"):
    model = build_model(cfg, impl=tcfg.attention_impl, remat=tcfg.remat,
                        device=device)

    def loss_fn(params, batch):
        logits, aux = model.apply(params, batch)
        loss, ce = cross_entropy(logits, batch["labels"],
                                 tcfg.z_loss_weight, tcfg.loss_impl)
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
    `lax.scan` does (same math, 1/k of the activation memory)."""
    if microbatches <= 1:
        (loss, m), grads = value_and_grad(loss_fn, params, batch)
        return loss, m, grads
    k = microbatches
    micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])
             for name, x in batch.items()}
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device="cuda"):
    """Returns (train_step, init_state).

    train_step(state, batch) -> (state, metrics); state = {"params",
    "opt", "step"}, the step an int32 scalar; metrics {"ce", "aux",
    "loss"} are scalar tensors on the device (reading one waits for the
    step).  batch: {"tokens" or "embeds", "labels"} tensors on `device`;
    `compute_grads` says what microbatches > 1 does.  Compression, if
    configured, quantises the gradients before the optimizer's update.
    init_state(gen) draws the params from a torch.Generator."""
    loss_fn = make_loss_fn(cfg, tcfg, device)
    opt = build_optimizer(tcfg.optimizer)

    def train_step(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, metrics, grads = compute_grads(loss_fn, params, batch,
                                             tcfg.microbatches)
        if tcfg.compression is not None:
            grads = compress_decompress(grads, tcfg.compression)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt, "step": step + 1}, \
            metrics

    def init_state(gen: torch.Generator):
        model = build_model(cfg, impl=tcfg.attention_impl, remat=tcfg.remat,
                            device=device)
        params = model.init(gen)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    return train_step, init_state
