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

Only the reference's single-device path (`moe_block_gspmd`) is ported.
Its ParallelContext paths (`moe_block_expert_parallel`,
`moe_block_tp_ff` and `_grouped_ffn`: shard_map with all_to_all and
psum) belong to the distribution slice (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
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
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    aux = E * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux


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


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss); the reference's `moe_block_gspmd`."""
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
    group_sizes = torch.bincount(flat_e, minlength=E)

    gate = grouped_mm(xs, params["w_gate"], group_sizes)
    up = grouped_mm(xs, params["w_up"], group_sizes)
    h = F.silu(gate.float()).to(x.dtype) * up
    out = grouped_mm(h, params["w_down"], group_sizes)

    out = out[inv].reshape(B * S, K, d)                    # unsort, fold K
    y = torch.einsum("tkd,tk->td", out, w)
    return y.reshape(B, S, d), aux
