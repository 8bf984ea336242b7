"""Plain PyTorch version of the flash-attention kernel."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, q_pos, k_pos, *, scale: float,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, K, Sk, D) with K | H (GQA)."""
    B, H, Sq, D = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            m &= (q_pos[:, None].long() - k_pos[None, :].long()) < window
        s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
