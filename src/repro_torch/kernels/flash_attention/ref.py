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


def flash_plain(q, k, v, q_pos, k_pos, *, scale: float, causal: bool = True,
                window: Optional[int] = None, softcap: Optional[float] = None,
                block_k: int = 128) -> torch.Tensor:
    """The tensor-core kernel's arithmetic, in plain PyTorch: an online
    softmax over key tiles of `block_k`, fp32 scores, running max, sum and
    accumulator; for bf16 inputs the weights P are rounded to bf16 before
    P.V and the sum `l` adds the rounded P.  No padding: the last tile is
    cut at T.  q: (B, H, Sq, D); k/v: (B, K, Sk, D) with K | H (GQA).
    """
    B, H, Sq, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    rounded = q.dtype == torch.bfloat16
    qg = q.reshape(B, K, G, Sq, D).float()
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, T, block_k):
        kt = k[:, :, k0:k0 + block_k].float()
        vt = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bkgsd,bktd->bkgst", qg, kt) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            kp = k_pos[k0:k0 + block_k]
            vis = kp[None, :] <= q_pos[:, None]
            if window is not None:
                vis &= (q_pos[:, None].long() - kp[None, :].long()) < window
            s = s.masked_fill(~vis, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if rounded:
            p = p.to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,bktd->bkgsd", p,
                                                    vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)
