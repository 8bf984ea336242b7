"""Attention: GQA, RoPE (partial), QKV bias, logit softcap, sliding window,
full-sequence (prefill) and single-token decode with a ring-buffer KV cache.

Three interchangeable inner implementations, numerically equivalent to
rounding (tests assert allclose), selected by `impl`:

- "naive":   materialises (B, K, G, S, T) scores;
- "chunked": a loop over KV chunks with an online softmax, O(S*chunk)
             score memory;
- "kernel":  the hand-written CUDA flash-attention kernel
             (`kernels/flash_attention`); on CPU tensors its plain version.

"auto" takes the kernel on CUDA tensors and, on CPU tensors, "chunked"
above T=2048 and "naive" below, as the reference does.  Decode attention
is always "naive", as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .layers import _dense_init, apply_rope, rope_frequencies

Params = Dict[str, torch.Tensor]
NEG_INF = -2.0 ** 30
INT32_MAX = 2 ** 31 - 1
IMPLS = ("auto", "naive", "chunked", "kernel")


def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> Params:
    d, h = cfg.d_model, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * h), device=device),
        "wk": _dense_init(gen, (d, cfg.n_kv_heads * h), device=device),
        "wv": _dense_init(gen, (d, cfg.n_kv_heads * h), device=device),
        "wo": _dense_init(gen, (cfg.n_heads * h, d), device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * h,), dtype=torch.bfloat16,
                                  device=device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 which: str = "qkv") -> Tuple[torch.Tensor, ...]:
    """The projections `which` names ("qkv", "q", "kv"), each (B, S,
    heads, head_dim).  A projection the caller would discard is not
    computed: the cross-attention's query side needs no keys and values,
    its encoder side no query (the reference computes them, and XLA drops
    them as dead code)."""
    B, S, _ = x.shape
    heads = {"q": cfg.n_heads, "k": cfg.n_kv_heads, "v": cfg.n_kv_heads}
    out = []
    for name in which:
        y = x @ params[f"w{name}"]
        if cfg.qkv_bias:
            y = y + params[f"b{name}"]
        out.append(y.reshape(B, S, heads[name], cfg.head_dim))
    return tuple(out)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: Optional[int], causal: bool = True) -> torch.Tensor:
    """(S, T) boolean: causal, optionally sliding-window."""
    if not causal:
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None].long() - k_pos[None, :].long()) < window
    return m


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _common_dtype(q, k, v):
    """jnp.einsum promotes mixed inputs (an fp32 query against the bf16
    cache); torch's matmul does not, so promote explicitly."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def sdpa_naive(q, k, v, q_pos, k_pos, window, softcap, scale,
               causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,K,D) -> (B,S,H,D)."""
    q, k, v = _common_dtype(q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = _softcap(scores * scale, softcap)
    scores = scores.masked_fill(~_mask(q_pos, k_pos, window, causal),
                                NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, S, H, D)


def sdpa_chunked(q, k, v, q_pos, k_pos, window, softcap, scale,
                 chunk: int = 1024, causal: bool = True) -> torch.Tensor:
    """Online-softmax streaming over KV chunks: O(S*chunk) score memory.

    The last chunk is shorter instead of zero-padded, so no padded key is
    ever attended (the reference pads with keys that stay visible when not
    causal)."""
    q, k, v = _common_dtype(q, k, v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, T)
    qg = q.reshape(B, S, K, G, D)
    m_run = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pb = k_pos[c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb).float()
        s = _softcap(s * scale, softcap)
        s = s.masked_fill(~_mask(q_pos, pb, window, causal), NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype), vb).float()
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def sdpa(q, k, v, q_pos, k_pos, window, softcap, scale,
         impl: str = "auto", causal: bool = True) -> torch.Tensor:
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    if impl == "kernel" or (impl == "auto" and q.device.type == "cuda"):
        return flash_attention(q, k, v, q_pos, k_pos, window=window,
                               softcap=softcap, scale=scale, causal=causal)
    if impl == "auto":
        impl = "chunked" if k.shape[1] > 2048 else "naive"
    if impl == "chunked":
        return sdpa_chunked(q, k, v, q_pos, k_pos, window, softcap, scale,
                            causal=causal)
    return sdpa_naive(q, k, v, q_pos, k_pos, window, softcap, scale,
                      causal=causal)


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, window: Optional[int] = None,
              impl: str = "auto", kv_override=None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill).

    positions: (S,) int32.  kv_override: (k, v, k_pos) for cross-attention.
    """
    B, S, _ = x.shape
    cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_fraction,
                                cfg.rope_theta, positions)
    if kv_override is None:
        q, k, v = _project_qkv(params, x, cfg)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
        k_pos = positions
    else:
        (q,) = _project_qkv(params, x, cfg, "q")
        k, v, k_pos = kv_override
        window = None
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    scale = cfg.head_dim ** -0.5
    out = sdpa(q, k, v, positions, k_pos, window, cfg.attn_softcap, scale,
               impl, causal=causal)
    return out.reshape(B, S, -1) @ params["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Ring-buffer KV cache in bf16; sliding-window layers cap it at the
    window."""
    L = min(max_len, window) if window else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def ring_positions(pos: int, L: int, device=None) -> torch.Tensor:
    """Absolute position held in each of the L ring slots after writing
    position `pos`; slots not written yet hold int32 max (never visible)."""
    slots = torch.arange(L, dtype=torch.int64, device=device)
    wrap = (pos // L) * L
    k_pos = torch.where(slots <= pos % L, wrap + slots, wrap - L + slots)
    k_pos = torch.where(k_pos < 0, INT32_MAX, k_pos)
    return k_pos.to(torch.int32)


def decode_attention(params: Params, x: torch.Tensor, cache: Dict,
                     cfg: ModelConfig, pos: int,
                     window: Optional[int] = None, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B, 1, d); pos: the int position.

    The cache is a ring buffer of length min(max_len, window).  Unlike the
    reference, which returns a new cache, the new key and value are
    written into `cache` in place (the cache is the largest state of a
    server); the same dict is returned.
    """
    B = x.shape[0]
    pos = int(pos)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    if not cross:
        q, k_new, v_new = _project_qkv(params, x, cfg)
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_fraction,
                                    cfg.rope_theta, posv)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k_new = apply_rope(k_new, cos, sin, cfg.rope_fraction)
        slot = pos % L
        ck[:, slot] = k_new[:, 0].to(ck.dtype)
        cv[:, slot] = v_new[:, 0].to(cv.dtype)
        k_pos = ring_positions(pos, L, x.device)
    else:
        # cross-attention: the cache holds the fixed encoder projections
        # and every encoder position is visible (no causal mask, no RoPE)
        (q,) = _project_qkv(params, x, cfg, "q")
        k_pos = torch.arange(L, dtype=torch.int32, device=x.device)
    scale = cfg.head_dim ** -0.5
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    out = sdpa_naive(q, ck, cv, q_pos, k_pos, window, cfg.attn_softcap,
                     scale, causal=not cross)
    y = out.reshape(B, 1, -1) @ params["wo"]
    return y, cache
