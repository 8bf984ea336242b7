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

Tensor parallelism over 'model' (on a mesh, with the projections this
rank's 'model' shards, `runtime/sharding.py: compute_spec`): each
projection runs column-parallel on the rank's columns.  When the query
heads divide over 'model', the rank attends with its H / model heads
(its columns of wq), reads the kv heads they need (gathered over 'model'
when its wk columns are not exactly those) and its rows of wo finish a
row-parallel product summed over 'model'.  When they do not (a shard
splits a head), the projections are gathered whole, every rank attends
with every head, and wo is row-parallel on the rank's slice of that
output.  A decode cache split along its sequence (`SeqShard`: the rules
put the ring on 'model' when the kv heads do not divide there) is
written only by the rank that holds position `pos`; each rank attends
over its slots (`decode_partial`) and the partial maxima, sums and
outputs, gathered over the split's axes, are combined by
`combine_partials`.

Context parallelism (a train batch whose rows do not divide over the
data axes, split on its sequence there, `sharding.leaf_shard`): each
rank's queries, at its own positions, attend over the keys and values
of the whole sequence, gathered over the data axes after RoPE
(`whole_sequence`; the gather is over the data axes only, so the
tensor parallelism over 'model' is as above).  The kernel takes the
query and key positions apart and skips tiles by position, so the
rank's queries past position 0 against the longer key sequence go
through it as they are; "auto" on the CPU chooses by the gathered
length, as the meshless forward does.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A decode cache whose ring of `length` slots is split over the mesh
    `axes`: this rank holds slots [start, start + its cache's length)."""
    length: int
    start: int
    axes: Tuple[str, ...]


def _attending(cfg: ModelConfig, wq: torch.Tensor, every: bool = False
               ) -> Tuple[range, range]:
    """(query heads, kv heads) this rank attends with: its H / model
    heads when wq is its 'model' shard of whole heads that fill whole kv
    groups or sit in one (so that the GQA reshape pairs them with the kv
    heads they read), and not `every`; else every head."""
    from ..runtime.parallel import model_slice
    H, hd = cfg.n_heads, cfg.head_dim
    G = H // cfg.n_kv_heads
    cols = model_slice("attn/wq", wq.shape, H * hd)
    heads = range(H)
    if cols is not None and not every and (cols.stop - cols.start) % hd == 0:
        mine = range(cols.start // hd, cols.stop // hd)
        if (mine.start % G == 0 and len(mine) % G == 0) or \
                mine.start // G == (mine.stop - 1) // G:
            heads = mine
    return heads, range(heads.start // G, (heads.stop - 1) // G + 1)


def _project(params: Params, x: torch.Tensor, cfg: ModelConfig, name: str,
             heads: range) -> torch.Tensor:
    """The heads `heads` of projection `name` ("q", "k", "v") of x:
    (B, S, len(heads), head_dim).  On the rank's columns of a 'model'
    shard; gathered over 'model' first when those are not `heads`."""
    from ..runtime.parallel import gather_model, model_slice
    B, S, _ = x.shape
    hd = cfg.head_dim
    n = cfg.n_heads if name == "q" else cfg.n_kv_heads
    w = params[f"w{name}"]
    cols = model_slice(f"attn/w{name}", w.shape, n * hd)
    y = x @ w
    if cfg.qkv_bias:
        y = y + params[f"b{name}"][slice(None) if cols is None else cols]
    if cols is not None and cols != slice(heads.start * hd, heads.stop * hd):
        y, cols = gather_model(y, -1), None
    y = y.reshape(B, S, -1, hd)
    return y if cols is not None else y[:, :, heads.start:heads.stop]


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 which: str = "qkv") -> Tuple[torch.Tensor, ...]:
    """The projections `which` names ("qkv", "q", "kv"), each (B, S,
    heads, head_dim): the query heads this rank attends with and the kv
    heads they read (`_attending`).  A projection the caller would
    discard is not computed: the cross-attention's query side needs no
    keys and values, its encoder side no query (the reference computes
    them, and XLA drops them as dead code)."""
    heads, kv = _attending(cfg, params["wq"])
    return tuple(_project(params, x, cfg, name, heads if name == "q" else kv)
                 for name in which)


def _out_proj(params: Params, out: torch.Tensor, cfg: ModelConfig,
              heads: range) -> torch.Tensor:
    """(B, S, len(heads) * head_dim) @ wo; row-parallel, summed over
    'model', when wo is the rank's 'model' shard (on every head's output,
    the rank's slice of it)."""
    from ..runtime.parallel import model_slice, psum_model
    wo = params["wo"]
    rows = model_slice("attn/wo", wo.shape, cfg.n_heads * cfg.head_dim)
    if rows is None:
        return out @ wo
    if len(heads) == cfg.n_heads:
        out = out[..., rows]
    return psum_model(out @ wo)


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


def whole_sequence(k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, split):
    """(k, v, their positions) of the whole sequence: under a sequence
    split over the data axes (`sharding.SeqSplit`), the ranks' parts
    gathered on dim 1 (the gather's adjoint sums every rank's gradient
    of the keys and keeps the rank's own), else as they are."""
    from ..launch.mesh import get_abstract_mesh
    from ..runtime.parallel import all_gather
    if split is None or not split.axes:
        return k, v, positions
    mesh = get_abstract_mesh()
    return (all_gather(k, mesh, split.axes, 1),
            all_gather(v, mesh, split.axes, 1),
            torch.arange(split.length, dtype=torch.int32, device=k.device))


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, window: Optional[int] = None,
              impl: str = "auto", kv_override=None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill).

    positions: (S,) int32, x's places in the whole sequence.
    kv_override: (k, v, k_pos) for cross-attention, k and v as
    `_project_qkv(..., "kv")` gives them (all the keys, gathered).  Under
    a sequence split over the data axes (`parallel.get_seq_split`) the
    self-attention gathers the rotated keys and the values of the whole
    sequence over those axes, at positions 0..length; the queries keep
    x's.
    """
    from ..runtime.parallel import get_seq_split
    B, S, _ = x.shape
    cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_fraction,
                                cfg.rope_theta, positions)
    heads, kv = _attending(cfg, params["wq"])
    q = _project(params, x, cfg, "q", heads)
    if kv_override is None:
        k = _project(params, x, cfg, "k", kv)
        v = _project(params, x, cfg, "v", kv)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
        k, v, k_pos = whole_sequence(k, v, positions, get_seq_split())
    else:
        k, v, k_pos = kv_override
        window = None
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    scale = cfg.head_dim ** -0.5
    out = sdpa(q, k, v, positions, k_pos, window, cfg.attn_softcap, scale,
               impl, causal=causal)
    return _out_proj(params, out.reshape(B, S, -1), cfg, heads)


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


def decode_partial(q, k, v, q_pos, k_pos, window, softcap, scale,
                   causal: bool = True):
    """`sdpa_naive` over a slice of the keys, left unnormalised, in fp32:
    (max (B, K, G, S), sum (B, K, G, S), out (B, K, G, S, D)), out the
    sum over the slice's keys of exp(score - max) v."""
    q, k, v = _common_dtype(q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    s = _softcap(s * scale, softcap)
    s = s.masked_fill(~_mask(q_pos, k_pos, window, causal), NEG_INF)
    top = s.amax(dim=-1)
    p = torch.exp(s - top[..., None])
    return top, p.sum(dim=-1), torch.einsum("bkgst,btkd->bkgsd", p,
                                            v.float())


def combine_partials(top: torch.Tensor, total: torch.Tensor,
                     out: torch.Tensor, dtype) -> torch.Tensor:
    """The attention over all keys from `decode_partial`'s results on
    slices of them, stacked on a leading axis: (B, S, H, D) in `dtype`."""
    best = top.amax(dim=0)
    w = torch.exp(top - best)
    num = (w[..., None] * out).sum(dim=0)
    o = num / (w * total).sum(dim=0)[..., None]
    B, K, G, S, D = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, K * G, D).to(dtype)


def decode_attention(params: Params, x: torch.Tensor, cache: Dict,
                     cfg: ModelConfig, pos: int,
                     window: Optional[int] = None, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B, 1, d); pos: the int position.

    The cache is a ring buffer of length min(max_len, window).  Unlike the
    reference, which returns a new cache, the new key and value are
    written into `cache` in place (the cache is the largest state of a
    server); the same dict is returned.  On a mesh the cache holds this
    rank's rows and either its kv heads on 'model' or, under
    `cache["seq"]` (a `SeqShard`), its slots of every head.
    """
    B = x.shape[0]
    pos = int(pos)
    ck, cv = cache["k"], cache["v"]
    seq: Optional[SeqShard] = cache.get("seq")
    L = seq.length if seq is not None else ck.shape[1]
    start = seq.start if seq is not None else 0
    heads, kv = _attending(cfg, params["wq"], every=seq is not None)
    # the cache's kv heads: the rank's on 'model', or every one
    have = kv if ck.shape[2] < cfg.n_kv_heads else range(cfg.n_kv_heads)
    q = _project(params, x, cfg, "q", heads)
    if not cross:
        k_new = _project(params, x, cfg, "k", have)
        v_new = _project(params, x, cfg, "v", have)
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_fraction,
                                    cfg.rope_theta, posv)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k_new = apply_rope(k_new, cos, sin, cfg.rope_fraction)
        slot = pos % L - start
        if 0 <= slot < ck.shape[1]:
            ck[:, slot] = k_new[:, 0].to(ck.dtype)
            cv[:, slot] = v_new[:, 0].to(cv.dtype)
        k_pos = ring_positions(pos, L, x.device)[start:start + ck.shape[1]]
    else:
        # cross-attention: the cache holds the fixed encoder projections
        # and every encoder position is visible (no causal mask, no RoPE)
        k_pos = torch.arange(start, start + ck.shape[1], dtype=torch.int32,
                             device=x.device)
    rk = ck.narrow(2, kv.start - have.start, len(kv))
    rv = cv.narrow(2, kv.start - have.start, len(kv))
    scale = cfg.head_dim ** -0.5
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if seq is None:
        out = sdpa_naive(q, rk, rv, q_pos, k_pos, window, cfg.attn_softcap,
                         scale, causal=not cross)
    else:
        from ..launch.mesh import get_abstract_mesh
        from ..runtime.parallel import all_gather
        mesh = get_abstract_mesh()
        parts = decode_partial(q, rk, rv, q_pos, k_pos, window,
                               cfg.attn_softcap, scale, causal=not cross)
        dtype = torch.promote_types(torch.promote_types(q.dtype, rk.dtype),
                                    rv.dtype)
        out = combine_partials(*(all_gather(t[None], mesh, seq.axes)
                                 for t in parts), dtype)
    return _out_proj(params, out.reshape(B, 1, -1), cfg, heads), cache
