"""Plain float32 reference of the port's decoder-only models.

Written from the architecture as the configuration files state it, in
plain `torch` operations and nothing else: no kernel, no cache, no
batching trick, nothing imported from the program.  It reads the weights
as the benchmark drew them, in the program's tree layout ((in, out)
matrices, layers stacked on leading axes), and computes in float32
whatever their dtype.

The layers are written here; each family's module
(`portbench/families/<family>.py`) puts them in its model's order.  A
`matmul` argument carries each weight product, so that the control
(`lowp.fp8_matmul`) can put a lower precision in the same place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def setup_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f32(scale)


def rope(x, positions, theta):
    """Rotate the interleaved pairs (x[2i], x[2i+1]) of each head.
    x: (B, S, H, D); positions: (S,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = positions.float()[:, None] * inv                    # (S, D/2)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1).flatten(-2)


def attention(p, h, cfg, positions, mm: Matmul, window=None):
    """Causal GQA over the whole sequence, one row and one group of
    query heads sharing a key head at a time."""
    B, S, _ = h.shape
    H, K, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(h, f32(p["wq"])).reshape(B, S, H, D)
    k = mm(h, f32(p["wk"])).reshape(B, S, K, D)
    v = mm(h, f32(p["wv"])).reshape(B, S, K, D)
    q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions,
                                                       cfg["rope_theta"])
    qpos, kpos = positions[:, None], positions[None, :]
    mask = kpos <= qpos
    if window:
        mask = mask & (qpos - kpos < window)
    out = torch.empty(B, S, K, H // K, D, dtype=q.dtype, device=q.device)
    for b in range(B):
        qg = q[b].reshape(S, K, H // K, D)
        for j in range(K):
            s = torch.einsum("sgd,td->gst", qg[:, j], k[b, :, j]) * D ** -0.5
            s = s.masked_fill(~mask, float("-inf"))
            out[b, :, j] = torch.einsum("gst,td->sgd", torch.softmax(s, -1),
                                        v[b, :, j])
    return mm(out.reshape(B, S, H * D), f32(p["wo"]))


def swiglu(x, w_gate, w_up, w_down, mm: Matmul):
    return mm(F.silu(mm(x, f32(w_gate))) * mm(x, f32(w_up)), f32(w_down))


def moe(p, h, cfg, mm: Matmul):
    """Top-k routing over all experts (softmax, the k largest
    probabilities with the lower index first on a tie, renormalised),
    each token's experts' SwiGLU outputs summed by those weights."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    probs = torch.softmax(mm(x, f32(p["router"])), -1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["experts_per_token"]
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                       mm)
            out = out.index_add(0, tok, y * w[tok, slot, None])
    return out.reshape(B, S, d)


def ssd(x, dt, A, Bm, Cm, chunk: int = 256):
    """The Mamba2 scan y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<k<=t} dt_k
    A) dt_s x_s, by chunks: a masked product inside each chunk, a
    recurrence on the (H, P, N) state across them.  x: (b, L, H, P); dt:
    (b, L, H); A: (H,); Bm, Cm: (b, L, N)."""
    b, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd: L={L} is not a multiple of the chunk {Q}")
    nc = L // Q
    xc, dtc = x.reshape(b, nc, Q, H, P), dt.reshape(b, nc, Q, H)
    Bc, Cc = Bm.reshape(b, nc, Q, N), Cm.reshape(b, nc, Q, N)
    cum = torch.cumsum(dtc * A, dim=2)                       # (b,nc,Q,H)
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~lower[None, None, :, :, None], float("-inf"))       # (b,nc,t,s,H)
    w = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None] * torch.exp(seg)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bctsh,bcshp->bcthp", w, xdt)
    # each chunk's own end state, then the state carried into each chunk
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,Q,H)
    own = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, decay_to_end, xdt)
    state = torch.zeros(b, H, P, N, dtype=x.dtype, device=x.device)
    carried = []
    for c in range(nc):
        carried.append(state)
        state = state * torch.exp(cum[:, c, -1])[..., None, None] + own[:, c]
    carried = torch.stack(carried, 1)                         # (b,nc,H,P,N)
    y = y + torch.einsum("bctn,bchpn,bcth->bcthp", Cc, carried,
                         torch.exp(cum))
    return y.reshape(b, L, H, P)


def mamba(p, h, cfg, mm: Matmul):
    """The Mamba2 mixer: in_proj to [z, x, B, C, dt], a depthwise causal
    conv and SiLU on [x, B, C], the scan, the skip D x, the norm of
    y * silu(z), out_proj."""
    B_, L, _ = h.shape
    dssm = cfg["expand"] * cfg["d_model"]
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    H = dssm // P
    z, xbc, dt = torch.split(mm(h, f32(p["in_proj"])),
                             [dssm, dssm + 2 * N, H], -1)
    w = f32(p["conv_w"])
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + L] * w[i] for i in range(K))
                 + f32(p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [dssm, N, N], -1)
    dt = dt + f32(p["dt_bias"])
    dt = torch.logaddexp(dt, torch.zeros_like(dt))           # softplus
    A = -torch.exp(f32(p["A_log"]))
    xh = xs.reshape(B_, L, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + f32(p["D"])[:, None] * xh
    y = y.reshape(B_, L, dssm) * F.silu(z)
    return mm(rmsnorm(y, p["gate_norm"]["scale"], cfg["norm_eps"]),
              f32(p["out_proj"]))


def layer_at(tree, *idx):
    """The sub-tree of one layer: each stacked leaf indexed by idx."""
    if isinstance(tree, dict):
        return {k: layer_at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def embed(params, tokens, cfg, act_dtype):
    x = f32(params["embed"]["table"][tokens])
    if cfg["tie_embeddings"]:
        # the program multiplies by sqrt(d) as its activation dtype holds it
        x = x * float(torch.tensor(math.sqrt(cfg["d_model"])).to(act_dtype))
    return x


def head(params, x, cfg, mm: Matmul):
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    if cfg["tie_embeddings"]:
        return mm(x, f32(params["embed"]["table"]).T)
    return mm(x, f32(params["embed"]["unembed"]))


def blocks(params, cfg):
    """The model's layers in order, each a function x -> x (the residual
    added), as the family's module (`portbench/families/`) orders them."""
    from ..families import get
    return get(cfg["family"]).blocks(params, cfg)


def forward(params, tokens, cfg, act_dtype=torch.bfloat16,
            mm: Matmul = exact_matmul, last_only: bool = False,
            recompute: bool = False) -> torch.Tensor:
    """Logits (B, S, V) float32, or (B, V) at the last position with
    `last_only`.  `recompute` keeps only each layer's input for the
    backward (torch.utils.checkpoint), so that a long row's gradient
    fits the card."""
    x = embed(params, tokens, cfg, act_dtype)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in blocks(params, cfg):
        if recompute and torch.is_grad_enabled():
            x = checkpoint(blk, x, pos, mm, use_reentrant=False)
        else:
            x = blk(x, pos, mm)
    return head(params, x[:, -1] if last_only else x, cfg, mm)


def loss(params, tokens, labels, cfg, z_loss_weight: float,
         act_dtype=torch.bfloat16, mm: Matmul = exact_matmul,
         recompute: bool = True) -> torch.Tensor:
    """Mean cross entropy over the tokens plus z_loss_weight times the
    mean squared log-normaliser."""
    logits = forward(params, tokens, cfg, act_dtype, mm, recompute=recompute)
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean() + z_loss_weight * (lse * lse).mean()


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head_keys, last = path.split("/")
        for k in head_keys:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def grads(flat32: Dict[str, torch.Tensor], tokens, labels, cfg,
          z_loss_weight: float, act_dtype=torch.bfloat16,
          mm: Matmul = exact_matmul, rows_per_block: int = 1):
    """(loss, {path: gradient}) of `loss` over the batch at float32
    weights, computed a block of rows at a time and summed, each block's
    loss weighted by its share of the rows."""
    params = {k: v.detach().requires_grad_() for k, v in flat32.items()}
    tree = unflatten(params)
    B = tokens.shape[0]
    total = torch.zeros((), device=tokens.device)
    for r in range(0, B, rows_per_block):
        sl = slice(r, r + rows_per_block)
        part = loss(tree, tokens[sl], labels[sl], cfg, z_loss_weight,
                    act_dtype, mm) * (tokens[sl].shape[0] / B)
        part.backward()
        total = total + part.detach()
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in params.items()}
