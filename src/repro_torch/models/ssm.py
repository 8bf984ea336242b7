"""Mamba2 (SSD, state-space duality) block, chunked-scan formulation.

A port of the reference's `repro.models.ssm` (Dao & Gu,
arXiv:2405.21060): the sequence is split into chunks; within a chunk the
recurrence is a masked quadratic product, across chunks a linear
recurrence carries the (H, P, N) state.  Single B/C group.

`impl` picks the scan: "auto" and "kernel" go through the SSD kernel
wrapper (`kernels/ssd/ops.py`: the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor), where the reference's "pallas" goes;
"naive" and "chunked" run `ssd_scan`, with the reference's padding rule
and bf16 rounding points.  The gated norm goes through
`layers.rmsnorm(..., impl)`, so on the card it is the RMSNorm kernel.
Every other cast sits where the reference puts it.

On a mesh the mixer computes tensor-parallel over 'model' where the
rules shard its projections (`sharding.compute_spec`), as the
reference's compiled (2, 4) program does: `in_proj` column-parallel and
its fused [z, x, B, C, dt] output gathered over 'model'
(`parallel.gather_model`; GSPMD moves only the pieces each rank needs,
by collective-permutes); where 'model' splits `out_proj`'s rows on
whole heads, each rank then runs its heads of z, x and dt with B and C
whole (GSPMD splits B and C on the state dimension and sums the scores
over 'model' instead: the port keeps each head's scan in one SSD kernel
call), gathers the gated output whole over 'model' for the gated norm
(GSPMD sums the norm's squares over 'model' instead: the port keeps the
norm in one RMSNorm kernel call), and multiplies its rows of
`out_proj`, summed by `psum_model`.  Where 'model' does not
divide a projection (mamba2-130m's `in_proj`, 3352 columns on 16
ranks) the rules keep it whole, and where its rows split heads
(mamba2-130m's 1536 rows: 96 a rank, heads of 64) the conv, the scan and
the norm run whole on every rank and `out_proj` row-parallel on the
rank's columns of y.  A serving step hands
`decode_mamba` the rank's slots of the conv window, whole width, and
its shard of the state where the rules put 'model' on its heads or its
head dim: the step updates that shard alone and gathers its part of y
(`runtime/serve.py: cache_views`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd.ops import ssd
from .layers import KERNEL_IMPLS, _dense_init, rmsnorm, rmsnorm_init

Params = Dict[str, torch.Tensor]


def mamba_init(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Params:
    d, dssm, H, N = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    conv_dim = dssm + 2 * N
    return {   # in_proj emits [z, x, B, C, dt]
        "in_proj": _dense_init(gen, (d, 2 * dssm + 2 * N + H),
                               device=device),
        "conv_w": _dense_init(gen, (cfg.d_conv, conv_dim), 0, device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.bfloat16,
                              device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "gate_norm": rmsnorm_init(dssm, device),
        "out_proj": _dense_init(gen, (dssm, d), device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """[z, xBC, dt] at [dssm, 2 dssm + 2N] (views, no copy)."""
    dssm, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [dssm, dssm + 2 * N, H], dim=-1)


def _in_proj(params: Params, x: torch.Tensor, cfg: ModelConfig):
    """[z, xBC, dt] of x: column-parallel where the rank holds a 'model'
    shard of `in_proj`'s columns, the fused output then gathered whole
    over 'model'."""
    from ..runtime.parallel import gather_model, model_slice
    w = params["in_proj"]
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads
    zxbcdt = x @ w
    if model_slice("in_proj", w.shape, width) is not None:
        zxbcdt = gather_model(zxbcdt, -1)
    return _split_proj(cfg, zxbcdt)


def _out_proj(params: Params, y: torch.Tensor, cfg: ModelConfig):
    """y @ out_proj, row-parallel on the rank's columns of y (its rows of
    `out_proj`) summed over 'model' where the rank holds a shard."""
    from ..runtime.parallel import model_slice, psum_model
    w = params["out_proj"]
    rows = model_slice("out_proj", w.shape, cfg.d_inner)
    if rows is None:
        return y @ w
    return psum_model(y[..., rows] @ w)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0); F.softplus turns into the
    identity above 20 and would differ there."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xBC: (B, L, C); w: (K, C).  The K shifted
    products are added one by one in the input dtype, as the reference's
    Python `sum` does (F.conv1d rounds differently, and on the card a
    float32 convolution runs in TF32 by default)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu((out + b).float()).to(xBC.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} x[..., k], and
    -inf above the diagonal (masked before any exp)."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    seg = c[..., :, None] - c[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan.

    x: (b, L, H, P); dt: (b, L, H) (post-softplus); A: (H,) negative;
    B, C: (b, L, N) single group.  L must be a multiple of min(chunk, L).
    Returns (y (b, L, H, P), final state (b, H, P, N)), both in x's dtype.
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of {Q}")
    nc = L // Q
    dtype = x.dtype

    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)
    dA = dtc * A                                              # (b, nc, Q, H)
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))         # (b,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)          # (b,nc,Q,Q)
    gate = (scores[:, :, None] * Lmat).to(dtype)              # (b,nc,H,Q,Q)
    xdt = (xc.float() * dtc[..., None]).to(dtype)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gate, xdt)

    # chunk states
    decay_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc,
                          decay_end.to(dtype) * dtc.to(dtype), xc)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b, nc, H)
    carry = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,H,P,N)

    # inter-chunk output
    state_decay = torch.exp(dA_cum)                           # (b,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc,
                         prev_states.to(dtype), state_decay.to(dtype))
    y = (y_diag + y_off).reshape(b, L, H, P)
    return y, carry.to(dtype)


def _mixer_heads(params: Params, cfg: ModelConfig) -> slice:
    """The heads this rank's mixer runs: those of its rows of `out_proj`
    where the rules split them over 'model' on whole heads (as GSPMD
    splits z, x and dt by heads after the projection), else all."""
    from ..runtime.parallel import model_slice
    P = cfg.ssm_head_dim
    rows = model_slice("out_proj", params["out_proj"].shape, cfg.d_inner)
    if rows is None or rows.start % P or (rows.stop - rows.start) % P:
        return slice(0, cfg.n_ssm_heads)
    return slice(rows.start // P, rows.stop // P)


def mamba_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "auto") -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, L, d) -> (B, L, d).

    On a mesh whose 'model' splits `out_proj`'s rows on whole heads the
    block runs this rank's heads (`_mixer_heads`): their columns of z, x
    and dt, whole B and C, the conv on their channels and B's and C's,
    and the scan; the gated output is gathered whole over 'model' for
    the gated norm, and its rows of `out_proj` are summed over 'model'."""
    from ..runtime.parallel import gather_model
    B_, L, _ = x.shape
    dssm, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _in_proj(params, x, cfg)
    hs = _mixer_heads(params, cfg)
    Hl = hs.stop - hs.start
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    if Hl < H:
        cols = slice(hs.start * P, hs.stop * P)
        xBC = torch.cat([xBC[..., cols], xBC[..., dssm:]], dim=-1)
        conv_w = torch.cat([conv_w[:, cols], conv_w[:, dssm:]], dim=-1)
        conv_b = torch.cat([conv_b[cols], conv_b[dssm:]], dim=-1)
        z, dt = z[..., cols], dt[..., hs]
    xBC = _causal_conv(xBC, conv_w, conv_b)
    xs, Bv, Cv = torch.split(xBC, [Hl * P, N, N], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"][hs])
    A = -torch.exp(params["A_log"][hs])
    xh = xs.reshape(B_, L, Hl, P)
    if impl in KERNEL_IMPLS:
        y, _ = ssd(xh, dt, A, Bv, Cv, chunk=cfg.ssm_chunk)
    else:
        # pad L to a chunk multiple for the scan
        Q = min(cfg.ssm_chunk, max(16, L))
        pad = (-L) % Q
        xp, dtp, Bp, Cp = xh, dt, Bv, Cv
        if pad:
            xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            Bp = F.pad(Bv, (0, 0, 0, pad))
            Cp = F.pad(Cv, (0, 0, 0, pad))
        y, _ = ssd_scan(xp, dtp, A, Bp, Cp, Q)
        y = y[:, :L]
    y = y + params["D"][hs].to(y.dtype)[:, None] * xh
    y = y.reshape(B_, L, Hl * P)
    v = y * F.silu(z.float()).to(y.dtype)
    if Hl < H:
        v = gather_model(v, -1)
    y = rmsnorm(params["gate_norm"], v, cfg.norm_eps, impl)
    return _out_proj(params, y, cfg)


# --------------------------------------------------------------------------
# decode: O(1) recurrent state per block
# --------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """Conv window and SSM state, both bf16 whatever the params' dtype."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.bfloat16,
                             device=device),
    }


def decode_mamba(params: Params, x: torch.Tensor, cache: Dict,
                 cfg: ModelConfig, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. x: (B, 1, d).

    Unlike the reference, which returns a new cache, the conv window and
    the state are written into `cache` in place (in bf16, as the
    reference stores them); the same dict is returned.  `impl` picks the
    gated norm's route.

    The state may be this rank's 'model' shard of its heads or its head
    dim (`parallel.cache_model_part`): the step updates that shard and
    gathers its part of y whole over 'model'."""
    from ..runtime.parallel import cache_model_part, gather_model
    B_ = x.shape[0]
    dssm, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _in_proj(params, x, cfg)
    window = torch.cat([cache["conv"], xBC], dim=1)          # (B, K, C)
    conv = (window * params["conv_w"]).sum(dim=1) + params["conv_b"]
    xBC = F.silu(conv.float()).to(x.dtype)
    xs, Bv, Cv = torch.split(xBC, [dssm, N, N], dim=-1)
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dtv * A)                                   # (B, H)
    _, hs, ps, _ = (s or slice(None) for s in cache_model_part(
        cache["state"].shape, (B_, H, P, N)))
    xh = xs.reshape(B_, H, P).float()[:, hs, ps]
    st = cache["state"].float() * dA[:, hs, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv[:, hs], xh, Bv.float())
    y = torch.einsum("bhpn,bn->bhp", st, Cv.float())
    y = y + params["D"][hs, None] * xh
    for dim, part in ((1, hs), (2, ps)):
        if part != slice(None):
            y = gather_model(y, dim)
    y = y.reshape(B_, 1, dssm).to(x.dtype)
    y = rmsnorm(params["gate_norm"],
                y * F.silu(z.float()).to(y.dtype), cfg.norm_eps, impl)
    out = _out_proj(params, y, cfg)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(st)
    return out, cache
