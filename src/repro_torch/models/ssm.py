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

On a mesh the mixer computes whole width on every rank of 'model': its
`in_proj` and `out_proj` are gathered whole (`sharding.compute_spec`
keeps no 'model' shard of them; GSPMD splits the fused [z, x, B, C, dt]
output across 'model', which the port does not), and a serving step
hands it its slots' conv window and state gathered whole, writing the
rank's shard back after (`runtime/serve.py`).
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


def mamba_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "auto") -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, L, d) -> (B, L, d)."""
    B_, L, _ = x.shape
    dssm, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(cfg, x @ params["in_proj"])
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bv, Cv = torch.split(xBC, [dssm, N, N], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B_, L, H, P)
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
    y = y + params["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(B_, L, dssm)
    y = rmsnorm(params["gate_norm"],
                y * F.silu(z.float()).to(y.dtype), cfg.norm_eps, impl)
    return y @ params["out_proj"]


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
    gated norm's route."""
    B_ = x.shape[0]
    dssm, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(cfg, x @ params["in_proj"])
    window = torch.cat([cache["conv"], xBC], dim=1)          # (B, K, C)
    conv = (window * params["conv_w"]).sum(dim=1) + params["conv_b"]
    xBC = F.silu(conv.float()).to(x.dtype)
    xs, Bv, Cv = torch.split(xBC, [dssm, N, N], dim=-1)
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dtv * A)                                   # (B, H)
    xh = xs.reshape(B_, H, P).float()
    st = cache["state"].float() * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, Bv.float())
    y = torch.einsum("bhpn,bn->bhp", st, Cv.float())
    y = y + params["D"][:, None] * xh
    y = y.reshape(B_, 1, dssm).to(x.dtype)
    y = rmsnorm(params["gate_norm"],
                y * F.silu(z.float()).to(y.dtype), cfg.norm_eps, impl)
    out = y @ params["out_proj"]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(st)
    return out, cache
