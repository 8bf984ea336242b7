"""Mamba2 (SSD, state-space duality) block, chunked-scan formulation.

A port of the reference's `repro.models.ssm` (Dao & Gu,
arXiv:2405.21060): the sequence is split into chunks; within a chunk the
recurrence is a masked quadratic product, across chunks a linear
recurrence carries the (H, P, N) state.  Single B/C group.

`impl` picks the scan: "auto" and "kernel" go through the SSD kernel
wrapper (`kernels/ssd/ops.py`: the CUDA kernel on a CUDA tensor, its
gradient the SSD backward kernel, its plain version on a CPU tensor),
where the reference's "pallas" goes;
"naive" and "chunked" run `ssd_scan`, with the reference's padding rule
and bf16 rounding points.  The gated norm, the norm of
y * silu(z), goes through `kernels/rmsnorm/ops.py: rmsnorm_gated` on the
kernel routes, so on the card one RMSNorm kernel forms the gate in
registers, and through its plain version (the reference's ops) on the
plain routes.  Every other cast sits where the reference puts it.

On a mesh the mixer computes tensor-parallel over 'model' where the
rules shard its projections (`sharding.compute_spec`), as the
reference's compiled (2, 4) program does: `in_proj` column-parallel,
and where 'model' splits `out_proj`'s rows on whole heads each rank
runs its heads.  It receives just their columns of z, x and dt, and B
and C whole, from the ranks that computed them, by one all-to-all over
'model' (`parallel.move_model_columns`; GSPMD moves the same head
columns by collective-permutes and all-to-alls, and splits B and C on
the state dimension, summing the scores over 'model': the port keeps B
and C whole, so that each head's scan stays one SSD kernel call).  The
gated norm runs on the rank's columns with the rows' squares summed
over 'model' (`kernels/rmsnorm/ops.py: rmsnorm_split` on the kernel
routes, as GSPMD all-reduces them; its backward sums the rows' dots the
same way), and `out_proj` multiplies the
normed columns by the rank's rows, summed by `psum_model`.  Where the
heads do not split (mamba2-130m's 24 heads on 16 ranks: its 1536 rows
split 96 a rank, heads of 64) the fused output is gathered whole (or,
where 'model' does not divide `in_proj`, as mamba2-130m's 3352
columns on 16 ranks, held whole), the conv, the scan and the norm run
whole on every rank, and `out_proj` row-parallel on the rank's columns
of y.  A serving step hands `decode_mamba` the rank's slots of the
conv window, whole width, and its shard of the state where the rules
put 'model' on its heads or its head dim (`runtime/serve.py:
cache_views`): the step updates that shard alone.

Context parallelism (a train batch split on its sequence over the data
axes): each rank runs its part of the sequence, its conv fed the
previous rank's last rows, its scan's carried state made from the
earlier ranks' final states, gathered over those axes (`mamba_block`);
the split over 'model' above is independent of it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rmsnorm.ops import rmsnorm_gated, rmsnorm_split
from ..kernels.rmsnorm.ref import rmsnorm_gated_ref, rmsnorm_split_ref
from ..kernels.ssd.ops import ssd
from .layers import KERNEL_IMPLS, _dense_init, rmsnorm_init

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


def _fused_wants(cfg: ModelConfig, heads: slice):
    """The (start, stop) ranges of the fused [z, x, B, C, dt] output that
    a rank running `heads` needs: its heads' columns of z and x, B and C
    whole, its heads' dt."""
    dssm, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h0, h1 = heads.start, heads.stop
    return ((h0 * P, h1 * P), (dssm + h0 * P, dssm + h1 * P),
            (2 * dssm, 2 * dssm + 2 * N),
            (2 * dssm + 2 * N + h0, 2 * dssm + 2 * N + h1))


def _in_proj(params: Params, x: torch.Tensor, cfg: ModelConfig,
             heads: Optional[slice] = None):
    """[z, xBC, dt] of x.  With `heads` (the rank's, where 'model' splits
    them), z, x and dt at those heads' columns and B and C whole, else
    all of each.

    Where the rank holds a 'model' shard of `in_proj`'s columns the
    product is column-parallel; with `heads` each rank then receives
    just the columns it needs from the ranks that computed them
    (`parallel.move_model_columns`: one all-to-all over 'model', as
    GSPMD reshards the reference's product by collective-permutes and
    all-to-alls), without them the fused output is gathered whole over
    'model'.  A whole `in_proj` gives the rank's columns by slicing."""
    from ..runtime.parallel import (gather_model, model_slice,
                                    move_model_columns)
    dssm, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    w = params["in_proj"]
    width = 2 * dssm + 2 * N + cfg.n_ssm_heads
    zxbcdt = x @ w
    split = model_slice("in_proj", w.shape, width) is not None
    if heads is None:
        if split:
            zxbcdt = gather_model(zxbcdt, -1)
        return _split_proj(cfg, zxbcdt)
    Hl = heads.stop - heads.start
    if not split:
        z, xBC, dt = _split_proj(cfg, zxbcdt)
        cols = slice(heads.start * P, heads.stop * P)
        return (z[..., cols],
                torch.cat([xBC[..., cols], xBC[..., dssm:]], dim=-1),
                dt[..., heads])
    n = dssm // (Hl * P)
    wants = tuple(_fused_wants(cfg, slice(r * Hl, (r + 1) * Hl))
                  for r in range(n))
    mine = move_model_columns(zxbcdt, width, wants)
    return torch.split(mine, [Hl * P, Hl * P + 2 * N, Hl], dim=-1)


def _out_proj(params: Params, y: torch.Tensor, cfg: ModelConfig,
              at_rows: bool = False):
    """y @ out_proj, row-parallel where the rank holds a shard of
    `out_proj`'s rows: on the rank's columns of y, summed over 'model'.
    `at_rows`: y holds just those columns already (the mixer ran the
    rank's heads); else y is whole and is sliced to them."""
    from ..runtime.parallel import model_slice, psum_model
    w = params["out_proj"]
    rows = model_slice("out_proj", w.shape, cfg.d_inner)
    if rows is None:
        return y @ w
    return psum_model((y if at_rows else y[..., rows]) @ w)


def _gated_norm(params: Params, y: torch.Tensor, z: torch.Tensor,
                cfg: ModelConfig, impl: str,
                cols: Optional[slice]) -> torch.Tensor:
    """The gated norm, the norm of v = y * silu(z) (the gate's rounding
    points the reference's: `kernels/rmsnorm/ref.py: gate_ref`).  On the
    kernel routes the gate is folded into the norm's kernels
    (`rmsnorm_gated`, `rmsnorm_split(..., gate=z)`), on the plain ones
    their plain versions run the reference's ops.  With `cols` y and z
    hold the rank's columns of each row (its heads): the norm of the
    split row, its sum of squares added over 'model', as the reference's
    program all-reduces it; else the whole-row norm.  The sum is bound to
    this call's mesh: the kernels' backward sums again, in the backward
    pass, where no mesh is installed."""
    kernel = impl in KERNEL_IMPLS
    scale = params["gate_norm"]["scale"]
    if cols is None:
        norm = rmsnorm_gated if kernel else rmsnorm_gated_ref
        return norm(y, z, scale, cfg.norm_eps)
    from ..launch.mesh import get_abstract_mesh
    from ..runtime.parallel import psum
    norm = rmsnorm_split if kernel else rmsnorm_split_ref
    sum_rows = functools.partial(psum, mesh=get_abstract_mesh(),
                                 axes=("model",))
    return norm(y, scale[cols], cfg.d_inner, sum_rows, cfg.norm_eps,
                gate=z)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0); F.softplus turns into the
    identity above 20 and would differ there."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. xBC: (B, L, C); w: (K, C); prev: (B, K -
    1, C), the rows before xBC's first (under a sequence split, the
    previous rank's last), zeros when None.  The K shifted products are
    added one by one in the input dtype, as the reference's Python `sum`
    does (F.conv1d rounds differently, and on the card a float32
    convolution runs in TF32 by default)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0)) if prev is None else \
        torch.cat([prev, xBC], dim=1)
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
    states = _state_from_zero(Bc, dA_cum, dtc, xc)            # (b,nc,H,P,N)

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


def _state_from_zero(Bm, cum, dt, x) -> torch.Tensor:
    """The state a stretch of positions leaves from a zero start: the sum
    over its positions t of B_t exp(cum_end - cum_t) dt_t x_t, with the
    positions on the dim before the last of cum and dt (..., q, H), of
    Bm (..., q, N) and of x (..., q, H, P).  (..., H, P, N) in x's
    dtype."""
    dtype = x.dtype
    return torch.einsum("...qn,...qh,...qhp->...hpn", Bm,
                        torch.exp(cum[..., -1:, :] - cum).to(dtype)
                        * dt.to(dtype), x)


def _from_earlier_ranks(t: torch.Tensor, split):
    """(every rank's t along the split's axes, stacked (n, ...), this
    rank's index r there).  Every rank takes part and then uses the
    whole result, the ranks after r with weight zero, so that every
    rank's backward runs the gather's adjoint."""
    from ..launch.mesh import get_abstract_mesh
    from ..runtime.parallel import all_gather, axis_index
    mesh = get_abstract_mesh()
    return all_gather(t[None], mesh, split.axes), axis_index(mesh,
                                                             split.axes)


def _previous_rows(xBC: torch.Tensor, k: int, split) -> torch.Tensor:
    """The previous rank's last k rows of xBC along the split (zeros on
    the first rank): the rows the causal conv reads before this rank's
    first."""
    if xBC.shape[1] < k:
        raise ValueError(f"a sequence split of {xBC.shape[1]} positions a "
                         f"rank is shorter than the conv's {k} rows")
    tails, r = _from_earlier_ranks(xBC[:, xBC.shape[1] - k:], split)
    return tails[r - 1] * float(r > 0)


def _carried_state(xh, dt, A, Bv, Cv, split,
                   final: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The term of y that the state carried into this rank's part of the
    sequence adds: y is linear in the initial state, so the scan from a
    zero state plus this equals the scan of the whole sequence.  Each
    rank's final state from a zero start (B, H, P, N) and its part's
    total decay (B, H), both float32, are gathered over the split's
    axes; the rank's initial state is the sum of the earlier ranks'
    final states, each decayed over the parts between; its term at
    position t is C_t . (decay to t) * state.  `final` is the scan's own
    final state where the scan returns one (`ssd_scan`; the SSD
    kernel's wrapper, like the reference's, returns none, and then it
    is made here by the scan's chunk-state product over the whole part).
    The casts sit where `ssd_scan` puts its chunk states' and
    inter-chunk output's."""
    b, L, H, P = xh.shape
    N = Bv.shape[-1]
    dtype = xh.dtype
    cum = torch.cumsum(dt * A, dim=1)                        # (b, L, H)
    if final is None:
        final = _state_from_zero(Bv, cum, dt, xh)
    every, r = _from_earlier_ranks(
        torch.cat([final.float().reshape(b, -1), cum[:, -1]], dim=-1),
        split)
    finals = every[..., :H * P * N].reshape(-1, b, H, P, N)
    totals = every[..., H * P * N:]                          # (n, b, H)
    init = 0.0
    for j in range(every.shape[0]):
        w = torch.exp(totals[j + 1:r].sum(0)) if j < r else \
            torch.zeros_like(totals[j])
        init = init + w[..., None, None] * finals[j]
    return torch.einsum("bln,bhpn,blh->blhp", Cv, init.to(dtype),
                        torch.exp(cum).to(dtype))


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
    block runs this rank's heads (`_mixer_heads`): it receives their
    columns of z, x and dt and B and C whole (`_in_proj`), runs the conv
    on their channels and B's and C's and the scan, norms the gated
    output's rank's columns with their squares summed over 'model'
    (`_gated_norm`), and multiplies its rows of `out_proj`, summed over
    'model'.  Where the heads do not split (H not a multiple of 'model',
    or a head split by the rows), every rank runs all of them on the
    fused output gathered whole (or held whole).

    Under a sequence split over the data axes (`parallel.get_seq_split`)
    x is the rank's part of each row: the conv reads the previous rank's
    last `d_conv - 1` rows (`_previous_rows`), and the scan runs from a
    zero state, to which the state carried from the earlier ranks adds
    its term (`_carried_state`, from the scan's final state where the
    route returns one)."""
    from ..runtime.parallel import get_seq_split
    B_, L, _ = x.shape
    dssm, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    hs = _mixer_heads(params, cfg)
    Hl = hs.stop - hs.start
    cols = slice(hs.start * P, hs.stop * P) if Hl < H else None
    split = get_seq_split()
    if split is not None and not split.axes:
        split = None                    # the whole sequence: nothing carried
    z, xBC, dt = _in_proj(params, x, cfg, None if cols is None else hs)
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    if cols is not None:
        conv_w = torch.cat([conv_w[:, cols], conv_w[:, dssm:]], dim=-1)
        conv_b = torch.cat([conv_b[cols], conv_b[dssm:]], dim=-1)
    xBC = _causal_conv(xBC, conv_w, conv_b, None if split is None else
                       _previous_rows(xBC, cfg.d_conv - 1, split))
    xs, Bv, Cv = torch.split(xBC, [Hl * P, N, N], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"][hs])
    A = -torch.exp(params["A_log"][hs])
    xh = xs.reshape(B_, L, Hl, P)
    if impl in KERNEL_IMPLS:
        y, final = ssd(xh, dt, A, Bv, Cv, chunk=cfg.ssm_chunk)
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
        # the padding's dt is 0: it leaves the final state as it was
        y, final = ssd_scan(xp, dtp, A, Bp, Cp, Q)
        y = y[:, :L]
    if split is not None:
        y = y + _carried_state(xh, dt, A, Bv, Cv, split, final)
    y = y + params["D"][hs].to(y.dtype)[:, None] * xh
    y = y.reshape(B_, L, Hl * P)
    return _out_proj(params, _gated_norm(params, y, z, cfg, impl, cols), cfg,
                     at_rows=cols is not None)


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
    gathers its part of y whole over 'model'.  Decode gathers the fused
    output whole too, and norms the whole row: the rules put 'model' on
    the state's head dim in every registered configuration (zamba2's and
    mamba2's heads of 64, 16 reduced, on 'model' of 2-16), so no decode
    step holds just the heads the mixer would split."""
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
    out = _out_proj(params, _gated_norm(params, y, z, cfg, impl, None), cfg)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(st)
    return out, cache
