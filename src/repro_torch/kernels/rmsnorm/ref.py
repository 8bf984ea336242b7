"""Plain PyTorch versions of the fused RMSNorm kernels."""

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gate_ref(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The Mamba2 mixer's gated output v = y * silu(z), as the reference
    writes it (`repro/models/ssm.py:156-157`): silu in fp32, rounded to
    y's dtype, the product rounded to y's dtype."""
    return y * F.silu(z.float()).to(y.dtype)


def rmsnorm_gated_ref(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """The gated norm, `rmsnorm_ref(gate_ref(y, z))`: the same torch ops
    the mixer ran before the gate was folded into the kernel."""
    return rmsnorm_ref(gate_ref(y, z), scale, eps)


def rmsnorm_split_ref(x: torch.Tensor, scale: torch.Tensor, d_total: int,
                      sum_rows: Callable[[torch.Tensor], torch.Tensor],
                      eps: float = 1e-6,
                      gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The norm of rows split by columns over ranks: x holds this rank's
    columns of each row, scale its slice of the weight, d_total the
    row's whole width; `sum_rows` sums the (rows,) fp32 vector of local
    sums of squares over the ranks that hold the rest of each row.  Equal
    to `rmsnorm_ref` of the whole row, cut to the rank's columns, up to
    the order of the sum.  With `gate` (z, this rank's columns), the norm
    of `gate_ref(x, z)`."""
    if gate is not None:
        x = gate_ref(x, gate)
    xf = x.float()
    ss = sum_rows(torch.sum(xf * xf, dim=-1).reshape(-1))
    var = ss.reshape(x.shape[:-1] + (1,)) / d_total
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `rmsnorm_ref` for the output gradient g, written out:
    with r = rsqrt(mean(x^2) + eps) per row and gs = g * scale, in fp32,
    dx = r * (gs - x * r^2 * mean(gs * x)) in x's dtype and
    dscale = sum over rows of g * (x * r) in the scale's dtype."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.float()
    mean_gsx = torch.mean(gs * xf, dim=-1, keepdim=True)
    dx = r * gs - xf * (r * r * r * mean_gsx)
    dscale = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _gate_parts(y: torch.Tensor, z: torch.Tensor):
    """(v, s, y * sig(z) * (1 + z * (1 - sig(z)))) in fp32: s = silu(z)
    and v = y * s, each rounded to y's dtype as the forward rounds them;
    the last is d silu(z) / dz times y."""
    yf, zf = y.float(), z.float()
    s = F.silu(zf).to(y.dtype).float()
    sig = torch.sigmoid(zf)
    return (yf * s).to(y.dtype).float(), s, yf * (sig * (1 + zf * (1 - sig)))


def _through_gate(dv: torch.Tensor, s: torch.Tensor, yd: torch.Tensor,
                  dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dz) from the fp32 gradient dv of v = y * s: dv * s and
    dv * y * silu'(z), each rounded once to y's dtype."""
    return (dv * s).to(dtype), (dv * yd).to(dtype)


def rmsnorm_gated_bwd_ref(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                          scale: torch.Tensor, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Gradients (dy, dz, dscale) of `rmsnorm_gated_ref` for the output
    gradient g, written out: v and s = silu(z) as the forward rounds them,
    r = rsqrt(mean(v^2) + eps) and gs = g * scale in fp32,
    dv = r * gs - v * r^3 * mean(gs * v), never rounded, then
    dy = dv * s and dz = dv * y * sig(z) * (1 + z * (1 - sig(z))) in y's
    dtype and dscale = sum over rows of g * (v * r) in the scale's dtype.
    Autograd through the plain ops rounds dv and each product to y's
    dtype: in bf16 the two land up to a few output ulps apart."""
    v, s, yd = _gate_parts(y, z)
    gf = g.float()
    r = torch.rsqrt(torch.mean(v * v, dim=-1, keepdim=True) + eps)
    gs = gf * scale.float()
    mean_gsv = torch.mean(gs * v, dim=-1, keepdim=True)
    dv = r * gs - v * (r * r * r * mean_gsv)
    dscale = (gf * (v * r)).reshape(-1, y.shape[-1]).sum(0)
    return (*_through_gate(dv, s, yd, y.dtype), dscale.to(scale.dtype))


def _split_dv(xf, gf, scale, ss, d_total, sum_rows, eps):
    """fp32 (dx, r) of the split row's norm at xf for gf (the forward's
    summed squares ss, `sum_rows` summing the rows' local dots)."""
    r = torch.rsqrt(ss.reshape(xf.shape[:-1] + (1,)) / d_total + eps)
    gs = gf * scale.float()
    dot = sum_rows(torch.sum(gs * xf, dim=-1).reshape(-1))
    dot = dot.reshape(xf.shape[:-1] + (1,))
    return r * gs - xf * (r * r * r * dot / d_total), r


def rmsnorm_split_bwd_ref(x: torch.Tensor, g: torch.Tensor,
                          scale: torch.Tensor, ss: torch.Tensor, d_total: int,
                          sum_rows: Callable[[torch.Tensor], torch.Tensor],
                          eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `rmsnorm_split_ref` for the output gradient g, written
    out: x, g this rank's columns, scale its slice, ss the (rows,) fp32
    squares summed over the ranks (the forward's), `sum_rows` the same sum
    over the ranks.  With r = rsqrt(ss / d_total + eps) and gs = g * scale,
    in fp32, dx = r * gs - x * r^3 / d_total * sum_rows(sum_local gs * x)
    in x's dtype and dscale = sum over rows of g * x * r in the scale's
    dtype (this rank's entries)."""
    xf, gf = x.float(), g.float()
    dx, r = _split_dv(xf, gf, scale, ss, d_total, sum_rows, eps)
    dscale = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_split_gated_bwd_ref(y: torch.Tensor, z: torch.Tensor,
                                g: torch.Tensor, scale: torch.Tensor,
                                ss: torch.Tensor, d_total: int,
                                sum_rows: Callable[[torch.Tensor],
                                                   torch.Tensor],
                                eps: float = 1e-6
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Gradients (dy, dz, dscale) of `rmsnorm_split_ref(..., gate=z)`,
    written out: `rmsnorm_split_bwd_ref`'s dx at v, kept in fp32 as dv,
    carried through the gate as `rmsnorm_gated_bwd_ref` carries it; ss the
    forward's summed squares of v."""
    v, s, yd = _gate_parts(y, z)
    gf = g.float()
    dv, r = _split_dv(v, gf, scale, ss, d_total, sum_rows, eps)
    dscale = (gf * (v * r)).reshape(-1, y.shape[-1]).sum(0)
    return (*_through_gate(dv, s, yd, y.dtype), dscale.to(scale.dtype))
