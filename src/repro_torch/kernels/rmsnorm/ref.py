"""Plain PyTorch versions of the fused RMSNorm kernels."""

from typing import Callable, Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_split_ref(x: torch.Tensor, scale: torch.Tensor, d_total: int,
                      sum_rows: Callable[[torch.Tensor], torch.Tensor],
                      eps: float = 1e-6) -> torch.Tensor:
    """The norm of rows split by columns over ranks: x holds this rank's
    columns of each row, scale its slice of the weight, d_total the
    row's whole width; `sum_rows` sums the (rows,) fp32 vector of local
    sums of squares over the ranks that hold the rest of each row.  Equal
    to `rmsnorm_ref` of the whole row, cut to the rank's columns, up to
    the order of the sum."""
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
    r = torch.rsqrt(ss.reshape(x.shape[:-1] + (1,)) / d_total + eps)
    gs = gf * scale.float()
    dot = sum_rows(torch.sum(gs * xf, dim=-1).reshape(-1))
    dot = dot.reshape(x.shape[:-1] + (1,))
    dx = r * gs - xf * (r * r * r * dot / d_total)
    dscale = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
