"""Plain PyTorch versions of the fused RMSNorm kernels."""

from typing import Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
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
