"""RMSNorm wrapper: the CUDA kernels for CUDA tensors, the plain version
for CPU tensors.

Replaces `src/repro/kernels/rmsnorm/ops.py: rmsnorm` (Pallas, TPU).  The
kernel source is `kernels/csrc/rmsnorm.cu`; its note says what bounds it
on an H100.  Unlike the TPU wrapper, rows are not padded: the kernel
handles any row count.

On a CUDA tensor the forward kernel runs inside a `torch.autograd.Function`
whose backward launches the backward kernel (`rmsnorm_bwd`: dx and
dscale, r recomputed from x); `rmsnorm.bwd_launches` counts it.  On a
CPU tensor autograd differentiates `rmsnorm_ref`; `rmsnorm_bwd_ref` is
the backward written out, which the card's kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: blocks of the backward's first kernel per SM (each writes one fp32
#: row of dscale partial sums)
BWD_BLOCKS_PER_SM = 2


@functools.cache
def _bind():
    lib = _build.load("rmsnorm")
    fwd = lib.rmsnorm_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    bwd = lib.rmsnorm_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_void_p] * 6
                    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib, fwd, bwd


@functools.cache
def _max_parts(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return BWD_BLOCKS_PER_SM * sms


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; the kernel needs one CUDA device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for d={d}")
    return d


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """(rows, d) view of t with unit column stride (copied if needed)."""
    t2 = t.reshape(-1, d)
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _fwd(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    d = _check(x, scale)
    x2 = _rows(x, d)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    lib, fn, _ = _bind()
    code = fn(x2.data_ptr(), scale.data_ptr(), out.data_ptr(), x2.shape[0],
              d, x2.stride(0), eps, _DTYPES[x.dtype], _DTYPES[scale.dtype],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm", code)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6):
    """(dx, dscale) of the norm at x for the output gradient g, by the
    backward kernel (CUDA tensors only); dx in x's dtype, dscale in the
    scale's dtype, as `rmsnorm_bwd_ref` computes them."""
    d = _check(x, scale)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} {g.dtype} for "
                         f"x {tuple(x.shape)} {x.dtype}")
    x2, g2 = _rows(x, d), _rows(g, d)
    rows = x2.shape[0]
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    max_parts = _max_parts(x.device.index
                           if x.device.index is not None
                           else torch.cuda.current_device())
    part = torch.empty((max_parts, d), dtype=torch.float32, device=x.device)
    lib, _, fn = _bind()
    code = fn(x2.data_ptr(), g2.data_ptr(), scale.data_ptr(), dx.data_ptr(),
              dscale.data_ptr(), part.data_ptr(), max_parts, rows, d,
              x2.stride(0), g2.stride(0), eps, _DTYPES[x.dtype],
              _DTYPES[scale.dtype],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm_bwd", code)
    rmsnorm.bwd_launches += 1
    return dx.reshape(x.shape), dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, g, scale, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Same dtype out as in.

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (float32 or bfloat16, any row count)
    or raises, and its gradient launches the backward kernel.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    return _RMSNorm.apply(x, scale, eps)


#: forward kernel launches since the last reset (plain-version calls not
#: counted; under remat a recomputed forward counts again)
rmsnorm.launches = 0
#: backward kernel launches (`rmsnorm_bwd`) since the last reset
rmsnorm.bwd_launches = 0
