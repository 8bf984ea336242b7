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

`rmsnorm_split` is the norm of a row split by columns over ranks (the
Mamba2 mixer's gated norm where 'model' splits its heads): one kernel
writes each row's fp32 sum of squares over the local columns, the
caller's `sum_rows` adds them over the ranks (an all-reduce of one
float a row), and a second kernel scales the rank's columns.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from .. import _build, reject_dtensor
from .ref import rmsnorm_ref, rmsnorm_split_ref

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
def _bind_split():
    lib = _build.load("rmsnorm")
    sumsq = lib.rmsnorm_sumsq
    sumsq.restype = ctypes.c_int
    sumsq.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p]
    apply = lib.rmsnorm_apply
    apply.restype = ctypes.c_int
    apply.argtypes = ([ctypes.c_void_p] * 4
                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p])
    return lib, sumsq, apply


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
    reject_dtensor("rmsnorm", x, scale)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    return _RMSNorm.apply(x, scale, eps)


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, d_total: int,
                  sum_rows: Callable[[torch.Tensor], torch.Tensor],
                  eps: float = 1e-6) -> torch.Tensor:
    """The norm of rows `d_total` wide split by columns over ranks.  x:
    (..., d), this rank's d columns of each row; scale: (d,), its slice
    of the weight; `sum_rows` sums a (rows,) fp32 vector over the ranks
    that hold the rest of each row (`parallel.psum` over 'model').  Same
    dtype out as in.

    A CPU tensor takes `rmsnorm_split_ref` (autograd runs through
    `sum_rows`, whose adjoint, a psum's, is the same sum).  A CUDA
    tensor launches the sum-of-squares kernel, sums, then launches the
    scaling kernel (counted together as one `rmsnorm.launches`, as the
    whole-row norm they stand for, and in `rmsnorm.split_launches`), or
    raises.  The pair has no backward, so a CUDA input that needs a
    gradient raises: its only caller on the card is the split-heads
    Mamba2 mixer, which cannot train there before the SSD kernel has a
    backward.
    """
    reject_dtensor("rmsnorm_split", x, scale)
    if x.device.type == "cpu":
        return rmsnorm_split_ref(x, scale, d_total, sum_rows, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_split: no kernel for {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError(
            "the split-row rmsnorm kernels have no backward; their only "
            "caller on the card, the split-heads Mamba2 mixer, cannot train "
            "there before the ssd kernel has one (ROADMAP.md, Queue 2)")
    d = _check(x, scale)
    if d_total < d:
        raise ValueError(f"rmsnorm_split: {d} local columns of rows "
                         f"{d_total} wide")
    x2 = _rows(x, d)
    rows = x2.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib, sumsq, apply = _bind_split()
    ss = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _build.check(lib, "rmsnorm_sumsq", sumsq(
        x2.data_ptr(), ss.data_ptr(), rows, d, x2.stride(0),
        _DTYPES[x.dtype], stream))
    ss = sum_rows(ss)
    if ss.shape != (rows,) or ss.dtype != torch.float32 or \
            ss.device != x.device:
        raise ValueError(f"rmsnorm_split: sum_rows gave {tuple(ss.shape)} "
                         f"{ss.dtype} on {ss.device} for {rows} rows")
    ss = ss.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    _build.check(lib, "rmsnorm_apply", apply(
        x2.data_ptr(), scale.data_ptr(), ss.data_ptr(), out.data_ptr(), rows,
        d, x2.stride(0), d_total, eps, _DTYPES[x.dtype],
        _DTYPES[scale.dtype], stream))
    rmsnorm.launches += 1
    rmsnorm.split_launches += 1
    return out.reshape(x.shape)


#: forward kernel launches since the last reset (plain-version calls not
#: counted; under remat a recomputed forward counts again)
rmsnorm.launches = 0
#: backward kernel launches (`rmsnorm_bwd`) since the last reset
rmsnorm.bwd_launches = 0
#: `rmsnorm_split` calls on the card (each also one of `launches`)
rmsnorm.split_launches = 0
