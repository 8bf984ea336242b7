"""RMSNorm wrapper: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

Replaces `src/repro/kernels/rmsnorm/ops.py: rmsnorm` (Pallas, TPU).  The
kernel source is `kernels/csrc/rmsnorm.cu`; its note says what bounds it
on an H100.  Unlike the TPU wrapper, rows are not padded: the kernel
handles any row count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return lib, fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Same dtype out as in.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (float32 or bfloat16, any row count) or raises.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; the kernel needs one CUDA device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError("the rmsnorm kernel has no backward yet "
                                  "(training slice, ROADMAP Queue 1 item 7)")
    d = x.shape[-1]
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for d={d}")
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    lib, fn = _bind()
    code = fn(x2.data_ptr(), scale.data_ptr(), out.data_ptr(), x2.shape[0],
              d, x2.stride(0), eps, _DTYPES[x.dtype], _DTYPES[scale.dtype],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm", code)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


#: kernel launches since the last reset (plain-version calls not counted)
rmsnorm.launches = 0
