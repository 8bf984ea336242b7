"""Flash-attention wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Replaces `src/repro/kernels/flash_attention/ops.py: flash_attention`
(Pallas, TPU).  Model code calls it in the (B, S, H, D) layout; the
kernel reads that layout through strides, so nothing is transposed or
padded.  The kernel source is `kernels/csrc/flash_attention.cu`; its note
says what bounds it on an H100 and how it differs from the TPU design.

Two routes by dtype, one C entry point: bfloat16 launches the tensor-core
kernel (wgmma fed by TMA; counted in `flash_attention.tc_launches` as
well as `flash_attention.launches`), float32 the scalar kernel, which
parity checks hold to 2e-5.  TMA needs 16-byte aligned bases and nested,
positive strides that are multiples of 8 elements: a bf16 view that
misses any of these (an expanded head or batch has stride 0) is copied to
a contiguous tensor first (the same kernel runs on the copy).

The backward pass differentiates the plain version, as the reference's
custom VJP does; a backward kernel belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build, reject_dtensor
from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: profiler range around the backward pass (the plain attention's VJP)
PLAIN_BACKWARD = "flash_attention.plain_backward"


def declare(lib: ctypes.CDLL):
    """The library's `flash_attention_fwd`, its C signature declared."""
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.cache
def _bind():
    lib = _build.load("flash_attention")
    return lib, declare(lib)


def _ref_call(q, k, v, q_pos, k_pos, window, softcap, scale, causal):
    return attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
        k_pos, scale=scale, causal=causal, window=window,
        softcap=softcap).transpose(1, 2)


def tc_block_k(D: int) -> int:
    """KV tile of the tensor-core kernel at head dim D (`flash_plain`'s
    `block_k` that reproduces its rounding)."""
    return 128 if D <= 128 else 64


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` if TMA can read it in place, else a contiguous copy.  In place
    means a 16-byte aligned base and, for each dimension of size > 1 taken
    by stride, a stride that is a multiple of 8 elements and at least the
    extent of the dimensions below it: the nested, positive strides a
    tensor map describes.  So an expanded head or batch (stride 0) and
    overlapping views are copied."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0
    extent = t.shape[-1]
    for st, n in sorted((st, n) for n, st in zip(t.shape[:-1],
                                                  t.stride()[:-1]) if n > 1):
        ok = ok and st % 8 == 0 and st >= extent
        extent = st * n
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, q_pos, k_pos, window, softcap, scale, causal):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    if any(t.device != dev for t in (k, v, q_pos, k_pos)):
        raise ValueError("flash_attention: all inputs must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if K == 0 or H % K or D % 8 or not 8 <= D <= 256:
        raise ValueError(f"flash_attention kernel takes H % K == 0 and D a "
                         f"multiple of 8 up to 256; got H={H} K={K} D={D}")
    if q_pos.shape != (S,) or k_pos.shape != (T,):
        raise ValueError("flash_attention: positions must be (S,) and (T,)")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    if B * S * H == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no keys (T == 0)")
    lib, fn = _bind()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
              k_pos.data_ptr(), out.data_ptr(), B, S, T, H, K, D,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              scale, int(causal), window or 0, softcap or 0.0,
              _DTYPES[q.dtype],
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.tc_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, softcap, scale, causal):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.opts = (window, softcap, scale, causal)
        return _launch(q, k, v, q_pos, k_pos, window, softcap, scale, causal)

    @staticmethod
    def backward(ctx, g):
        # the VJP of the plain attention, as the reference's `_fa_bwd`;
        # the named range lets a profile attribute its device time
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        with torch.profiler.record_function(PLAIN_BACKWARD), \
                torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _ref_call(*qkv, q_pos, k_pos, *ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, K, D); positions int32 (S,), (T,).
    Returns (B, S, H, D) in q's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  Keys past T are never attended, causal or not.
    """
    reject_dtensor("flash_attention", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return _ref_call(q, k, v, q_pos, k_pos, window, softcap, scale,
                         causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, window, softcap,
                                 scale, causal)


#: kernel launches since the last reset (plain-version calls not counted)
flash_attention.launches = 0
#: launches of the tensor-core (bfloat16) kernel alone, since the last reset
flash_attention.tc_launches = 0
