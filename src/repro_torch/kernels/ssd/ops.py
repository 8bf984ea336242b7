"""SSD chunked-scan wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Replaces `src/repro/kernels/ssd/ops.py: ssd` (Pallas, TPU), with its
contract: `ssd(x, dt, A, B, C, chunk=...) -> (y, None)`.  The kernel
source is `kernels/csrc/ssd.cu`; its note says what bounds it on an H100
and why its chunk (128 rows for bfloat16, 64-row tiles for float32) need
not be `chunk`.  Unlike the TPU wrapper, nothing is padded: the kernel
masks the ragged last chunk by index, and reads x, B and C through their
strides, so the model's split views of the conv output go in without a
copy.

Two routes by dtype, one C entry point: bfloat16 runs the tensor-core
kernel (three passes in one call; counted in `ssd.tc_launches` as well as
`ssd.launches`), whose arithmetic `ref.ssd_tc_plain` models; float32 the
scalar kernel, which parity checks hold to `ssd_plain` and `ssd_ref`.
The bf16 route loads rows with 16-byte copies, so a view whose base is
not 16-byte aligned or whose strides are not multiples of 8 elements is
copied first (the same kernel runs on the copy); the wrapper allocates
the kernel's fp32 state scratch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a chunk of the bf16 tensor-core kernel (`tc::kQ` in ssd.cu)
TC_CHUNK = 128
#: head dims and state sizes the bf16 tensor-core kernel is built for
TC_P = (16, 32, 64)
TC_N = (16, 32, 64, 128)


@functools.cache
def _bind():
    lib = _build.load("ssd")
    fn = lib.ssd_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_int] + [ctypes.c_void_p] * 3)
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, fn


def _copy_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` if 16-byte copies can read its rows in place (16-byte aligned
    base, innermost stride 1, every other stride a multiple of 8
    elements), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _launch(x, dt, A, B, C):
    b, L, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    if any(t.device != dev for t in (dt, A, B, C)):
        raise ValueError("ssd: all inputs must be on one device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes float32/bfloat16 x, B, C of one "
                        f"dtype; got {x.dtype}, {B.dtype}, {C.dtype}")
    if (dt.shape != (b, L, H) or A.shape != (H,) or B.shape != (b, L, N)
            or C.shape != (b, L, N)):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    tc = x.dtype == torch.bfloat16
    if tc:
        if P not in TC_P or N not in TC_N:
            raise ValueError(f"ssd tensor-core kernel (bfloat16) takes P in "
                             f"{TC_P} and N in {TC_N}; got P={P} N={N}")
        x, B, C = (_copy_ready(t) for t in (x, B, C))
    else:
        if P % 4 or N % 4 or P == 0 or N == 0:
            raise ValueError(f"ssd kernel takes P and N multiples of 4; got "
                             f"P={P} N={N}")
        smem = _bind()[0].ssd_smem_bytes(N, P)
        budget = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        if smem > budget:
            raise ValueError(f"ssd kernel: P={P}, N={N} need {smem} bytes "
                             f"of shared memory per block, over the card's "
                             f"{budget}")
        x, B, C = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (x, B, C))
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    if b * L * H == 0:
        return y
    lib, fn = _bind()
    states = cumlast = None
    if tc:      # the state before each chunk but the first, fp32
        nc1 = -(-L // TC_CHUNK) - 1
        states = torch.empty((b, nc1, H, P, N), dtype=torch.float32,
                             device=dev)
        cumlast = torch.empty((b, nc1, H), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), b, L, H, P, N,
              x.stride(0), x.stride(1), x.stride(2),
              dt.stride(0), dt.stride(1), dt.stride(2),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1),
              _DTYPES[x.dtype],
              None if states is None else states.data_ptr(),
              None if cumlast is None else cumlast.data_ptr(),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ssd", code)
    ssd.launches += 1
    if tc:
        ssd.tc_launches += 1
    return y


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b, L, H, P); dt: (b, L, H) post-softplus; A: (H,) negative;
    B, C: (b, L, N).  Returns (y (b, L, H, P) in x's dtype, None).

    A CPU tensor takes the plain version in chunks of `chunk`, and
    autograd differentiates it, as the other wrappers' CPU routes are.  A
    CUDA tensor launches the kernel (its own chunk of rows; the result
    does not depend on the chunk apart from rounding) or raises.  The
    kernel has no backward, so a CUDA input that needs a gradient raises:
    SSM training on the card waits for the SSD backward (ROADMAP.md, Next,
    "SSD backward and SSM training on the card").
    """
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, chunk), None
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "the ssd kernel has no backward yet, so a Mamba2 model cannot "
            "train on the card (ROADMAP.md, Next: SSD backward and SSM "
            "training on the card)")
    return _launch(x, dt, A, B, C), None


#: kernel calls since the last reset (plain-version calls not counted);
#: one per wrapper call, whatever the CUDA launches inside it
ssd.launches = 0
#: calls of the tensor-core (bfloat16) kernel alone, since the last reset
ssd.tc_launches = 0
