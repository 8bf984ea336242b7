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

On a CUDA tensor the forward runs inside a `torch.autograd.Function`
(`_SSD`) whose backward launches the backward kernel (`ssd_bwd` in the
same source, one C call; `ssd.bwd_launches` counts it), again two routes
by dtype:
- bfloat16 (training) runs on tensor cores (`ssd.bwd_tc_launches` counts
  it too) in the forward's 128-row chunks, and reads the fp32 states the
  forward's passes left in their scratch: a forward whose inputs need a
  gradient keeps them for it ((b, chunks - 1, H, P, N) fp32 a mixer, one
  unit's at a time under remat), one that needs none keeps nothing.
  Its passes: each chunk's own state gradient, their reverse scan (dS,
  written split), the chunk products for a group of heads a block
  (`bwd_heads_per_group`: dx, dB and dC summed over the group on the
  chip), the rows' cumsum gradient, then dB and dC summed over the groups
  and dA over the chunks, in fixed orders.  `ref.ssd_bwd_tc_plain` is its
  arithmetic (splits and groups); it takes the forward route's P and N
  and raises for others, or without the forward's states.
- float32 (parity checks) runs the first backward kernel, scalar fp32
  FMAs in 64-row chunks, recomputing the states itself.
`ref.ssd_bwd_plain` is the backward written out, which both are held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, reject_dtensor
from .ref import TC_CHUNK, ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


@functools.cache
def _bind_bwd():
    lib = _build.load("ssd")
    fn = lib.ssd_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p] * 7)
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    tc = lib.ssd_bwd_tc
    tc.restype = ctypes.c_int
    tc.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p] * 11)
    return lib, fn, tc


def _copy_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` if 16-byte copies can read its rows in place (16-byte aligned
    base, innermost stride 1, every other stride a multiple of 8
    elements), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _launch(x, dt, A, B, C, keep=False):
    """(y, states): y by the forward kernel; states, for a bf16 call with
    `keep`, the fp32 (b, chunks - 1, H, P, N) state before each chunk but
    the first that the tensor-core passes leave in their scratch (the
    backward reads them), else None."""
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
        _check_tc(P, N, "ssd")
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
        return y, None
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
    return y, states if keep else None


def _check_tc(P, N, what):
    if P not in TC_P or N not in TC_N:
        raise ValueError(f"{what} tensor-core kernel (bfloat16) takes P in "
                         f"{TC_P} and N in {TC_N}; got P={P} N={N}")


#: rows of a chunk of the float32 backward kernel (`bwd::kQ` in ssd.cu);
#: the bf16 one's is the forward's, `TC_CHUNK`
BWD_CHUNK = 64


def bwd_heads_per_group(b, L, H, device=None):
    """Heads a block of the bf16 backward's chunk passes takes (`hg`): the
    grid about one wave, as a block fills an SM, so that its fixed work
    (C.B^T, the W terms of dB and dC, their partial sums) is paid as few
    times as the card allows, up to 16 heads.  `ref.ssd_bwd_tc_plain
    (group=...)` takes the same grouping."""
    sms = torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device()
    ).multi_processor_count
    work = b * -(-L // TC_CHUNK) * H
    return max(1, min(16, -(-work // sms)))


def _launch_bwd(x, dt, A, B, C, dy, states=None):
    """(dx, ddt, dA, dB, dC) of the scan at (x, dt, A, B, C) for the
    output gradient dy, by the backward kernel: dx, dB, dC in x's dtype,
    ddt and dA float32.  bf16 runs the tensor-core route, which reads the
    forward's `states` (from `_launch(..., keep=True)`); float32 the
    scalar route, which recomputes its own."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"ssd backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"for x {tuple(x.shape)} {x.dtype}")
    tc = x.dtype == torch.bfloat16
    if tc:
        _check_tc(P, N, "ssd backward")
        nc1 = max(0, -(-L // TC_CHUNK) - 1)
        if (states is None or states.shape != (b, nc1, H, P, N)
                or states.dtype != torch.float32 or states.device != dev
                or not states.is_contiguous()) and b * L * H:
            got = None if states is None else (tuple(states.shape),
                                               states.dtype)
            raise ValueError(f"ssd backward (bfloat16) reads the forward's "
                             f"states, ({b}, {nc1}, {H}, {P}, {N}) float32 "
                             f"from _launch(..., keep=True); got {got}")
        x, B, C, dy = (_copy_ready(t) for t in (x, B, C, dy))
    else:
        if P % 4 or N % 4 or P == 0 or N == 0:
            raise ValueError(f"ssd backward kernel takes P and N multiples "
                             f"of 4; got P={P} N={N}")
        smem = _bind_bwd()[0].ssd_bwd_smem_bytes(N, P)
        budget = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        if smem > budget:
            raise ValueError(f"ssd backward kernel: P={P}, N={N} need "
                             f"{smem} bytes of shared memory per block, over "
                             f"the card's {budget}")
        x, B, C, dy = (t if t.stride(-1) == 1 else t.contiguous()
                       for t in (x, B, C, dy))
    lib, fn, fn_tc = _bind_bwd()
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, L, H), **f32)
    dA = torch.zeros((H,), **f32)
    dB = torch.empty((b, L, N), dtype=x.dtype, device=dev)
    dC = torch.empty((b, L, N), dtype=x.dtype, device=dev)
    if b * L * H == 0:
        return dx, ddt, dA, dB.zero_(), dC.zero_()
    strides = (x.stride(0), x.stride(1), x.stride(2),
               dt.stride(0), dt.stride(1), dt.stride(2),
               B.stride(0), B.stride(1), C.stride(0), C.stride(1),
               dy.stride(0), dy.stride(1), dy.stride(2))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr())
    if tc:
        nc, hg = nc1 + 1, bwd_heads_per_group(b, L, H, dev)
        G, slices = -(-H // hg), -(-(P * N) // 1024)
        scratch = (torch.empty((b, nc1, H, P, N), **f32),           # D
                   torch.empty((b, nc1, H, 2, P, N), dtype=x.dtype,
                               device=dev),                         # dS hi, lo
                   torch.empty((b, nc1, H, 2, P, N), dtype=x.dtype,
                               device=dev),                         # S hi, lo
                   torch.empty((b, nc1, H), **f32),                 # clr
                   torch.empty((b, nc1, H, slices), **f32),         # sdp
                   torch.empty((b, L, H), **f32),                   # v1
                   torch.empty((b, G, L, N), **f32),                # dBp
                   torch.empty((b, G, L, N), **f32),                # dCp
                   torch.empty((b, nc, H), **f32))                  # dAp
        code = fn_tc(*ptrs, b, L, H, P, N, hg, *strides, states.data_ptr(),
                     *(t.data_ptr() for t in scratch), stream)
        _build.check(lib, "ssd_bwd", code)
        ssd.bwd_tc_launches += 1
    else:
        nc = -(-L // BWD_CHUNK)
        scratch = (torch.empty((b, nc, H, P, N), **f32),            # states
                   torch.empty((b, nc, H, P, N), **f32),            # dstates
                   torch.empty((b, nc, H), **f32),                  # cumlast
                   torch.empty((b, H, L, N), **f32),                # dBp
                   torch.empty((b, H, L, N), **f32),                # dCp
                   torch.empty((b, nc, H), **f32))                  # dAp
        code = fn(*ptrs, b, L, H, P, N, *strides,
                  *(t.data_ptr() for t in scratch), stream)
        _build.check(lib, "ssd_bwd", code)
    ssd.bwd_launches += 1
    return dx, ddt, dA, dB, dC


class _SSD(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel; a bf16
    forward whose inputs need a gradient keeps its states for it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, keep):
        y, states = _launch(x, dt, A, B, C, keep=keep)
        ctx.save_for_backward(x, dt, A, B, C, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, states = ctx.saved_tensors
        dx, ddt, dA, dB, dC = _launch_bwd(x, dt, A, B, C, dy, states)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, None


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b, L, H, P); dt: (b, L, H) post-softplus; A: (H,) negative;
    B, C: (b, L, N).  Returns (y (b, L, H, P) in x's dtype, None).

    A CPU tensor takes the plain version in chunks of `chunk`, and
    autograd differentiates it, as the other wrappers' CPU routes are.  A
    CUDA tensor launches the kernel (its own chunk of rows; the result
    does not depend on the chunk apart from rounding) or raises, and its
    gradient launches the backward kernel (`_SSD`).
    """
    reject_dtensor("ssd", x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, chunk), None
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for {x.device}")
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, B, C))
    return _SSD.apply(x, dt, A, B, C, keep), None


#: kernel calls since the last reset (plain-version calls not counted);
#: one per wrapper call, whatever the CUDA launches inside it
ssd.launches = 0
#: calls of the tensor-core (bfloat16) kernel alone, since the last reset
ssd.tc_launches = 0
#: backward kernel calls (`ssd_bwd`, one C call each) since the last reset
ssd.bwd_launches = 0
#: calls of the tensor-core (bfloat16) backward alone, since the last reset
ssd.bwd_tc_launches = 0
