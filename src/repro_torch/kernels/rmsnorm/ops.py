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

`rmsnorm_gated` is the Mamba2 mixer's gated norm, the norm of
v = y * silu(z) (`rmsnorm_gated_ref`), in one launch that forms v in
registers; its backward (`rmsnorm_gated_bwd`: dy, dz and dscale) is one
launch too, dscale's sum over the blocks folded into it.  Autograd saves
y and z, never v or an fp32 copy of z.

`rmsnorm_split` is the norm of a row split by columns over ranks (the
Mamba2 mixer's gated norm where 'model' splits its heads, `gate=z`): one
kernel writes each row's fp32 sum of squares over the local columns, the
caller's `sum_rows` adds them over the ranks (an all-reduce of one
float a row), and a second kernel scales the rank's columns.  Its
backward is the same shape: a kernel writes each row's local sum of
g * scale * x, `sum_rows` adds it over the ranks, and a second kernel
writes dx (dz) and the rank's dscale (`rmsnorm_split_bwd`,
`rmsnorm_split_gated_bwd`; counted in `rmsnorm.bwd_launches`);
`rmsnorm_split_bwd_ref` and `rmsnorm_split_gated_bwd_ref` are them
written out.  One launch on each side of the all-reduce.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import _build, reject_dtensor
from .ref import rmsnorm_gated_ref, rmsnorm_ref, rmsnorm_split_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: blocks of the backward's first kernel per SM (each writes one fp32
#: row of dscale partial sums)
BWD_BLOCKS_PER_SM = 2
#: rows of class sums after the partial rows, and int32 counters (one a
#: class and one for the classes), where dscale's sum is folded into the
#: backward kernel (`fold_dscale` in rmsnorm.cu)
FOLD_CLASSES = 8

_P = ctypes.c_void_p
_LL, _INT, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_float


@functools.cache
def _bind():
    lib = _build.load("rmsnorm")
    sig = {
        "rmsnorm_fwd": [_P] * 4 + [_LL, _INT, _LL, _LL, _F, _INT, _INT, _P],
        "rmsnorm_sumsq": [_P] * 3 + [_LL, _INT, _LL, _LL, _INT, _P],
        "rmsnorm_apply": [_P] * 5 + [_LL, _INT, _LL, _LL, _INT, _F, _INT,
                                     _INT, _P],
        "rmsnorm_bwd": [_P] * 9 + [_INT, _LL, _INT, _LL, _LL, _LL, _F, _INT,
                                   _INT, _P],
        "rmsnorm_split_dot": [_P] * 5 + [_INT, _LL, _INT, _LL, _LL, _LL,
                                         _INT, _INT, _P],
        "rmsnorm_split_bwd": [_P] * 11 + [_INT, _LL, _INT, _LL, _LL, _LL,
                                          _INT, _F, _INT, _INT, _P],
    }
    fns = {}
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
        fns[name] = fn
    lib.rmsnorm_kernels_launched.restype = ctypes.c_longlong
    lib.rmsnorm_kernels_launched.argtypes = []
    return lib, fns


def kernels_launched() -> int:
    """Kernels the RMSNorm library has launched since it was loaded (its
    own count of every launch, the second kernel of a two-launch backward
    and each of a split pair included): what a call cost in launches."""
    return _bind()[0].rmsnorm_kernels_launched()


def _call(name: str, *args) -> None:
    lib, fns = _bind()
    _build.check(lib, name, fns[name](*args))


@functools.cache
def _max_parts(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return BWD_BLOCKS_PER_SM * sms


def _index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _fold_counters(device) -> torch.Tensor:
    """The fold's int32 counters for the current stream of `device`:
    zeros, allocated once and cached (each launch leaves them zero), so
    no call pays a launch to clear them; one set a stream, as two
    launches on two streams could run at once."""
    key = (_index(device), torch.cuda.current_stream(device).cuda_stream)
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = torch.zeros(FOLD_CLASSES + 1, dtype=torch.int32,
                                         device=device)
    return c


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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


def _like(t: torch.Tensor, x: torch.Tensor, what: str) -> None:
    """Raise unless t (the gate z, or the output gradient g) has x's
    shape, dtype and device."""
    if t.shape != x.shape or t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"rmsnorm: {what} {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} for x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """(rows, d) view of t with unit column stride (copied if needed)."""
    t2 = t.reshape(-1, d)
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _gate(z: Optional[torch.Tensor], x: torch.Tensor, scale: torch.Tensor,
          d: int):
    """(z's (rows, d) view or None, its pointer or None, its row stride);
    the caller holds the view across the launch (a copy, where z's
    columns are strided).  The gated kernels take y, z and the scale in
    one dtype."""
    if z is None:
        return None, None, 0
    _like(z, x, "gate z")
    if scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm: the gated kernels take y, z and the "
                        f"scale in one dtype, got {x.dtype} and "
                        f"{scale.dtype}")
    z2 = _rows(z, d)
    return z2, z2.data_ptr(), z2.stride(0)


def _fwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
         z: Optional[torch.Tensor] = None) -> torch.Tensor:
    d = _check(x, scale)
    x2 = _rows(x, d)
    _z, zp, zs = _gate(z, x, scale, d)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    _call("rmsnorm_fwd", x2.data_ptr(), zp, scale.data_ptr(), out.data_ptr(),
          x2.shape[0], d, x2.stride(0), zs, eps, _DTYPES[x.dtype],
          _DTYPES[scale.dtype], _stream(x.device))
    rmsnorm.launches += 1
    rmsnorm.gated_launches += z is not None
    return out.reshape(x.shape)


def _bwd(x, z, g, scale, eps, fold):
    """(dx, dz or None, dscale) of the whole-row norm (gated where z is
    given) by the backward kernel; `fold`: dscale's sum in the same
    launch, else a second one."""
    d = _check(x, scale)
    _like(g, x, "g")
    x2, g2 = _rows(x, d), _rows(g, d)
    _z, zp, zs = _gate(z, x, scale, d)
    rows = x2.shape[0]
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dz = None if z is None else torch.empty_like(dx)
    if rows == 0:
        return (dx.reshape(x.shape), None if dz is None else
                dz.reshape(x.shape), torch.zeros_like(scale))
    dscale = torch.empty_like(scale)
    max_parts = _max_parts(_index(x.device))
    part = torch.empty((max_parts + FOLD_CLASSES * fold, d),
                       dtype=torch.float32, device=x.device)
    _call("rmsnorm_bwd", x2.data_ptr(), zp, g2.data_ptr(), scale.data_ptr(),
          dx.data_ptr(), None if dz is None else dz.data_ptr(),
          dscale.data_ptr(), part.data_ptr(),
          _fold_counters(x.device).data_ptr() if fold else None, max_parts,
          rows, d, x2.stride(0), zs, g2.stride(0), eps, _DTYPES[x.dtype],
          _DTYPES[scale.dtype], _stream(x.device))
    rmsnorm.bwd_launches += 1
    rmsnorm.gated_bwd_launches += z is not None
    return (dx.reshape(x.shape), None if dz is None else dz.reshape(x.shape),
            dscale)


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6):
    """(dx, dscale) of the norm at x for the output gradient g, by the
    backward kernel and `rmsnorm_dscale_sum` (CUDA tensors only); dx in
    x's dtype, dscale in the scale's dtype, as `rmsnorm_bwd_ref` computes
    them."""
    dx, _, dscale = _bwd(x, None, g, scale, eps, fold=False)
    return dx, dscale


def rmsnorm_gated_bwd(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-6):
    """(dy, dz, dscale) of the gated norm at (y, z) for the output
    gradient g, by one launch of the backward kernel (CUDA tensors only);
    dy, dz in y's dtype, dscale in the scale's dtype, as
    `rmsnorm_gated_bwd_ref` computes them."""
    return _bwd(y, z, g, scale, eps, fold=True)


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


class _RMSNormGated(torch.autograd.Function):
    """The gated norm's kernel, differentiated by its backward kernel;
    saves y and z (z may be a column view of a wider tensor)."""

    @staticmethod
    def forward(ctx, y, z, scale, eps):
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return _fwd(y, scale, eps, z)

    @staticmethod
    def backward(ctx, g):
        y, z, scale = ctx.saved_tensors
        dy, dz, dscale = rmsnorm_gated_bwd(y, z, g, scale, ctx.eps)
        return dy, dz, dscale, None


def _on_card(name: str, *tensors) -> bool:
    """False for a CPU tensor (the plain version's), True for a CUDA one;
    raise for a DTensor or another device."""
    reject_dtensor(name, *tensors)
    dev = tensors[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {tensors[0].device}")
    return dev == "cuda"


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Same dtype out as in.

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (float32 or bfloat16, any row count)
    or raises, and its gradient launches the backward kernel.
    """
    if not _on_card("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps)
    return _RMSNorm.apply(x, scale, eps)


def rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The norm of v = y * silu(z) (silu in fp32 rounded to y's dtype, the
    product rounded to y's dtype; `rmsnorm_gated_ref`).  y, z: (..., d) of
    one dtype, z in any layout whose last dimension has unit stride (a
    column view of a wider tensor is read in place); scale: (d,).

    A CPU tensor takes `rmsnorm_gated_ref` (autograd differentiates it);
    a CUDA tensor launches the kernel, counted in `rmsnorm.launches` as
    the norm it stands for and in `rmsnorm.gated_launches`, or raises;
    its gradient launches the gated backward kernel once
    (`rmsnorm.bwd_launches`, `rmsnorm.gated_bwd_launches`).
    """
    if not _on_card("rmsnorm_gated", y, z, scale):
        return rmsnorm_gated_ref(y, z, scale, eps)
    return _RMSNormGated.apply(y, z, scale, eps)


def _summed(ss: torch.Tensor, rows: int, device) -> torch.Tensor:
    """`sum_rows`'s result, checked: (rows,) fp32 on the kernels' card."""
    if ss.shape != (rows,) or ss.dtype != torch.float32 or \
            ss.device != device:
        raise ValueError(f"rmsnorm_split: sum_rows gave {tuple(ss.shape)} "
                         f"{ss.dtype} on {ss.device} for {rows} rows")
    return ss.contiguous()


def _split_fwd(x, scale, d_total, sum_rows, eps, z=None):
    """(out, the rows' summed squares) of the split row's norm (of the
    gated v where z is given), by the sum-of-squares kernel, `sum_rows`
    and the scaling kernel."""
    d = _check(x, scale)
    if d_total < d:
        raise ValueError(f"rmsnorm_split: {d} local columns of rows "
                         f"{d_total} wide")
    x2 = _rows(x, d)
    _z, zp, zs = _gate(z, x, scale, d)
    rows = x2.shape[0]
    stream = _stream(x.device)
    ss = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _call("rmsnorm_sumsq", x2.data_ptr(), zp, ss.data_ptr(), rows, d,
          x2.stride(0), zs, _DTYPES[x.dtype], stream)
    ss = _summed(sum_rows(ss), rows, x.device)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    _call("rmsnorm_apply", x2.data_ptr(), zp, scale.data_ptr(), ss.data_ptr(),
          out.data_ptr(), rows, d, x2.stride(0), zs, d_total, eps,
          _DTYPES[x.dtype], _DTYPES[scale.dtype], stream)
    rmsnorm.launches += 1
    rmsnorm.split_launches += 1
    rmsnorm.gated_launches += z is not None
    return out.reshape(x.shape), ss


def _split_bwd(x, z, g, scale, ss, d_total, sum_rows, eps, fold=True):
    """(dx, dz or None, dscale) of the split row's norm (gated where z is
    given) by the backward pair around `sum_rows`, dscale's sum folded
    into the second launch (`fold`; else a third launch adds it)."""
    d = _check(x, scale)
    _like(g, x, "g")
    x2, g2 = _rows(x, d), _rows(g, d)
    _z, zp, zs = _gate(z, x, scale, d)
    rows = x2.shape[0]
    ss = _summed(ss, rows, x.device)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dz = None if z is None else torch.empty_like(dx)
    max_parts = _max_parts(_index(x.device))
    stream = _stream(x.device)
    dot = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        _call("rmsnorm_split_dot", x2.data_ptr(), zp, g2.data_ptr(),
              scale.data_ptr(), dot.data_ptr(), max_parts, rows, d,
              x2.stride(0), zs, g2.stride(0), _DTYPES[x.dtype],
              _DTYPES[scale.dtype], stream)
    dot = _summed(sum_rows(dot), rows, x.device)
    if rows == 0:
        return (dx.reshape(x.shape), None if dz is None else
                dz.reshape(x.shape), torch.zeros_like(scale))
    dscale = torch.empty_like(scale)
    part = torch.empty((max_parts + FOLD_CLASSES * fold, d),
                       dtype=torch.float32, device=x.device)
    _call("rmsnorm_split_bwd", x2.data_ptr(), zp, g2.data_ptr(),
          scale.data_ptr(), ss.data_ptr(), dot.data_ptr(), dx.data_ptr(),
          None if dz is None else dz.data_ptr(), dscale.data_ptr(),
          part.data_ptr(),
          _fold_counters(x.device).data_ptr() if fold else None, max_parts,
          rows, d, x2.stride(0), zs, g2.stride(0), d_total, eps,
          _DTYPES[x.dtype], _DTYPES[scale.dtype], stream)
    rmsnorm.bwd_launches += 1
    rmsnorm.gated_bwd_launches += z is not None
    return (dx.reshape(x.shape), None if dz is None else dz.reshape(x.shape),
            dscale)


def rmsnorm_split_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                      ss: torch.Tensor, d_total: int,
                      sum_rows: Callable[[torch.Tensor], torch.Tensor],
                      eps: float = 1e-6):
    """(dx, dscale) of the split row's norm at x for the output gradient
    g, by the backward kernels (CUDA tensors only): ss is the forward's
    (rows,) fp32 squares summed over the ranks, `sum_rows` sums the rows'
    local dots over them between the two launches; dx in x's dtype,
    dscale (this rank's entries) in the scale's, as
    `rmsnorm_split_bwd_ref` computes them."""
    dx, _, dscale = _split_bwd(x, None, g, scale, ss, d_total, sum_rows, eps)
    return dx, dscale


def rmsnorm_split_gated_bwd(y: torch.Tensor, z: torch.Tensor,
                            g: torch.Tensor, scale: torch.Tensor,
                            ss: torch.Tensor, d_total: int,
                            sum_rows: Callable[[torch.Tensor], torch.Tensor],
                            eps: float = 1e-6):
    """(dy, dz, dscale) of the split row's gated norm, as
    `rmsnorm_split_bwd` with the gate z (ss: the forward's summed squares
    of v), as `rmsnorm_split_gated_bwd_ref` computes them."""
    return _split_bwd(y, z, g, scale, ss, d_total, sum_rows, eps)


class _RMSNormSplit(torch.autograd.Function):
    """The split row's kernel pair, differentiated by its backward pair;
    `sum_rows` runs again in the backward, so it must carry its group
    with it rather than find it in ambient state."""

    @staticmethod
    def forward(ctx, x, scale, d_total, sum_rows, eps, z):
        out, ss = _split_fwd(x, scale, d_total, sum_rows, eps, z)
        ctx.save_for_backward(x, z, scale, ss)
        ctx.d_total, ctx.sum_rows, ctx.eps = d_total, sum_rows, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, z, scale, ss = ctx.saved_tensors
        dx, dz, dscale = _split_bwd(x, z, g.contiguous(), scale, ss,
                                    ctx.d_total, ctx.sum_rows, ctx.eps)
        return dx, dscale, None, None, None, dz


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, d_total: int,
                  sum_rows: Callable[[torch.Tensor], torch.Tensor],
                  eps: float = 1e-6,
                  gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The norm of rows `d_total` wide split by columns over ranks.  x:
    (..., d), this rank's d columns of each row; scale: (d,), its slice
    of the weight; `sum_rows` sums a (rows,) fp32 vector over the ranks
    that hold the rest of each row (a psum over 'model', bound to its
    group: the backward calls it again).  `gate`: z, this rank's columns
    of the Mamba2 mixer's gate, to norm v = x * silu(z) as
    `rmsnorm_gated` does.  Same dtype out as in.

    A CPU tensor takes `rmsnorm_split_ref` (autograd runs through
    `sum_rows`, whose adjoint, a psum's, is the same sum).  A CUDA
    tensor launches the sum-of-squares kernel, sums, then launches the
    scaling kernel (counted together as one `rmsnorm.launches`, as the
    whole-row norm they stand for, in `rmsnorm.split_launches`, and
    gated in `rmsnorm.gated_launches`), or raises; its gradient launches
    the backward pair (`_RMSNormSplit`).
    """
    tensors = (x, scale) if gate is None else (x, scale, gate)
    if not _on_card("rmsnorm_split", *tensors):
        return rmsnorm_split_ref(x, scale, d_total, sum_rows, eps, gate=gate)
    return _RMSNormSplit.apply(x, scale, d_total, sum_rows, eps, gate)


#: forward kernel launches since the last reset (plain-version calls not
#: counted; under remat a recomputed forward counts again; a split pair
#: counts once)
rmsnorm.launches = 0
#: backward kernel launches since the last reset (`rmsnorm_bwd`,
#: `rmsnorm_gated_bwd`, and a split backward pair counted once)
rmsnorm.bwd_launches = 0
#: `rmsnorm_split` calls on the card (each also one of `launches`)
rmsnorm.split_launches = 0
#: gated forward calls on the card, whole or split (each also one of
#: `launches`)
rmsnorm.gated_launches = 0
#: gated backward calls on the card, whole or split (each also one of
#: `bwd_launches`)
rmsnorm.gated_bwd_launches = 0
