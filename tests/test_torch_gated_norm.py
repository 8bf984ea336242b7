"""The gated norm's plain versions (the Mamba2 mixer's norm of
v = y * silu(z), folded into the RMSNorm kernels on the card) against the
JAX reference's expression, autograd, the whole row, and the mixer's old
composition of ops.

Inputs are made with numpy from a seed and handed to both frameworks; bf16
inputs are rounded from the same float32 values on both sides.
Tolerances: float32 forward `TOL` (sums in another order, silu as
x / (1 + e^-x) here and x * sigmoid(x) in JAX: ulps of fp32), float32
gradients `GRAD_TOL` of each gradient's largest; bf16 `TOL` plus one ulp
relative (2^-7): the written-out backward rounds dv * s and
dv * y * silu'(z) once, where `jax.vjp` and autograd round dv, the
product and the cast each (a few bf16 roundings, each at most 2^-9
relative).  dscale: `dscale_bound` of the file `test_torch_kernels.py`,
at v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.layers import rmsnorm as jax_layer_rmsnorm
from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_gated,
                                             rmsnorm_split)
from repro_torch.kernels.rmsnorm.ref import (gate_ref, rmsnorm_gated_bwd_ref,
                                             rmsnorm_gated_ref,
                                             rmsnorm_split_bwd_ref,
                                             rmsnorm_split_gated_bwd_ref)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
#: float32 gradients, as a share of each one's largest
GRAD_TOL = 1e-6
SHAPES = [(2, 64, 128), (300, 96)]


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    yj, yt = _both(rng.standard_normal(shape), dtype)
    zj, zt = _both(2.0 * rng.standard_normal(shape), dtype)
    gj, gt = _both(rng.standard_normal(shape), dtype)
    sj, st = _both(1.0 + 0.3 * rng.standard_normal(shape[-1]), dtype)
    return (yj, zj, gj, sj), (yt, zt, gt, st)


def _jax_gated(y, z, s):
    """The reference's gated norm (`repro/models/ssm.py:156-157`)."""
    return jax_layer_rmsnorm(
        {"scale": s}, y * jax.nn.silu(z.astype(jnp.float32)).astype(y.dtype))


def dscale_bound(v, g, dtype):
    """float32 sums over rows in another order (1e-5 of the sum of the
    terms' magnitudes |g v r|), plus, in bf16, one ulp of the result."""
    vf, gf = v.float(), g.float()
    r = torch.rsqrt(torch.mean(vf * vf, dim=-1, keepdim=True) + 1e-6)
    mag = (gf * vf * r).abs().reshape(-1, v.shape[-1]).sum(0)
    return 1e-5 * mag, RTOL[dtype]


def _close_grad(got, want, dtype, what):
    got, want = got.float(), want.float()
    if dtype == "float32":
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL * float(want.abs().max()), (what, err)
    else:
        torch.testing.assert_close(got, want, atol=TOL[dtype],
                                   rtol=RTOL[dtype], msg=what)


def _close_dscale(got, want, v, g, dtype):
    atol, rtol = dscale_bound(v, g, dtype)
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_gated_norm_equals_the_jax_expression(dtype, shape):
    """`rmsnorm_gated_ref` against the reference's
    `rmsnorm(params, y * jax.nn.silu(z.astype(f32)).astype(y.dtype))`."""
    (yj, zj, _, sj), (yt, zt, _, st) = _inputs(shape, dtype, 20)
    got = rmsnorm_gated_ref(yt, zt, st)
    assert got.dtype == yt.dtype and got.shape == yt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(_jax_gated(yj, zj, sj), np.float32),
                               atol=TOL[dtype], rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gated_backward_ref_equals_jax_vjp_and_autograd(dtype, shape):
    """`rmsnorm_gated_bwd_ref` (the formula the backward kernel computes,
    dv kept in fp32) against `jax.vjp` of the reference's expression and
    torch autograd through `rmsnorm_gated_ref`: dy, dz and dscale."""
    (yj, zj, gj, sj), (yt, zt, gt, st) = _inputs(shape, dtype, 21)
    _, vjp = jax.vjp(_jax_gated, yj, zj, sj)
    jdy, jdz, jds = (torch.from_numpy(np.array(t, np.float32))
                     for t in vjp(gj))
    dy, dz, ds = rmsnorm_gated_bwd_ref(yt, zt, gt, st)
    assert (dy.dtype, dz.dtype, ds.dtype) == (yt.dtype,) * 3
    ya, za, sa = (t.clone().requires_grad_() for t in (yt, zt, st))
    rmsnorm_gated_ref(ya, za, sa).backward(gt)
    v = gate_ref(yt, zt)
    for want in ((jdy, jdz, jds), (ya.grad, za.grad, sa.grad)):
        _close_grad(dy, want[0], dtype, "dy")
        _close_grad(dz, want[1], dtype, "dz")
        _close_dscale(ds, want[2], v, gt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ranks", [2, 4])
def test_split_gated_norm_equals_the_whole_row(dtype, shape, ranks):
    """`rmsnorm_split(..., gate=z)` (a CPU tensor: its plain version) of
    each of `ranks` column blocks, its `sum_rows` adding the other
    blocks' squares of v as the 'model' psum does, equals the whole row's
    gated norm, forward and (float32) the gradients of y, z and the scale
    under autograd; and each block's `rmsnorm_split_gated_bwd_ref` (the
    split backward kernels' formula) equals the whole row's
    `rmsnorm_gated_bwd_ref` cut to its columns, in both dtypes.  (bf16
    autograd reaches y through every rank's own bf16 v, each gradient
    rounded and then summed in bf16: terms that cancel, so its error is
    the terms' ulps and not the result's; the written-out backward keeps
    dv in fp32, as the kernels do.)"""
    _, (y, z, g, scale) = _inputs(shape, dtype, 22)
    d = shape[-1]
    w = d // ranks
    cols = [slice(r * w, (r + 1) * w) for r in range(ranks)]
    ya, za, sa = (t.clone().requires_grad_() for t in (y, z, scale))
    want = rmsnorm_gated_ref(ya, za, sa)
    want_grads = torch.autograd.grad(want, (ya, za, sa), g)
    yb, zb, sb = (t.clone().requires_grad_() for t in (y, z, scale))

    def sum_rows(r):
        def add(ss):
            return ss + sum(torch.sum(gate_ref(yb[..., c], zb[..., c])
                                      .float() ** 2, dim=-1).reshape(-1)
                            for i, c in enumerate(cols) if i != r)
        return add

    got = torch.cat([rmsnorm_split(yb[..., c], sb[c], d, sum_rows(r),
                                   gate=zb[..., c])
                     for r, c in enumerate(cols)], -1)
    assert got.dtype == y.dtype and got.shape == y.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=RTOL[dtype])
    v = gate_ref(y, z)
    if dtype == "float32":
        grads = torch.autograd.grad(got, (yb, zb, sb), g)
        for name, a, b in zip(("dy", "dz"), grads[:2], want_grads[:2]):
            _close_grad(a, b, dtype, name)
        _close_dscale(grads[2], want_grads[2], v, g, dtype)

    vf = v.float().reshape(-1, d)
    sq = (vf * vf).sum(-1)
    gs = (g.float() * scale.float()).reshape(-1, d) * vf
    wdy, wdz, wds = rmsnorm_gated_bwd_ref(y, z, g, scale)
    for r, c in enumerate(cols):
        local = gs[:, c].sum(-1)
        dy, dz, ds = rmsnorm_split_gated_bwd_ref(
            y[..., c], z[..., c], g[..., c], scale[c], sq, d,
            lambda dot, local=local: dot - local + gs.sum(-1))
        for name, a, b in (("dy", dy, wdy[..., c]), ("dz", dz, wdz[..., c])):
            _close_grad(a, b, dtype, name)
        _close_dscale(ds, wds[c], v[..., c], g[..., c], dtype)


def test_gated_entries_on_cpu_are_the_old_composition_and_count_nothing():
    """On CPU tensors the gated entries are their plain versions, which
    are the ops the mixer ran before the gate was folded in (the same
    bits), through autograd too; no kernel launch is counted."""
    for dtype in ("float32", "bfloat16"):
        _, (y, z, g, s) = _inputs((3, 17, 64), dtype, 23)
        counters = ("launches", "bwd_launches", "split_launches",
                    "gated_launches", "gated_bwd_launches")
        before = [getattr(rmsnorm, c) for c in counters]
        v = y * F.silu(z.float()).to(y.dtype)
        assert torch.equal(rmsnorm_gated(y, z, s), rmsnorm(v, s))

        def sum_rows(ss):
            return 2 * ss

        assert torch.equal(rmsnorm_split(y, s, 128, sum_rows, gate=z),
                           rmsnorm_split(v, s, 128, sum_rows))
        ya, za, sa = (t.clone().requires_grad_() for t in (y, z, s))
        rmsnorm_gated(ya, za, sa).backward(g)
        yo, zo, so = (t.clone().requires_grad_() for t in (y, z, s))
        rmsnorm(yo * F.silu(zo.float()).to(yo.dtype), so).backward(g)
        for a, b in ((ya, yo), (za, zo), (sa, so)):
            assert torch.equal(a.grad, b.grad)
        assert [getattr(rmsnorm, c) for c in counters] == before


def test_split_backward_ref_without_a_gate_is_unchanged():
    """`rmsnorm_split_bwd_ref` (now sharing its dx with the gated one)
    against its formula written out in place."""
    _, (x, _, g, s) = _inputs((5, 7, 32), "float32", 24)
    ss = (x * x).sum(-1).reshape(-1) * 3.0
    dx, ds = rmsnorm_split_bwd_ref(x, g, s, ss, 96, lambda v: v * 2.0)
    r = torch.rsqrt(ss.reshape(5, 7, 1) / 96 + 1e-6)
    gs = g * s
    dot = (2.0 * (gs * x).sum(-1)).reshape(5, 7, 1)
    assert torch.equal(dx, r * gs - x * (r * r * r * dot / 96))
    assert torch.equal(ds, (g * (x * r)).reshape(-1, 32).sum(0))
