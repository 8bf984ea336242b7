"""Port kernels' plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU), and the port's wrappers on CPU tensors.

Inputs are made with numpy from a seed and handed to both frameworks;
bf16 inputs are rounded from the same float32 values on both sides.
Tolerances are the reference's own (`tests/test_kernels.py`): float32
2e-5 (sums in another order), bfloat16 2e-2 (both round an fp32 result to
bf16; one ulp at |x| < 2 is <= 2^-7).  `flash_plain`, the tensor-core
kernel's arithmetic, also rounds P to bf16 before P.V (one ulp of a weight,
2^-8 relative) and stays within the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models.layers import rmsnorm as jax_layer_rmsnorm
from repro_torch.kernels.flash_attention.ops import (_tma_ready,
                                                     flash_attention,
                                                     tc_block_k)
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_plain
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


FA_CASES = [
    (1, 128, 128, 4, 2, 64, True, None, None),
    (2, 256, 256, 8, 4, 64, True, None, 50.0),
    (1, 200, 200, 4, 4, 48, True, 128, None),     # unpadded + window
    (1, 128, 384, 4, 2, 64, True, None, None),    # longer KV (decode-ish)
    (1, 128, 128, 4, 1, 64, False, None, None),   # MQA + non-causal
    (1, 130, 130, 2, 2, 32, True, None, None),    # awkward sizes
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", FA_CASES)
def test_plain_flash_attention_matches_jax_kernel(dtype, B, S, T, H, K, D,
                                                  causal, window, softcap):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((B, S, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((B, T, K, D)), dtype)
    vj, vt = _both(rng.standard_normal((B, T, K, D)), dtype)
    qp = np.arange(T - S, T, dtype=np.int32)
    kp = np.arange(T, dtype=np.int32)
    want = jax_flash(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kp),
                     window=window, softcap=softcap, causal=causal)
    got = flash_attention(qt, kt, vt, torch.from_numpy(qp),
                          torch.from_numpy(kp), window=window,
                          softcap=softcap, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", FA_CASES + [
    (1, 200, 200, 4, 4, 80, True, None, None),    # zamba2's head dim, ragged
    (1, 256, 256, 6, 2, 64, True, None, None),    # GQA G = 3, as smollm
])
def test_flash_plain_matches_jax_kernel(dtype, B, S, T, H, K, D, causal,
                                        window, softcap):
    """The tensor-core kernel's rounding model (P to bf16, l from the
    rounded P, key tiles of the kernel's size) against the Pallas kernel."""
    rng = np.random.default_rng(5)
    qj, qt = _both(rng.standard_normal((B, S, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((B, T, K, D)), dtype)
    vj, vt = _both(rng.standard_normal((B, T, K, D)), dtype)
    qp = np.arange(T - S, T, dtype=np.int32)
    kp = np.arange(T, dtype=np.int32)
    want = jax_flash(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kp),
                     window=window, softcap=softcap, causal=causal)
    got = flash_plain(qt.transpose(1, 2), kt.transpose(1, 2),
                      vt.transpose(1, 2), torch.from_numpy(qp),
                      torch.from_numpy(kp), scale=D ** -0.5, causal=causal,
                      window=window, softcap=softcap,
                      block_k=tc_block_k(D)).transpose(1, 2)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-5, 0.0),
                                             ("bfloat16", 2e-2, 2.0 ** -7)])
def test_flash_plain_decode_like_offsets_match_ref(dtype, atol, rtol):
    """S = 64 queries at positions 936..999 against T = 1000 keys, V offset
    by 3 so a wrongly weighted key shows: `flash_plain` against the
    untiled `attention_ref` at the kernel tolerance of `chip_smoke.py`."""
    rng = np.random.default_rng(6)
    _, q = _both(rng.standard_normal((1, 4, 64, 64)), dtype)
    _, k = _both(rng.standard_normal((1, 2, 1000, 64)), dtype)
    _, v = _both(rng.standard_normal((1, 2, 1000, 64)) + 3.0, dtype)
    qp = torch.arange(936, 1000, dtype=torch.int32)
    kp = torch.arange(1000, dtype=torch.int32)
    got = flash_plain(q, k, v, qp, kp, scale=0.125, block_k=128)
    want = attention_ref(q, k, v, qp, kp, scale=0.125)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-5, 0.0),
                                             ("bfloat16", 2e-2, 2.0 ** -7)])
def test_flash_plain_sparse_query_positions_match_ref(dtype, atol, rtol, D):
    """128 queries at positions 0, 4, ..., 508 against 512 keys: the first
    64 rows see no key of the last two tiles, which the last 64 rows need
    (the case the kernel must compute fully masked, not skip).
    `flash_plain` with the kernel's tile against `attention_ref`."""
    rng = np.random.default_rng(9)
    _, q = _both(rng.standard_normal((1, 2, 128, D)), dtype)
    _, k = _both(rng.standard_normal((1, 2, 512, D)), dtype)
    _, v = _both(rng.standard_normal((1, 2, 512, D)) + 3.0, dtype)
    qp = 4 * torch.arange(128, dtype=torch.int32)
    kp = torch.arange(512, dtype=torch.int32)
    got = flash_plain(q, k, v, qp, kp, scale=D ** -0.5,
                      block_k=tc_block_k(D))
    want = attention_ref(q, k, v, qp, kp, scale=D ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


def test_tma_ready_copies_only_views_tma_cannot_read():
    """The bf16 route's TMA loads need 16-byte aligned bases and nested,
    positive strides that are multiples of 8 elements; other views
    (misaligned, odd strides, expanded, overlapping) get a contiguous
    copy."""
    x = torch.zeros((2, 16, 3, 4, 64), dtype=torch.bfloat16)
    fused = x[:, :, 1]                     # a split of a fused projection
    assert _tma_ready(fused) is fused
    single = torch.zeros((1, 16, 1, 64), dtype=torch.bfloat16)[:, :, :, :]
    assert _tma_ready(single) is single
    odd = torch.zeros((2, 16, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert odd.stride(-2) % 8 and _tma_ready(odd).is_contiguous()
    shifted = torch.zeros((1 + 2 * 16 * 4 * 64,),
                          dtype=torch.bfloat16)[1:].view(2, 16, 4, 64)
    assert shifted.data_ptr() % 16
    fixed = _tma_ready(shifted)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, shifted)
    kv = torch.randn((2, 16, 1, 64)).to(torch.bfloat16)
    for view in (kv.expand(2, 16, 4, 64),            # one KV head for all
                 kv[:1].expand(2, 16, 1, 64),         # one batch row for all
                 torch.zeros(4096, dtype=torch.bfloat16).as_strided(
                     (2, 16, 4, 64), (1024, 64, 8, 1))):
        assert 0 in view.stride() or view.stride(2) < 64
        copied = _tma_ready(view)
        assert copied.is_contiguous() and torch.equal(copied, view)
    assert tc_block_k(64) == tc_block_k(80) == 128 and tc_block_k(256) == 64


def test_plain_flash_attention_non_causal_ragged_matches_ref():
    """Non-causal with T=100: the Pallas wrapper pads T to 128 and then
    attends the zero keys (a known reference fault), so this case is held
    against the reference's own oracle semantics (`attention_ref`, every
    real key visible), with V offset so a padded key would show."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((1, 100, 2, 32)), "float32")
    kj, kt = _both(rng.standard_normal((1, 100, 2, 32)), "float32")
    vj, vt = _both(rng.standard_normal((1, 100, 2, 32)) + 3.0, "float32")
    pos = np.arange(100, dtype=np.int32)
    want = jax_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                   vj.transpose(0, 2, 1, 3), jnp.asarray(pos),
                   jnp.asarray(pos), scale=32 ** -0.5,
                   causal=False).transpose(0, 2, 1, 3)
    tp = torch.from_numpy(pos)
    got = flash_attention(qt, kt, vt, tp, tp, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (300, 96), (1, 1, 256),
                                   (257, 384)])
def test_plain_rmsnorm_matches_jax_kernel(dtype, shape):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal(shape), dtype)
    sj, st = _both(np.linspace(0.5, 1.5, shape[-1]), dtype)
    want = jax_rmsnorm(xj, sj)
    got = rmsnorm(xt, st)
    assert got.dtype == TDT[dtype] and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def dscale_bound(x, g, dtype):
    """Allowed |error| of each dscale element: float32 sums over the rows
    in another order (1e-5 of the sum of |g x r|, the terms' magnitudes),
    plus, in bf16, one ulp of the result (2^-7 of it)."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    mag = (gf * xf * r).abs().reshape(-1, x.shape[-1]).sum(0)
    return 1e-5 * mag, (2.0 ** -7 if dtype == "bfloat16" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (300, 96), (1, 1, 256),
                                   (257, 384), (4096, 960)])
def test_rmsnorm_backward_ref_matches_autograd_and_jax_vjp(dtype, shape):
    """`rmsnorm_bwd_ref` (the formula the backward kernel computes),
    autograd through `rmsnorm_ref`, and `jax.vjp` of the reference's
    model norm (`repro/models/layers.py:35`) agree.  dx: 2e-5 in float32,
    2e-2 plus 2^-7 relative in bf16 (each rounds an fp32 value once);
    dscale: `dscale_bound`."""
    rng = np.random.default_rng(5)
    xj, xt = _both(rng.standard_normal(shape), dtype)
    gj, gt = _both(rng.standard_normal(shape), dtype)
    sj, st = _both(1.0 + 0.3 * rng.standard_normal(shape[-1]), dtype)
    _, vjp = jax.vjp(lambda x, s: jax_layer_rmsnorm({"scale": s}, x), xj, sj)
    jdx, jds = vjp(gj)
    dx, ds = rmsnorm_bwd_ref(xt, gt, st)
    xa, sa = xt.clone().requires_grad_(), st.clone().requires_grad_()
    rmsnorm(xa, sa).backward(gt)
    assert dx.dtype == ds.dtype == TDT[dtype]
    assert dx.shape == xt.shape and ds.shape == st.shape
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    ds_atol, ds_rtol = dscale_bound(xt, gt, dtype)
    for got_dx, got_ds in ((dx, ds), (xa.grad, sa.grad)):
        np.testing.assert_allclose(got_dx.float().numpy(),
                                   np.asarray(jdx, np.float32),
                                   atol=TOL[dtype], rtol=rtol)
        want = np.asarray(jds, np.float32)
        err = np.abs(got_ds.float().numpy() - want)
        assert (err <= ds_atol.numpy() + ds_rtol * np.abs(want)).all()
    torch.testing.assert_close(dx.float(), xa.grad.float(), atol=TOL[dtype],
                               rtol=rtol)


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 16),
                                             dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 40, 2, 16),
                                              dtype=np.float32))
    pos = torch.arange(40, dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((7, 96), dtype=np.float32))
    s = torch.linspace(0.5, 1.5, 96)
    fa0, rn0 = flash_attention.launches, rmsnorm.launches
    out = flash_attention(q, kv, kv, pos, pos, window=8, softcap=30.0)
    ref = attention_ref(q.transpose(1, 2), kv.transpose(1, 2),
                        kv.transpose(1, 2), pos, pos, scale=16 ** -0.5,
                        window=8, softcap=30.0).transpose(1, 2)
    assert torch.equal(out, ref)
    assert torch.equal(rmsnorm(x, s), rmsnorm_ref(x, s))
    bw0 = rmsnorm.bwd_launches
    xg = x.clone().requires_grad_()
    rmsnorm(xg, s).sum().backward()         # autograd through the plain one
    assert (flash_attention.launches, rmsnorm.launches,
            rmsnorm.bwd_launches) == (fa0, rn0, bw0)


def test_flash_attention_wrapper_grad_flows():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 64),
                                             dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 128, 2, 64),
                                              dtype=np.float32))
    pos = torch.arange(128, dtype=torch.int32)
    q.requires_grad_()
    flash_attention(q, kv, kv, pos, pos).sum().backward()
    assert bool(torch.isfinite(q.grad).all())
    assert float(q.grad.abs().max()) > 0

