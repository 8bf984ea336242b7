"""The port's Mamba2 module (`repro_torch.models.ssm`) against the JAX
package's (`repro.models.ssm`) on reduced mamba2-130m (d_model 64,
8 SSM heads x 16, state 16, chunk 16).

One block's JAX-initialised weights (biases and norm scale perturbed) go
to both sides; inputs come from numpy with a seed.  Both sides run op by
op here, so they round at the same places.  Tolerances: float32 1e-5
(the same fp32 arithmetic, sums in another order); bfloat16 2e-2 plus
one ulp relative (2^-7) where an fp32 result is rounded once, and the
same for the bf16 state a decode step stores.  Routes pair like with
like: the port's "kernel" (the SSD wrapper; its plain version on the
CPU) against JAX's "pallas" (the Pallas kernel in interpret mode), and
"naive" against "naive".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

from _torch_parity import both_params, configs, numpy_params

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
B, L = 2, 40          # L = 2.5 chunks: the plain route pads, the kernel's
                      # route takes a ragged last chunk

_STATE = {}


def _setup(dtype):
    """(JAX cfg, port cfg, JAX block params, port block params)."""
    if dtype not in _STATE:
        jcfg, tcfg = configs("mamba2-130m")
        jparams, tparams = both_params(numpy_params(jcfg, seed=7), dtype)
        jp = jax.tree.map(lambda a: a[0], jparams["units"]["b0"]["mamba"])
        tp = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv
                                                   in v.items()})
              for k, v in tparams["units"]["b0"]["mamba"].items()}
        _STATE[dtype] = (jcfg, tcfg, jp, tp)
    return _STATE[dtype]


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    jcfg, _, jp, tp = _setup(dtype)
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((B, L, tp["conv_w"].shape[1])),
                   dtype)
    want = jssm._causal_conv(xj, jp["conv_w"], jp["conv_b"])
    got = tssm._causal_conv(xt, tp["conv_w"], tp["conv_b"])
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


def test_segsum_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 4, 12)).astype(
        np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_jax(dtype):
    """Three chunks of 16 from a given initial state; y and the final
    state."""
    rng = np.random.default_rng(3)
    H, P, N = 4, 8, 16
    xj, xt = _both(0.5 * rng.standard_normal((B, 48, H, P)), dtype)
    dt = np.logaddexp(rng.standard_normal((B, 48, H)), 0.0)
    A = -np.exp(0.3 * rng.standard_normal(H))
    Bj, Bt = _both(0.5 * rng.standard_normal((B, 48, N)), dtype)
    Cj, Ct = _both(0.5 * rng.standard_normal((B, 48, N)), dtype)
    s0j, s0t = _both(rng.standard_normal((B, H, P, N)), dtype)
    dtj, dtt = _both(dt, "float32")
    Aj, At = _both(A, "float32")
    yj, sj = jssm.ssd_scan(xj, dtj, Aj, Bj, Cj, 16, init_state=s0j)
    yt, st = tssm.ssd_scan(xt, dtt, At, Bt, Ct, 16, init_state=s0t)
    assert yt.dtype == st.dtype == TDT[dtype]
    _close(yt, yj, dtype)
    _close(st, sj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,jax_impl", [("naive", "naive"),
                                           ("chunked", "naive"),
                                           ("kernel", "pallas"),
                                           ("auto", "pallas")])
def test_mamba_block_matches_jax(impl, jax_impl, dtype):
    jcfg, tcfg, jp, tp = _setup(dtype)
    xj, xt = _both(np.random.default_rng(4).standard_normal(
        (B, L, jcfg.d_model)), dtype)
    want = jssm.mamba_block(jp, xj, jcfg, impl=jax_impl)
    got = tssm.mamba_block(tp, xt, tcfg, impl=impl)
    assert got.dtype == TDT[dtype] and got.shape == (B, L, jcfg.d_model)
    _close(got, want, dtype)


def test_init_ssm_cache_shapes_and_dtypes():
    _, tcfg, _, _ = _setup("float32")
    cache = tssm.init_ssm_cache(tcfg, 3, "cpu")
    conv_dim = tcfg.d_inner + 2 * tcfg.ssm_state
    assert cache["conv"].shape == (3, tcfg.d_conv - 1, conv_dim)
    assert cache["state"].shape == (3, tcfg.n_ssm_heads, tcfg.ssm_head_dim,
                                    tcfg.ssm_state)
    assert cache["conv"].dtype == cache["state"].dtype == torch.bfloat16
    assert not cache["conv"].any() and not cache["state"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mamba_matches_jax_over_steps(dtype):
    """Eight single-token steps from an empty cache: each step's output
    and the bf16 cache it leaves behind (the port writes it in place)."""
    jcfg, tcfg, jp, tp = _setup(dtype)
    rng = np.random.default_rng(5)
    jcache = jssm.init_ssm_cache(jcfg, B)
    tcache = tssm.init_ssm_cache(tcfg, B, "cpu")
    for _ in range(8):
        xj, xt = _both(rng.standard_normal((B, 1, jcfg.d_model)), dtype)
        want, jcache = jssm.decode_mamba(jp, xj, jcache, jcfg)
        got, same = tssm.decode_mamba(tp, xt, tcache, tcfg, impl="naive")
        assert same is tcache
        _close(got, want, dtype)
        for k in ("conv", "state"):
            assert tcache[k].dtype == torch.bfloat16
            _close(tcache[k], jcache[k], "bfloat16")


def test_decode_mamba_continues_the_forward_pass():
    """Decoding token by token reproduces the block's full-sequence output
    (fp32 params; the cache rounds the state to bf16 each step, hence
    the bf16 tolerance)."""
    _, tcfg, _, tp = _setup("float32")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 24, tcfg.d_model)).astype(np.float32))
    full = tssm.mamba_block(tp, x, tcfg, impl="naive")
    cache = tssm.init_ssm_cache(tcfg, B, "cpu")
    steps = [tssm.decode_mamba(tp, x[:, t:t + 1], cache, tcfg,
                               impl="naive")[0] for t in range(24)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=5e-2)
