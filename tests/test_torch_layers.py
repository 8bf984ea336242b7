"""Port layer primitives against `repro.models.layers`, on the CPU.

Inputs and weights are numpy arrays from a seed, given to both sides.
float32 tolerance 1e-5: the same formula, sums in another order.
bfloat16 tolerance: one bf16 ulp of the output (relative 2^-7), since
each side rounds an fp32 intermediate to bf16 at the same places and may
land one ulp apart.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import layers as jl
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import layers as tl

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got, want, dtype, atol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches(dtype, fraction):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, 9, 3, 16)), dtype)
    pos = np.arange(3, 12, dtype=np.int32)
    cj, sj = jl.rope_frequencies(16, fraction, 1e4, jnp.asarray(pos))
    ct, st = tl.rope_frequencies(16, fraction, 1e4, torch.from_numpy(pos))
    assert ct.shape == cj.shape == (9, int(16 * fraction) // 2)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    want = jl.apply_rope(xj, cj, sj, fraction)
    got = tl.apply_rope(xt, ct, st, fraction)
    _close(got, want, dtype)
    if fraction < 1.0:       # the unrotated tail passes through unchanged
        assert torch.equal(got[..., 8:], xt[..., 8:])


def test_rope_rotates_interleaved_pairs():
    """Pair (x0, x1) at position 1 rotates by angle 1 (inv freq 1)."""
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0
    c, s = tl.rope_frequencies(4, 1.0, 1e4, torch.tensor([1]))
    y = tl.apply_rope(x, c, s)
    np.testing.assert_allclose(y[0, 0, 0, :2].numpy(),
                               [np.cos(1.0), np.sin(1.0)], atol=1e-6)
    assert float(y[0, 0, 0, 2:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["silu", "geglu", "gelu"])
def test_mlp_matches(dtype, activation):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 5, 32)), dtype)
    pj, pt = {}, {}
    for name, shape in (("w_up", (32, 48)), ("w_down", (48, 32)),
                        ("w_gate", (32, 48))):
        if name == "w_gate" and activation == "gelu":
            continue
        pj[name], pt[name] = _both(rng.standard_normal(shape) * 0.2, dtype)
    want = jl.mlp(pj, xj, activation)
    got = tl.mlp(pt, xt, activation)
    _close(got, want, dtype, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_layer_matches(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal((3, 7, 64)), dtype)
    sj, st = _both(np.linspace(0.5, 1.5, 64), dtype)
    want = jl.rmsnorm({"scale": sj}, xj, 1e-6)
    for impl in ("auto", "kernel", "naive"):
        _close(tl.rmsnorm({"scale": st}, xt, 1e-6, impl), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,softcap", [("smollm-360m", None),
                                          ("gemma2-2b", 30.0),
                                          ("qwen2.5-32b", None)])
def test_embed_unembed_match(dtype, arch, softcap):
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch]),
                               final_softcap=softcap)
    tcfg = dataclasses.replace(reduced(ARCHS[arch]), final_softcap=softcap)
    rng = np.random.default_rng(3)
    V, d = jcfg.vocab_size, jcfg.d_model
    pj, pt = {}, {}
    pj["table"], pt["table"] = _both(rng.standard_normal((V, d)) * 0.1,
                                     dtype)
    if not jcfg.tie_embeddings:
        pj["unembed"], pt["unembed"] = _both(
            rng.standard_normal((d, V)) * 0.1, dtype)
    toks = rng.integers(0, V, (2, 6))
    ej = jl.embed(pj, jnp.asarray(toks), jcfg)
    et = tl.embed(pt, torch.from_numpy(toks), tcfg)
    _close(et, ej, dtype)
    want = jl.unembed(pj, ej, jcfg)
    got = tl.unembed(pt, et, tcfg)
    assert got.dtype == torch.float32
    _close(got, want, dtype, atol=1e-4)


def test_embed_scale_rounds_to_activation_dtype():
    """sqrt(960) = 30.98...; the reference multiplies bf16 rows by 31.0."""
    cfg = ARCHS["smollm-360m"]
    table = torch.ones((4, cfg.d_model), dtype=torch.bfloat16)
    x = tl.embed({"table": table}, torch.tensor([[1]]), cfg)
    assert float(x[0, 0, 0]) == 31.0


@pytest.mark.parametrize("shape,axis", [((384, 16, 8), 0), ((64, 48), 0),
                                        ((256, 64), 1), ((5,), 0)])
def test_dense_init_scales_in_place_to_the_same_bits(shape, axis):
    """`_dense_init` scales its fp32 draw in place (one fp32 tensor, not
    two, at the peak: 22.5 GB less for a kimi expert stack); the result
    is the bits of the out-of-place `(w * scale).to(bf16)` from the same
    generator state."""
    got = tl._dense_init(torch.Generator().manual_seed(3), shape, axis)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float32)
    want = (w * (1.0 / np.sqrt(max(1, shape[axis])))).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert torch.equal(got, want)
