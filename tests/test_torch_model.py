"""The port's model against the JAX package on reduced configs: the
dense archs, the Mamba2 SSM and the zamba2 hybrid.

One set of JAX-initialised weights per arch goes to both sides (biases,
norm scales and the Mamba skip and dt/conv biases perturbed so they
matter).  Routes are paired like with like: for the SSM archs the port's
"kernel"/"auto" (the SSD kernel's route) meets JAX's "pallas", and
"naive"/"chunked" meet JAX's "naive" (in bf16 the two scans round at
different places).  Tolerances:
- float32 params, forward logits: 1e-4 (the same arithmetic in fp32, sums
  in another order; logits are O(1-10));
- bfloat16 params, forward and decode logits: 0.15, the reference's own
  bf16 tolerance (`tests/test_models.py`: a few bf16 ulps of the ~[2, 4)
  logit binade);
- zamba2 in bf16: 0.5 forward, 0.75 decode.  Its Mamba block matches JAX
  op by op (`tests/test_torch_ssm.py`), but XLA fuses the scanned body
  and skips some bf16 roundings, and 14 blocks amplify the difference:
  JAX's own "naive" and "pallas" routes differ by 0.27 on these weights
  and inputs, and the port sits about as far from either; 0.75 is the
  reference's zamba2 decode tolerance (recurrent state drift).
The JAX decode path runs only with bf16 params (its KV cache is bf16 and
its cache update refuses an fp32 key), so decode is compared in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import param_count as jax_param_count
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, param_count

from _torch_parity import PARITY_ARCHS, both_params, configs, numpy_params

B, S = 2, 40           # S > 32: the reduced gemma2 window is exercised
DENSE = ("smollm-360m", "gemma2-2b", "chatglm3-6b", "qwen2.5-32b")
SSM = ("mamba2-130m", "zamba2-2.7b")
TOL = {"float32": 1e-4, "bfloat16": 0.15}
BF16_TOL = {"zamba2-2.7b": 0.5}
DECODE_TOL = {"zamba2-2.7b": 0.75}

_CACHE = {}


def _setup(arch, dtype, jax_impl="naive"):
    """(port config, port params, tokens, JAX logits), once per process."""
    key = (arch, dtype, jax_impl)
    if key not in _CACHE:
        jcfg, tcfg = configs(arch)
        jparams, tparams = both_params(numpy_params(jcfg), dtype)
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
        logits, _ = jax_build_model(jcfg, impl=jax_impl,
                                    remat=False).apply(
            jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
        _CACHE[key] = (tcfg, tparams, toks, np.asarray(logits), jparams,
                       jcfg)
    return _CACHE[key]


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel", "auto"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + SSM)
def test_forward_logits_match_jax(arch, dtype, impl):
    jax_impl = ("pallas" if arch in SSM and impl in ("kernel", "auto")
                else "naive")
    tcfg, tparams, toks, want, _, _ = _setup(arch, dtype, jax_impl)
    model = build_model(tcfg, impl=impl, remat=False, device="cpu")
    with torch.no_grad():
        got, aux = model.apply(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == 0.0
    tol = TOL[dtype]
    if dtype == "bfloat16":
        tol = BF16_TOL.get(arch, tol)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_decode_logits_match_jax(arch):
    """Token-by-token decode with bf16 params, S steps from an empty cache;
    smollm-swa8 (window 8) and gemma2 (window 32) wrap the ring buffer,
    and the SSM archs carry their conv window and state (zamba2, the
    slowest to decode, over 20 steps)."""
    tcfg, tparams, toks, full, jparams, jcfg = _setup(arch, "bfloat16")
    steps = 20 if arch in ("smollm-swa8", "zamba2-2.7b") else S
    jmodel = jax_build_model(jcfg, impl="naive", remat=False)
    jdec = jax.jit(jmodel.decode)
    jcache = jmodel.init_cache(B, steps + 1)
    tmodel = build_model(tcfg, impl="naive", remat=False, device="cpu")
    tcache = tmodel.init_cache(B, steps + 1)
    with torch.no_grad():
        own, _ = tmodel.apply(tparams, {"tokens": torch.from_numpy(toks)})
    errs, self_errs, own_errs = [], [], []
    for t in range(steps):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, t:t + 1],
                                                       jnp.int32),
                          jnp.int32(t))
        with torch.no_grad():
            tl, tcache = tmodel.decode(tparams, tcache,
                                       torch.from_numpy(toks[:, t:t + 1]), t)
        errs.append(float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        self_errs.append(float(np.abs(tl[:, 0].numpy() - full[:, t]).max()))
        own_errs.append(float((tl[:, 0] - own[:, t]).abs().max()))
    tol = DECODE_TOL.get(arch, 0.15)
    assert max(errs) < tol, errs
    assert max(self_errs) < tol, self_errs   # decode reproduces forward
    assert max(own_errs) < tol, own_errs     # ... the port's own, too


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_param_count_matches_jax(arch):
    tcfg, tparams, _, _, jparams, jcfg = _setup(arch, "bfloat16")
    assert param_count(tparams) == jax_param_count(jparams)
    assert tcfg.param_count() == jcfg.param_count()
    own = build_model(tcfg, remat=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(own) == jax_param_count(jparams)


def test_remat_forward_matches_and_backpropagates():
    """remat=True recomputes each unit in the backward pass
    (torch.utils.checkpoint, where the reference uses jax.checkpoint)."""
    tcfg, tparams, toks, _, _, _ = _setup("smollm-360m", "float32")
    inputs = {"tokens": torch.from_numpy(toks)}
    grads = []
    for remat in (False, True):
        params = {"embed": {"table": tparams["embed"]["table"].clone()
                            .requires_grad_()}, **{k: v for k, v in
                                                   tparams.items()
                                                   if k != "embed"}}
        model = build_model(tcfg, impl="naive", remat=remat, device="cpu")
        logits, _ = model.apply(params, inputs)
        logits.square().mean().backward()
        grads.append(params["embed"]["table"].grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_over_several_chunks_matches_jax(causal):
    """chunk=16 over T=40: two full chunks and a short one (the reference
    pads it; non-causal is held against naive attention, since the
    reference's padded keys stay visible there)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 40, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 40, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 40, 2, 16), dtype=np.float32) + 3.0
    pos = np.arange(40, dtype=np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    window = 8 if causal else None
    got = tattn.sdpa_chunked(*targs, window, 30.0, 0.25, chunk=16,
                             causal=causal)
    if causal:
        want = jattn.sdpa_chunked(*jargs, window, 30.0, 0.25, chunk=16)
    else:
        want = jattn.sdpa_naive(*jargs, None, 30.0, 0.25, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("pos", [0, 5, 7, 8, 13, 16, 23])
def test_ring_positions_match_reference(pos):
    """Slot -> absolute position map of the decode ring buffer (L=8),
    bit for bit, against the reference's formula."""
    L = 8
    slots = jnp.arange(L, dtype=jnp.int32)
    wrap = (pos // L) * L
    want = jnp.where(slots <= pos % L, wrap + slots, wrap - L + slots)
    want = jnp.where(want < 0, jnp.iinfo(jnp.int32).max, want)
    got = tattn.ring_positions(pos, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_units_raise():
    from repro_torch.configs import reduced
    from repro_torch.configs.base import ModelConfig
    moe = reduced(ModelConfig(name="m", family="moe", n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              vocab_size=256, n_experts=4,
                              experts_per_token=2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        build_model(moe, device="cpu")
    ssm = ModelConfig(name="s", family="ssm", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
                      ssm_state=16, ssm_head_dim=16)
    params = build_model(ssm, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(params) > 0
    assert params["units"]["b0"]["mamba"]["A_log"].shape == (2, 8)
