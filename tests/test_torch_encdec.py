"""The port's encoder-decoder (`repro_torch.models.encdec`, reduced
seamless-m4t-large-v2: 2 encoder and 2 decoder layers) against the JAX
package's `repro.models.encdec`, with JAX's impl "naive".

One set of JAX-initialised weights (norm scales perturbed) goes to both
sides, in bf16, with the same source embeddings and tokens (numpy, from
a seed).  The reference's encoder runs only with bf16 params: it casts
the source embeddings to bf16, and with float32 params the unit scan's
carry turns float32 after the first unit, which `lax.scan` refuses.
Tolerance, as `tests/test_torch_model.py`: 0.15 (the reference's own
bf16 tolerance) on logits, encoder states and the cross K/V that
`prefill_cross` stores (values O(1), a few bf16 ulps apart: 0.031 seen).

The cross-attention RoPE divergence (ROADMAP Queue 3) is mirrored: the
teacher-forced forward rotates the cross query, decode does not, in both
packages.  `test_decode_minus_forward_matches_the_reference` pins it:
decode minus forward is 0 at position 0 and, after it, equals the
reference's own divergence within 0.15.

The train step is held to the reference's in bf16 for the same reason
(`test_train_step_matches_jax_bfloat16`), and the bf16 loss check of
`test_torch_train_step.py` runs here for seamless.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.models import param_count as jax_param_count
from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import build_optimizer as jax_build_optimizer
from repro.runtime.train import TrainConfig as JTrainConfig
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.models import build_model, encdec, param_count
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.train import TrainConfig, make_train_step

import test_torch_train_step
from _torch_parity import (both_params, configs, flat_jax, flat_torch,
                           numpy_params, train_batch)

ARCH = "seamless-m4t-large-v2"
B, S, S_SRC = 2, 24, 20
TOL = 0.15
IMPLS = ["naive", "chunked", "kernel", "auto"]
_CACHE = {}


def _setup():
    """Port config and bf16 params, JAX config and bf16 params, numpy
    source embeddings and decoder tokens, and the JAX encoder states and
    logits (impl "naive"), once per process."""
    if not _CACHE:
        jcfg, tcfg = configs(ARCH)
        jparams, tparams = both_params(numpy_params(jcfg), "bfloat16")
        rng = np.random.default_rng(1)
        src = rng.standard_normal((B, S_SRC, jcfg.d_model)).astype(
            np.float32)
        toks = rng.integers(0, jcfg.vocab_size, (B, S))
        jsrc, jtoks = jnp.asarray(src), jnp.asarray(toks, jnp.int32)
        enc = jencdec.encode(jparams, jsrc, jcfg, impl="naive", remat=False)
        logits, _ = jencdec.forward(jparams, jsrc, jtoks, jcfg,
                                    impl="naive", remat=False)
        _CACHE.update(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                      tparams=tparams, src=src, toks=toks,
                      enc=np.asarray(enc, np.float32),
                      logits=np.asarray(logits))
    return _CACHE


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(impl):
    """The non-causal encoder; S_SRC = 20 keys, all visible to every
    query (the port's attention masks no key by position here)."""
    st = _setup()
    with torch.no_grad():
        got = encdec.encode(st["tparams"], torch.from_numpy(st["src"]),
                            st["tcfg"], impl=impl, remat=False)
    assert got.shape == (B, S_SRC, st["tcfg"].d_model)
    np.testing.assert_allclose(got.float().numpy(), st["enc"], atol=TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_jax(impl):
    """Teacher-forced forward through `build_model` (the facade's enc-dec
    branch): causal self-attention, then cross-attention with S = 24
    queries against S_SRC = 20 keys."""
    st = _setup()
    model = build_model(st["tcfg"], impl=impl, remat=False, device="cpu")
    with torch.no_grad():
        got, aux = model.apply(st["tparams"], {
            "src_embeds": torch.from_numpy(st["src"]),
            "tokens": torch.from_numpy(st["toks"])})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), st["logits"], atol=TOL)


def test_prefill_cross_matches_jax():
    st = _setup()
    jcache = jencdec.init_cache(st["jcfg"], B, 8, 1024)
    want = jencdec.prefill_cross(st["jparams"], jnp.asarray(st["src"]),
                                 st["jcfg"], jcache)
    model = build_model(st["tcfg"], remat=False, device="cpu")
    tcache = model.init_cache(B, 8)            # src_len 1024 by default
    assert tcache["cross"]["k"].shape == jcache["cross"]["k"].shape
    with torch.no_grad():
        got = encdec.prefill_cross(st["tparams"], torch.from_numpy(st["src"]),
                                   st["tcfg"], tcache)
    assert got["self"] is tcache["self"]
    for name in ("k", "v"):
        g, w = got["cross"][name], np.asarray(want["cross"][name], np.float32)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL)


def _decode_both(st, steps):
    """bf16 decode after `prefill_cross`, JAX and port, fed the same
    tokens; returns the per-step logits (steps, B, V) of each."""
    jcfg, tcfg = st["jcfg"], st["tcfg"]
    jmodel = jax_build_model(jcfg, impl="naive", remat=False)
    jcache = jencdec.prefill_cross(st["jparams"], jnp.asarray(st["src"]),
                                   jcfg, jmodel.init_cache(B, steps + 1))
    jdec = jax.jit(jmodel.decode)
    tmodel = build_model(tcfg, impl="naive", remat=False, device="cpu")
    tcache = encdec.prefill_cross(st["tparams"], torch.from_numpy(st["src"]),
                                  tcfg, tmodel.init_cache(B, steps + 1),
                                  impl="naive")
    jout, tout = [], []
    for t in range(steps):
        tok = st["toks"][:, t:t + 1]
        jl, jcache = jdec(st["jparams"], jcache, jnp.asarray(tok, jnp.int32),
                          jnp.int32(t))
        with torch.no_grad():
            tl, tcache = tmodel.decode(st["tparams"], tcache,
                                       torch.from_numpy(tok), t)
        jout.append(np.asarray(jl)[:, 0])
        tout.append(tl[:, 0].numpy())
    return np.stack(jout), np.stack(tout)


def test_decode_step_matches_jax():
    """Token-by-token decode (bf16: the JAX decode path needs bf16
    params) against the cross K/V of the encoded source."""
    st = _setup()
    jout, tout = _decode_both(st, S)
    np.testing.assert_allclose(tout, jout, atol=TOL)


def test_decode_minus_forward_matches_the_reference():
    """The mirrored RoPE divergence: the port's decode minus its own
    forward is 0 at position 0 (within the bf16 tolerance) and, after
    it, equals the reference's decode minus its forward; the reference's
    own divergence is real (far above the tolerance)."""
    st = _setup()
    jout, tout = _decode_both(st, S)
    model = build_model(st["tcfg"], impl="naive", remat=False, device="cpu")
    with torch.no_grad():
        own, _ = model.apply(st["tparams"], {
            "src_embeds": torch.from_numpy(st["src"]),
            "tokens": torch.from_numpy(st["toks"])})
    port_div = tout - own.numpy().transpose(1, 0, 2)
    jax_div = jout - st["logits"].transpose(1, 0, 2)
    tol = TOL
    assert np.abs(port_div[0]).max() < tol
    assert np.abs(jax_div[0]).max() < tol
    assert np.abs(jax_div[1:]).max(axis=(1, 2)).min() > 2 * tol
    np.testing.assert_allclose(port_div[1:], jax_div[1:], atol=tol)


def test_param_count_matches_jax():
    st = _setup()
    assert param_count(st["tparams"]) == jax_param_count(st["jparams"])
    assert st["tcfg"].param_count() == st["jcfg"].param_count()
    own = build_model(st["tcfg"], remat=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(own) == jax_param_count(st["jparams"])


def test_train_step_matches_jax_bfloat16():
    """One AdamW step (`make_train_step`, the data pipeline's batch) with
    bf16 params against the reference's: the loss within 0.01 (the bf16
    loss tolerance of `test_torch_train_step.py`); every updated weight
    within two steps (2.2 lr: a gradient near zero may take the other
    sign) plus one bf16 ulp of the weight; the float32 first moments
    (0.1 x the bf16 gradient) per leaf within 0.1 of the leaf's largest
    (bf16 gradients through 4 layers; seen: 0.039)."""
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = both_params(numpy_params(jcfg), "bfloat16")
    jb, tb = train_batch(tcfg, 40, B, "bfloat16")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep, _ = jax_make_train_step(jcfg, JTrainConfig(
        optimizer=JOptimizerConfig(**opt), remat=False))
    jnew, jm = jax.jit(jstep)({
        "params": jparams,
        "opt": jax_build_optimizer(JOptimizerConfig(**opt)).init(jparams),
        "step": jnp.zeros((), jnp.int32)}, jb)
    step_fn, _ = make_train_step(tcfg, TrainConfig(
        optimizer=OptimizerConfig(**opt), remat=False), "cpu")
    new, m = step_fn({
        "params": tparams,
        "opt": build_optimizer(OptimizerConfig(**opt)).init(tparams),
        "step": torch.zeros((), dtype=torch.int32)}, tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 0.01
    assert int(new["step"]) == 1
    want, got, old = (flat_jax(jnew["params"]), flat_torch(new["params"]),
                      flat_jax(jparams))
    assert got.keys() == want.keys()
    for name in want:
        bound = 2.2 * opt["lr"] + 2.0 ** -7 * np.abs(old[name])
        assert (np.abs(got[name] - want[name]) <= bound).all(), name
    want, got = flat_jax(jnew["opt"]), flat_torch(new["opt"])
    assert got.keys() == want.keys()
    for name in want:
        if name.startswith("mu/"):
            np.testing.assert_allclose(
                got[name], want[name], rtol=0,
                atol=0.1 * np.abs(want[name]).max(), err_msg=name)


def test_bf16_loss_matches_jax():
    test_torch_train_step.test_bf16_loss_matches_jax(ARCH)
