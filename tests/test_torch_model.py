"""The port's model against the JAX package on reduced configs: the
dense archs, the Mamba2 SSM, the zamba2 hybrid, the MoE models (mixtral,
kimi) and pixtral's decoder fed embeddings.

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

from _torch_parity import (PARITY_ARCHS, both_params, configs, inputs,
                           numpy_params, recorded_routes, route_flips)

B, S = 2, 40           # S > 32: the reduced gemma2 window is exercised
DENSE = ("smollm-360m", "gemma2-2b", "chatglm3-6b", "qwen2.5-32b")
SSM = ("mamba2-130m", "zamba2-2.7b")
MOE_VLM = ("mixtral-8x22b", "kimi-k2-1t-a32b", "pixtral-12b")
TOL = {"float32": 1e-4, "bfloat16": 0.15}
BF16_TOL = {"zamba2-2.7b": 0.5}
DECODE_TOL = {"zamba2-2.7b": 0.75}

_CACHE = {}
#: at most this share of the (batch, position) rows may change experts
#: between the two packages in bf16 (a route flips where two experts'
#: probabilities sit within the two frameworks' rounding difference);
#: those rows' logits are left out of the comparison, the rest compared
MAX_FLIP_SHARE = 0.1


def _jax_input(toks):
    """Token ids as int32, embeddings as float32 (the model casts them)."""
    return jnp.asarray(toks, jnp.float32 if toks.ndim == 3 else jnp.int32)


def _setup(arch, dtype, jax_impl="naive"):
    """Port config and params, the inputs (token ids, or embeddings for
    pixtral in bf16) and their name, and the JAX params, config, logits,
    aux and MoE routes (one (B*S, K) array a layer), once per process."""
    key = (arch, dtype, jax_impl)
    if key not in _CACHE:
        jcfg, tcfg = configs(arch)
        jparams, tparams = both_params(numpy_params(jcfg), dtype)
        name, toks = inputs(jcfg, B, S, dtype)
        with recorded_routes() as (routes, _):
            logits, aux = jax_build_model(jcfg, impl=jax_impl,
                                          remat=False).apply(
                jparams, {name: _jax_input(toks)})
            jax.effects_barrier()
        _CACHE[key] = dict(tcfg=tcfg, tparams=tparams, toks=toks, name=name,
                           logits=np.asarray(logits), jparams=jparams,
                           jcfg=jcfg, aux=float(aux), routes=list(routes))
    return _CACHE[key]


def _agree(got, want, flips, tol, what):
    """Logits (B, S, V) or (B, V) agree within tol where `flips` (B, S) or
    (B,) is False; returns the number of rows left out."""
    err = np.abs(got - want).max(-1)
    assert (err[~flips] < tol).all(), (what, float(err[~flips].max()))
    return int(flips.sum())


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel", "auto"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + SSM + MOE_VLM)
def test_forward_logits_match_jax(arch, dtype, impl):
    """Forward logits; on the MoE archs also the aux loss (float32 1e-5,
    bf16 0.01, the bf16 loss tolerance of `test_torch_train_step.py`,
    which a flipped route moves by ~1e-3) and the routes: identical in
    float32, and in bf16 the rows whose routes agree are compared."""
    jax_impl = ("pallas" if arch in SSM and impl in ("kernel", "auto")
                else "naive")
    st = _setup(arch, dtype, jax_impl)
    model = build_model(st["tcfg"], impl=impl, remat=False, device="cpu")
    with recorded_routes() as (_, routes), torch.no_grad():
        got, aux = model.apply(st["tparams"],
                               {st["name"]: torch.from_numpy(st["toks"])})
    want = st["logits"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the MoE load-balancing loss summed over the layers; 0 elsewhere
    assert (float(aux) == 0.0) == (arch not in MOE_VLM[:2])
    assert float(aux) == pytest.approx(
        st["aux"], abs=1e-5 if dtype == "float32" else 0.01)
    flips = route_flips(st["routes"], routes, (B, S))
    if dtype == "float32":
        assert not flips.any()
    tol = TOL[dtype]
    if dtype == "bfloat16":
        tol = BF16_TOL.get(arch, tol)
    n = _agree(got.numpy(), want, flips, tol, "forward")
    assert n <= MAX_FLIP_SHARE * B * S, n


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_decode_logits_match_jax(arch):
    """Token-by-token decode with bf16 params, S steps from an empty cache;
    smollm-swa8 (window 8) and gemma2 (window 32) wrap the ring buffer,
    the SSM archs carry their conv window and state (zamba2, the
    slowest to decode, over 20 steps), and the MoE archs route each
    step's tokens.  Each pair of runs compares the rows whose routes
    agree (`_agree`)."""
    st = _setup(arch, "bfloat16")
    tparams, toks, name = st["tparams"], st["toks"], st["name"]
    steps = 20 if arch in ("smollm-swa8", "zamba2-2.7b") else S
    jmodel = jax_build_model(st["jcfg"], impl="naive", remat=False)
    jdec = jax.jit(jmodel.decode)
    jcache = jmodel.init_cache(B, steps + 1)
    tmodel = build_model(st["tcfg"], impl="naive", remat=False, device="cpu")
    tcache = tmodel.init_cache(B, steps + 1)
    with recorded_routes() as (_, own_routes), torch.no_grad():
        own, _ = tmodel.apply(tparams, {name: torch.from_numpy(toks)})
    n_moe = len(own_routes)

    def at(routes, t):          # forward routes of position t, per layer
        return [r.reshape(B, S, -1)[:, t] for r in routes]

    tol = DECODE_TOL.get(arch, 0.15)
    flipped = {"decode": 0, "forward": 0, "own": 0}
    # one recording over the loop: the jitted decode keeps the callback
    # it was traced with; each step appends n_moe routes to each list
    with recorded_routes() as (jlog, tlog):
        for t in range(steps):
            jl, jcache = jdec(st["jparams"], jcache,
                              _jax_input(toks[:, t:t + 1]), jnp.int32(t))
            jax.effects_barrier()
            with torch.no_grad():
                tl, tcache = tmodel.decode(
                    tparams, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            jr, tr = jlog[t * n_moe:], tlog[t * n_moe:]
            assert len(jr) == len(tr) == n_moe
            tl = tl[:, 0].numpy()
            flipped["decode"] += _agree(tl, np.asarray(jl)[:, 0],
                                        route_flips(jr, tr, (B,)), tol,
                                        "decode")
            # decode reproduces forward, the reference's and the port's own
            flipped["forward"] += _agree(
                tl, st["logits"][:, t],
                route_flips(at(st["routes"], t), tr, (B,)), tol,
                "decode vs forward")
            flipped["own"] += _agree(
                tl, own[:, t].numpy(), route_flips(at(own_routes, t), tr,
                                                   (B,)), tol,
                "decode vs own forward")
    for what, n in flipped.items():
        assert n <= MAX_FLIP_SHARE * B * steps, (what, n)


@pytest.mark.parametrize("arch", DENSE + SSM + MOE_VLM)
def test_param_count_matches_jax(arch):
    st = _setup(arch, "bfloat16")
    tcfg, tparams, jparams, jcfg = (st["tcfg"], st["tparams"],
                                    st["jparams"], st["jcfg"])
    assert param_count(tparams) == jax_param_count(jparams)
    assert tcfg.param_count() == jcfg.param_count()
    own = build_model(tcfg, remat=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(own) == jax_param_count(jparams)


def test_remat_forward_matches_and_backpropagates():
    """remat=True recomputes each unit in the backward pass
    (torch.utils.checkpoint, where the reference uses jax.checkpoint)."""
    st = _setup("smollm-360m", "float32")
    tcfg, tparams, toks = st["tcfg"], st["tparams"], st["toks"]
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


def test_ssm_config_built_by_hand_initialises():
    """A Mamba2 config made directly (not through `reduced`) builds its
    parameter tree: stacked (n_units, n_ssm_heads) A_log."""
    from repro_torch.configs.base import ModelConfig
    ssm = ModelConfig(name="s", family="ssm", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
                      ssm_state=16, ssm_head_dim=16)
    params = build_model(ssm, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(params) > 0
    assert params["units"]["b0"]["mamba"]["A_log"].shape == (2, 8)


@pytest.mark.parametrize("n", [1, 3])
def test_stack_fills_units_as_they_are_made(n):
    """`transformer._stack` makes the units in order and gives what
    `torch.stack` of the same units gives (n = 1 as a view of the one
    unit), leaf for leaf."""
    from repro_torch.models.transformer import _stack

    def units(gen):
        return lambda: {"a": torch.randn(3, generator=gen),
                        "b": {"c": torch.randn(2, 4, generator=gen)}}

    got = _stack(units(torch.Generator().manual_seed(0)), n)
    make = units(torch.Generator().manual_seed(0))
    made = [make() for _ in range(n)]
    assert torch.equal(got["a"], torch.stack([u["a"] for u in made]))
    assert torch.equal(got["b"]["c"],
                       torch.stack([u["b"]["c"] for u in made]))
