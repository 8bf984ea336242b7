"""The port's MoE block (`repro_torch.models.moe`) against the JAX
package's `route` and `moe_block_gspmd`, on reduced mixtral-8x22b and
kimi-k2 (8 experts, top 2, after `reduced`) and on kimi with 32 experts
and top 8 over 3 tokens (24 rows: at least 8 empty groups; in bf16,
many tied logits).

The same JAX-initialised expert weights (`moe_init`) and the same inputs
(numpy, from a seed) go to both.  Tolerances:
- route: the expert indices equal; weights and aux within 1e-6 in
  float32 (the same softmax of logits that differ by float32 sum order);
  in bf16 the weights within one bf16 ulp of the reference's, the aux
  (float32 arithmetic on the probabilities) within 1e-6;
- the block's output: float32 1e-4 absolute (outputs up to ~50, sums
  over d in another order); bf16 one ulp of the value plus 0.15, the
  reference's own bf16 tolerance (`tests/test_models.py`);
- float32 gradients: 1e-4 of each leaf's largest |gradient|, as
  `tests/test_torch_train.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe

BF16_ULP = 2.0 ** -7
TOL = {"float32": 1e-4, "bfloat16": 0.15}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (arch, overrides of the reduced config, (B, S) of the input)
CASES = {"mixtral": ("mixtral-8x22b", {}, (2, 40)),
         "kimi": ("kimi-k2-1t-a32b", {}, (2, 40)),
         "kimi-32x8": ("kimi-k2-1t-a32b",
                       dict(n_experts=32, experts_per_token=8), (1, 3))}


def _configs(case):
    arch, kw, _ = CASES[case]
    jcfg, tcfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    if kw:
        jcfg = dataclasses.replace(jcfg, unit=(), **kw)
        tcfg = dataclasses.replace(tcfg, unit=(), **kw)
    return jcfg, tcfg


def _setup(case, dtype, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, x as JAX, x as torch)."""
    jcfg, tcfg = _configs(case)
    jdt, tdt = DTYPES[dtype]
    jparams = jax.tree.map(lambda a: a.astype(jdt),
                           jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        CASES[case][2] + (jcfg.d_model,)).astype(np.float32)
    return (jcfg, tcfg, jparams, tparams, jnp.asarray(x, jdt),
            torch.from_numpy(x).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_jax(case, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _setup(case, dtype)
    d = jcfg.d_model
    w, idx, aux = jmoe.route(jp, jx.reshape(-1, d), jcfg)
    tw, tidx, taux = tmoe.route(tp, tx.reshape(-1, d), tcfg)
    assert tidx.shape == (jx.shape[0] * jx.shape[1], jcfg.experts_per_token)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    want = np.asarray(w, np.float32)
    got = tw.float().numpy()
    assert tw.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
    assert float(taux) == pytest.approx(float(aux), abs=1e-6)


@pytest.mark.parametrize("tied", ["top", "boundary"])
def test_route_ties_choose_the_lower_index(tied):
    """Router columns 3 and 6 equal, so the two experts' logits tie
    exactly on every token: "top" makes them the two largest (the order
    must be 3, 6), "boundary" puts them second after expert 0 with top 2
    (3 must be chosen, 6 dropped).  Both packages agree, lowest index
    first, as `jax.lax.top_k` orders them."""
    jcfg, tcfg = _configs("mixtral")
    E, d = jcfg.n_experts, jcfg.d_model
    rng = np.random.default_rng(7)
    c = np.abs(rng.standard_normal(d)).astype(np.float32) / d
    router = 0.1 * rng.standard_normal((d, E)).astype(np.float32) * c[:, None]
    router[:, 3] = router[:, 6] = 2 * c
    if tied == "boundary":
        router[:, 0] = 3 * c
    x = np.abs(rng.standard_normal((32, d))).astype(np.float32)
    router = np.asarray(jnp.asarray(router, jnp.bfloat16), np.float32)
    want_idx = [0, 3] if tied == "boundary" else [3, 6]
    for dtype, (jdt, tdt) in DTYPES.items():
        jx = jnp.asarray(x, jdt)
        tx = torch.from_numpy(x).to(tdt)
        jr = {"router": jnp.asarray(router, jdt)}
        tr = {"router": torch.from_numpy(router).to(tdt)}
        w, idx, aux = jmoe.route(jr, jx, jcfg)
        tw, tidx, taux = tmoe.route(tr, tx, tcfg)
        logits = (tx @ tr["router"]).float()
        assert torch.equal(logits[:, 3], logits[:, 6])      # an exact tie
        np.testing.assert_array_equal(np.asarray(idx),
                                      np.tile(want_idx, (32, 1)))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(
            tw.float().numpy(), np.asarray(w, np.float32),
            **({"rtol": 0, "atol": 1e-6} if dtype == "float32"
               else {"rtol": BF16_ULP, "atol": 0}))
        assert float(taux) == pytest.approx(float(aux), abs=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_jax(case, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _setup(case, dtype)
    y, aux = jmoe.moe_block_gspmd(jp, jx, jcfg)
    ty, taux = tmoe.moe_block(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    want = np.asarray(y, np.float32)
    rtol = BF16_ULP if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=rtol,
                               atol=TOL[dtype])
    assert float(taux) == pytest.approx(float(aux), abs=1e-6)
    if case == "kimi-32x8":      # 3 tokens x 8 rows over 32 experts
        groups = torch.bincount(tmoe.route(tp, tx.reshape(3, -1), tcfg)[1]
                                .reshape(-1), minlength=32)
        assert int((groups == 0).sum()) >= 8


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_gradients_match_jax(case):
    """float32 gradients of sum(y * r) + aux with respect to the input and
    every weight, against `jax.grad` of the reference."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(case, "float32")
    r = np.random.default_rng(5).standard_normal(jx.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_block_gspmd(p, x, jcfg)
        return jnp.sum(y * r) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = tx.clone().requires_grad_()
    y, aux = tmoe.moe_block(live, xt, tcfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    pairs = [(k, live[k].grad, jg_p[k]) for k in jp] + [("x", xt.grad, jg_x)]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_mm_matches_the_per_expert_loop(dtype):
    """`grouped_mm` (torch._grouped_mm) against its plain version, one
    matmul per expert, with empty groups at the ends and in the middle;
    the same bits forward, and gradients for both operands."""
    tdt = DTYPES[dtype][1]
    gen = torch.Generator().manual_seed(0)
    sizes = torch.tensor([0, 5, 0, 17, 1, 9, 0])
    x = torch.randn(int(sizes.sum()), 64, generator=gen).to(tdt)
    w = torch.randn(7, 64, 48, generator=gen).to(tdt)
    got = tmoe.grouped_mm(x, w, sizes)
    want = tmoe.grouped_mm_plain(x, w, sizes)
    assert got.dtype == tdt and got.shape == (32, 48)
    assert torch.equal(got, want)
    grads = []
    for fn in (tmoe.grouped_mm, tmoe.grouped_mm_plain):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xl, wl, sizes).float().square().sum().backward()
        grads.append((xl.grad, wl.grad))
    (gx, gw), (px, pw) = grads
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(gx, px, atol=tol, rtol=tol)
    torch.testing.assert_close(gw, pw, atol=tol, rtol=tol)
    assert float(gw[0].abs().max()) == 0.0 and float(gw[3].abs().max()) > 0
