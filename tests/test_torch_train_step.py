"""The port's whole `train_step` against the JAX package's
`make_train_step` (microbatches, compression, both loss forms), the
bf16 loss per reduced arch, and the port's own invariants: gradient
dtypes, microbatch accumulation, remat and the two CE forms.

Tolerances (float32 unless said): loss and ce 1e-5 relative; updated
params 1e-4 absolute where the gradient's sign is settled, and at most
one step elsewhere (the reasons are in `test_torch_train.py`); optimizer
state 1e-6.  In bfloat16 the loss agrees to 0.01 (seen: <= 0.002, at
chatglm3 and zamba2): both packages round activations to bf16 at the
same points op by op, but XLA fuses and skips some of those roundings,
and the forward logits already differ by up to 0.15 (`test_torch_model`);
the CE averages 80 tokens of such logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import build_optimizer as jax_build_optimizer
from repro.runtime.compression import CompressionConfig as JCompression
from repro.runtime.train import TrainConfig as JTrainConfig
from repro.runtime.train import cross_entropy as jax_cross_entropy
from repro.runtime.train import make_loss_fn as jax_make_loss_fn
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.compression import CompressionConfig
from repro_torch.runtime.train import (TrainConfig, compute_grads,
                                       cross_entropy, make_loss_fn,
                                       make_train_step, value_and_grad)
from repro_torch.tree import leaves, named_leaves

from _torch_parity import (PARITY_ARCHS, both_params, configs, flat_jax,
                           flat_torch, numpy_params, train_batch)

B, S = 2, 40
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
BF16_LOSS_TOL = 0.01
PARAM_ATOL = 1e-4
STATE_ATOL = 1e-6
STEP_BOUND = OPT["lr"] * 1.1


def _state(tparams):
    return {"params": tparams,
            "opt": build_optimizer(OptimizerConfig(**OPT)).init(tparams),
            "step": torch.zeros((), dtype=torch.int32)}


def _assert_params_close(got, want, grads, old):
    """Updated params: PARAM_ATOL where |grad| is clear of zero (2e-4 of
    the leaf's largest), at most one step anywhere."""
    for name in want:
        settled = np.abs(grads[name]) > 2e-4 * np.abs(grads[name]).max()
        np.testing.assert_allclose(got[name][settled], want[name][settled],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert np.abs(got[name] - old[name]).max() <= STEP_BOUND, name


@pytest.mark.parametrize("variant", ["microbatches2", "compression",
                                     "gather"])
def test_train_step_matches_jax_make_train_step(variant):
    kw = {"microbatches2": dict(microbatches=2),
          "gather": dict(loss_impl="gather")}.get(variant, {})
    jcfg, tcfg = configs("smollm-360m")
    jparams, tparams = both_params(numpy_params(jcfg), "float32")
    jb, tb = train_batch(tcfg, S, B)
    jstep, _ = jax_make_train_step(jcfg, JTrainConfig(
        optimizer=JOptimizerConfig(**OPT), remat=False,
        compression=JCompression() if variant == "compression" else None,
        **kw))
    jstate = {"params": jparams,
              "opt": jax_build_optimizer(JOptimizerConfig(**OPT)).init(
                  jparams),
              "step": jnp.zeros((), jnp.int32)}
    jnew, jm = jax.jit(jstep)(jstate, jb)
    tc = TrainConfig(optimizer=OptimizerConfig(**OPT), remat=False,
                     compression=CompressionConfig()
                     if variant == "compression" else None, **kw)
    step_fn, _ = make_train_step(tcfg, tc, "cpu")
    new, m = step_fn(_state(tparams), tb)

    for k in ("loss", "ce", "aux"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL,
                                            abs=1e-12), k
    (_, _), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jcfg, JTrainConfig(remat=False, **kw)),
        has_aux=True)(jparams, jb)
    _assert_params_close(flat_torch(new["params"]), flat_jax(
        jnew["params"]), flat_jax(jgrads), flat_jax(jparams))
    if variant != "compression":   # quantised grads may differ by a level
        want, got = flat_jax(jnew["opt"]), flat_torch(new["opt"])
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=STATE_ATOL, err_msg=name)
    assert int(new["step"]) == int(jnew["step"]) == 1


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_bf16_loss_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    jparams, tparams = both_params(numpy_params(jcfg), "bfloat16")
    jb, tb = train_batch(tcfg, S, B)
    jloss, jm = jax.jit(jax_make_loss_fn(
        jcfg, JTrainConfig(attention_impl="auto", remat=False)))(jparams, jb)
    loss_fn = make_loss_fn(tcfg, TrainConfig(remat=False), "cpu")
    with torch.no_grad():
        loss, m = loss_fn(tparams, tb)
    assert abs(float(loss) - float(jloss)) <= BF16_LOSS_TOL
    assert abs(float(m["ce"]) - float(jm["ce"])) <= BF16_LOSS_TOL


def test_gradient_dtypes_follow_the_reference():
    """microbatches == 1: gradients in the params' dtypes (bf16 leaves
    give bf16 gradients, the float32 Mamba leaves float32); k > 1:
    float32 accumulators."""
    jcfg, tcfg = configs("mamba2-130m")
    _, tparams = both_params(numpy_params(jcfg), "bfloat16")
    _, tb = train_batch(tcfg, S, B)
    loss_fn = make_loss_fn(tcfg, TrainConfig(remat=False), "cpu")
    _, _, g1 = compute_grads(loss_fn, tparams, tb, 1)
    for (path, p), g in zip(named_leaves(tparams), leaves(g1)):
        assert g.dtype == p.dtype and g.shape == p.shape, path
    assert {g.dtype for g in leaves(g1)} == {torch.bfloat16, torch.float32}
    _, _, g2 = compute_grads(loss_fn, tparams, tb, 2)
    assert {g.dtype for g in leaves(g2)} == {torch.float32}


def test_microbatches_2_matches_1():
    jcfg, tcfg = configs("smollm-360m")
    _, tparams = both_params(numpy_params(jcfg), "float32")
    _, tb = train_batch(tcfg, S, B)
    loss_fn = make_loss_fn(tcfg, TrainConfig(remat=False), "cpu")
    loss1, m1, g1 = compute_grads(loss_fn, tparams, tb, 1)
    loss2, m2, g2 = compute_grads(loss_fn, tparams, tb, 2)
    # the batch mean of CE is the mean of the two halves' means
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-6)
    assert float(m2["ce"]) == pytest.approx(float(m1["ce"]), rel=1e-6)
    for a, b in zip(leaves(g2), leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-6 * float(b.abs().max()),
                                   rtol=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """torch.utils.checkpoint recomputes each unit with the same ops, so
    the gradients are the same bit for bit on the CPU."""
    jcfg, tcfg = configs(arch)
    _, tparams = both_params(numpy_params(jcfg), "float32")
    _, tb = train_batch(tcfg, S, B)
    out = []
    for remat in (False, True):
        loss_fn = make_loss_fn(tcfg, TrainConfig(remat=remat), "cpu")
        out.append(value_and_grad(loss_fn, tparams, tb))
    ((l0, _), g0), ((l1, _), g1) = out
    assert torch.equal(l0, l1)
    for (path, a), b in zip(named_leaves(g0), leaves(g1)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("z", [0.0, 1e-4, 0.1])
def test_cross_entropy_forms_match_jax(z):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    want = {impl: jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    z, impl) for impl in ("onehot", "gather")}
    grads = {}
    for impl in ("onehot", "gather"):
        lg = torch.from_numpy(logits).requires_grad_()
        loss, ce = cross_entropy(lg, torch.from_numpy(labels), z, impl)
        assert float(loss.detach()) == pytest.approx(float(want[impl][0]), rel=1e-6)
        assert float(ce.detach()) == pytest.approx(float(want[impl][1]),
                                                   rel=1e-6)
        (grads[impl],) = torch.autograd.grad(loss, lg)
    torch.testing.assert_close(grads["onehot"], grads["gather"], rtol=0,
                               atol=1e-7)


def test_profile_train_on_cpu_reports_operators_and_no_device_numbers():
    from repro_torch.launch.profile import profile_train
    res = profile_train("smollm-360m", batch=2, seq=16, calls=2,
                        device="cpu", use_reduced=True)
    assert res["device"] == "cpu" and res["host_ms_per_step"] > 0
    assert res["what"] == "step" and res["kernels_us"]
    assert any("Backward" in name for name in res["kernels_us"])
    assert "device_idle_share" not in res
    assert "plain_attention_bwd_share_of_busy" not in res
