"""One training step of the port against the JAX package's, per reduced
arch: the loss, the gradients and the optimizer update.

The same JAX-initialised float32 weights (`_torch_parity`) and the same
batch (the data pipeline, bit-equal in both packages) go to JAX's
`make_loss_fn` under `jax.value_and_grad` with `attention_impl="auto"`
and remat off, and to the port's `make_loss_fn` / `make_train_step` on
the CPU with impl "auto" (plain attention, `ssd_plain` through the SSD
wrapper's CPU route for mamba2 and zamba2).  JAX's optimizer update
(what its `train_step` applies after the gradients) runs on JAX's
gradients.

Tolerances (float32):
- loss and ce: 1e-5 relative (seen: <= 1.5e-7);
- each gradient leaf: 1e-4 of the leaf's largest |gradient|, elementwise
  (seen: <= 1.5e-5, at mamba2's A_log and zamba2's shared MLP, whose
  gradients pass through the scan's cumsum and exp chains; elsewhere
  ~1e-6).  The two run the same float32 arithmetic with sums in another
  order, and the backward pass carries those differences through the
  layers;
- the updated params: 1e-4 absolute, a tenth of the learning rate,
  wherever JAX's gradient exceeds twice its gradient tolerance (so its
  sign is settled).  AdamW's first step moves each weight by about
  lr * sign(g), so a weight moved the wrong way would be off by 2 lr.
  Where the gradient is zero up to rounding (the key bias of chatglm3
  and qwen2.5: softmax ignores a shift shared by a query's scores) the
  sign is noise in both packages, and each weight is only held to have
  moved by at most one step;
- the optimizer state: 1e-6 absolute (mu = 0.1 g, nu = 0.001 g^2, with
  |g| < ~1 after clipping).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import build_optimizer as jax_build_optimizer
from repro.runtime.train import TrainConfig as JTrainConfig
from repro.runtime.train import make_loss_fn as jax_make_loss_fn
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.train import (TrainConfig, make_loss_fn,
                                       make_train_step, value_and_grad)

from _torch_parity import (PARITY_ARCHS, both_params, configs, flat_jax,
                           flat_torch, numpy_params, train_batch)

B, S = 2, 40                  # S > 32: the reduced gemma2 window is used
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4               # of each leaf's max |gradient|
PARAM_ATOL = 1e-4
# AdamW's first step: |lr * (g / (|g| + eps) + wd * p)| <= lr * (1 + wd |p|)
STEP_BOUND = OPT["lr"] * 1.1
STATE_ATOL = 1e-6


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_matches_jax_float32(arch):
    jcfg, tcfg = configs(arch)
    jparams, tparams = both_params(numpy_params(jcfg), "float32")
    jb, tb = train_batch(tcfg, S, B)

    jloss_fn = jax_make_loss_fn(jcfg, JTrainConfig(attention_impl="auto",
                                                   remat=False))
    (jloss, jm), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True))(jparams, jb)
    jopt = jax_build_optimizer(JOptimizerConfig(**OPT))
    jnew, jstate = jax.jit(jopt.update)(jgrads, jopt.init(jparams), jparams,
                                        jnp.zeros((), jnp.int32))

    tc = TrainConfig(optimizer=OptimizerConfig(**OPT), attention_impl="auto",
                     remat=False)
    (loss, m), grads = value_and_grad(make_loss_fn(tcfg, tc, "cpu"),
                                      tparams, tb)
    step_fn, _ = make_train_step(tcfg, tc, "cpu")
    state = {"params": tparams,
             "opt": build_optimizer(OptimizerConfig(**OPT)).init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}
    new_state, metrics = step_fn(state, tb)

    for got in (loss, metrics["loss"]):
        assert float(got) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for got in (m["ce"], metrics["ce"]):
        assert float(got) == pytest.approx(float(jm["ce"]), rel=LOSS_RTOL)
    assert int(new_state["step"]) == 1

    want, got = flat_jax(jgrads), flat_torch(grads)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name                  # every leaf gets a gradient
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    # where the gradient's sign is settled (|g| over the gradient
    # tolerance), the step matches; elsewhere (the key bias, whose
    # gradient is zero up to rounding, and single weights near zero) both
    # moved by at most a step
    jg = flat_jax(jgrads)
    want, got = flat_jax(jnew), flat_torch(new_state["params"])
    old = flat_jax(jparams)
    for name in want:
        settled = np.abs(jg[name]) > 2 * GRAD_TOL * np.abs(jg[name]).max()
        np.testing.assert_allclose(got[name][settled], want[name][settled],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert np.abs(got[name] - old[name]).max() <= STEP_BOUND, name
    want, got = flat_jax(jstate), flat_torch(new_state["opt"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=STATE_ATOL, err_msg=name)
