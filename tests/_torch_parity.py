"""Shared set-up of the port-vs-JAX parity tests: one set of weights,
made by the JAX initialiser, handed to both frameworks as numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax

#: reduced dense configs, smollm with an 8-token sliding window so that
#: decode wraps its ring buffer, and the Mamba2 SSM and zamba2 hybrid
PARITY_ARCHS = ("smollm-360m", "gemma2-2b", "chatglm3-6b", "qwen2.5-32b",
                "smollm-swa8", "mamba2-130m", "zamba2-2.7b")
#: leaves the reference initialises in float32 (`mamba_init`); they stay
#: float32 when the rest of the tree is bf16, as in serving
FP32_LEAVES = ("A_log", "D", "dt_bias")


def configs(name):
    """(JAX config, port config) of one parity arch."""
    base = "smollm-360m" if name == "smollm-swa8" else name
    jcfg, tcfg = jax_reduced(JAX_ARCHS[base]), reduced(ARCHS[base])
    if name == "smollm-swa8":
        jcfg = dataclasses.replace(jcfg, sliding_window=8, unit=())
        tcfg = dataclasses.replace(tcfg, sliding_window=8, unit=())
    return jcfg, tcfg


def numpy_params(jcfg, seed=0):
    """JAX-initialised params as float32 numpy, with the QKV biases, norm
    scales and the Mamba skip, dt bias and conv bias (zeros and ones at
    init) perturbed so they are exercised; the values are bf16-exact."""
    from repro.models import build_model
    params = build_model(jcfg, remat=False).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def fix(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in ("bq", "bk", "bv", "scale", "D", "dt_bias", "conv_b"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    return jax.tree_util.tree_map_with_path(fix, params)


def both_params(tree, dtype):
    """The same numpy tree as a JAX tree and a port tree of `dtype`
    (FP32_LEAVES stay float32)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]

    def cast(path, a):
        keep = path[-1].key in FP32_LEAVES
        return jnp.asarray(a, jnp.float32 if keep else jdt)

    jparams = jax.tree_util.tree_map_with_path(cast, tree)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, tparams
