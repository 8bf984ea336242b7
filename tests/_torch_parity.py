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

#: reduced dense configs, plus smollm with an 8-token sliding window so
#: that decode wraps its ring buffer
PARITY_ARCHS = ("smollm-360m", "gemma2-2b", "chatglm3-6b", "qwen2.5-32b",
                "smollm-swa8")


def configs(name):
    """(JAX config, port config) of one parity arch."""
    base = "smollm-360m" if name == "smollm-swa8" else name
    jcfg, tcfg = jax_reduced(JAX_ARCHS[base]), reduced(ARCHS[base])
    if name == "smollm-swa8":
        jcfg = dataclasses.replace(jcfg, sliding_window=8, unit=())
        tcfg = dataclasses.replace(tcfg, sliding_window=8, unit=())
    return jcfg, tcfg


def numpy_params(jcfg, seed=0):
    """JAX-initialised params as float32 numpy, with the QKV biases and
    norm scales (zeros and ones at init) perturbed so they are exercised;
    the perturbed values are bf16-exact."""
    from repro.models import build_model
    params = build_model(jcfg, remat=False).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def fix(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif name == "scale":
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    return jax.tree_util.tree_map_with_path(fix, params)


def both_params(tree, dtype):
    """The same numpy tree as a JAX tree and a port tree of `dtype`."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, tparams
