"""`params_from_jax` carries the JAX tree across key for key and shape
for shape, and matches the port's own initialiser's tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

from _torch_parity import configs


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b",
                                  "chatglm3-6b", "qwen2.5-32b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_params_from_jax_matches_port_init_tree(arch):
    jcfg, tcfg = configs(arch)
    jparams = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(0))
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    own = build_model(tcfg, remat=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert _shapes(carried) == _shapes(own)
    assert _shapes(carried) == _shapes(jax.tree.map(np.asarray, jparams))


def test_hybrid_tree_keeps_its_two_stacked_axes_and_fp32_leaves():
    """zamba2: Mamba params stacked (u_outer, every) with no `b{j}` key,
    one shared block outside the stack, and the reference's float32
    leaves still float32 and bit-equal after the crossing."""
    jcfg, _ = configs("zamba2-2.7b")
    jparams = jax.tree.map(
        np.asarray, jax_build_model(jcfg, remat=False).init(
            jax.random.PRNGKey(1)))
    carried = params_from_jax(jparams, "cpu")
    u_outer, every = jcfg.n_layers // jcfg.shared_attn_every, 6
    assert set(carried) == {"embed", "final_norm", "units", "shared"}
    assert set(carried["units"]) == {"norm", "mamba"}
    assert set(carried["shared"]) == {"norm1", "attn", "norm2", "mlp"}
    mamba = carried["units"]["mamba"]
    assert mamba["in_proj"].shape[:2] == (u_outer, every)
    assert mamba["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name].shape == (u_outer, every, jcfg.n_ssm_heads)
        assert mamba[name].dtype == torch.float32
        np.testing.assert_array_equal(mamba[name].numpy(),
                                      jparams["units"]["mamba"][name])


def test_bf16_goes_across_exactly():
    vals = np.array([1.0, -0.0078125, 3.140625, 65280.0, 1e-30],
                    np.float32)
    a = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    t = params_from_jax({"w": a, "n": {"i": np.arange(3, dtype=np.int32)}},
                        "cpu")
    assert t["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["w"].float().numpy(),
                                  a.astype(np.float32))
    assert t["n"]["i"].dtype == torch.int32
    assert t["n"]["i"].tolist() == [0, 1, 2]
