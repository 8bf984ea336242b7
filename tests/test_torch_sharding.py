"""The port's sharding rules against the JAX package's, spec for spec.

The rules read only `mesh.shape`, so both packages get the same stub of
the single-host (1, 1) and (2, 4) meshes and of the production meshes
(16, 16) and (2, 16, 16) (the reference's `NamedSharding` is swapped for
a plain (mesh, spec) pair so it accepts the stub).  For every one of the
ten archs, reduced and at published shapes (abstract trees from
`jax.eval_shape`, never allocated): every parameter's spec, AdamW's and
Adafactor's optimizer-state specs, the whole state's, and the KV / SSM
cache's; then batch specs over a grid of shapes.  The invariants of
`tests/test_runtime.py` (every assigned axis divides its dimension) are
held on the same four meshes.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic smoke-subset fallback
    from _hypothesis_fallback import given, settings, strategies as st

import repro.runtime.sharding as jsh
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro_torch.runtime import sharding as tsh

MESHES = {"1x1": dict(data=1, model=1), "2x4": dict(data=2, model=4),
          "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@dataclasses.dataclass(frozen=True)
class _Named:
    mesh: object
    spec: object


@pytest.fixture(autouse=True)
def _plain_named_sharding(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", _Named)


@functools.cache
def _abstract(arch, published):
    cfg = JAX_ARCHS[arch]
    if not published:
        cfg = jax_reduced(cfg)
    model = jax_build_model(cfg, remat=False)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.init_cache(4, 64))
    return params, cache


def _specs(tree):
    """{path: spec as a tuple} of a tree of shardings of either package."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": s for k, v in tree.items()
                for p, s in _specs(v).items()}
    return {"": tuple(tree.spec)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_rules_equal_the_reference_spec_for_spec(arch, mesh_name):
    mesh = _Mesh(MESHES[mesh_name])
    for published in (False, True):
        params, cache = _abstract(arch, published)
        want = _specs(jsh.params_shardings(mesh, params))
        got = _specs(tsh.params_shardings(mesh, params))
        assert got == want and len(got) > 3
        for opt in ("adamw", "adafactor"):
            assert _specs(tsh.opt_shardings(mesh, params, opt)) == \
                _specs(jsh.opt_shardings(mesh, params, opt))
        state = {"params": params, "opt": None, "step": None}
        assert _specs(tsh.state_shardings(mesh, state, "adafactor")) == \
            _specs(jsh.state_shardings(mesh, state, "adafactor"))
        assert _specs(tsh.cache_shardings(mesh, cache)) == \
            _specs(jsh.cache_shardings(mesh, cache))
        # the leaf rule by itself, as the tree functions apply it
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for kp, x in flat:
            path = "/".join(str(k.key) for k in kp)
            assert tuple(tsh.param_spec(mesh, path, x.shape)) == \
                tuple(jsh.param_spec(mesh, path, x.shape)), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    mesh = _Mesh(MESHES[mesh_name])
    for B in (1, 2, 3, 4, 16, 32, 64, 512):
        for S in (1, 16, 128, 4096):
            for shape in ((B, S), (B, S, 64)):
                assert tuple(tsh.batch_spec(mesh, shape)) == \
                    tuple(jsh.batch_spec(mesh, shape)), shape
    batch = {"tokens": np.zeros((32, 128)), "labels": np.zeros((3, 16))}
    assert _specs(tsh.logical_batch_shardings(mesh, batch)) == \
        _specs(jsh.logical_batch_shardings(mesh, batch))


def test_spec_normalises_one_name_tuples_as_jax_does():
    from jax.sharding import PartitionSpec
    assert tsh.P(("data",), None) == tuple(PartitionSpec(("data",), None))
    assert tsh.P(("pod", "data"), "model") == \
        tuple(PartitionSpec(("pod", "data"), "model"))


def _divides(mesh, shape, spec):
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, ax in zip(shape, padded):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        assert d % int(np.prod([mesh.shape[a] for a in axes])) == 0, (
            shape, spec)


@given(st.sampled_from(list(MESHES)),
       st.sampled_from(["wq", "wk", "wv", "wo", "w_up", "w_down", "table",
                        "unembed", "router", "in_proj", "out_proj",
                        "scale", "conv_w"]),
       st.integers(1, 4),
       st.sampled_from([64, 96, 128, 15, 384, 1000]))
@settings(max_examples=60, deadline=None)
def test_param_spec_always_divisible(mesh_name, name, rank, dim):
    mesh = _Mesh(MESHES[mesh_name])
    shape = tuple([dim] * rank)
    spec = tsh.param_spec(mesh, f"units/b0/attn/{name}", shape)
    assert len(spec) <= rank
    _divides(mesh, shape, spec)


@given(st.sampled_from(list(MESHES)), st.integers(1, 512),
       st.integers(1, 8192))
@settings(max_examples=40, deadline=None)
def test_batch_spec_divisible(mesh_name, batch, seq):
    mesh = _Mesh(MESHES[mesh_name])
    _divides(mesh, (batch, seq), tsh.batch_spec(mesh, (batch, seq)))


@given(st.sampled_from(list(MESHES)),
       st.tuples(st.integers(1, 64), st.integers(1, 64),
                 st.integers(128, 4096), st.integers(1, 64),
                 st.integers(32, 256)))
@settings(max_examples=40, deadline=None)
def test_cache_spec_divisible(mesh_name, shape):
    mesh = _Mesh(MESHES[mesh_name])
    _divides(mesh, shape, tsh.cache_spec(mesh, shape))
