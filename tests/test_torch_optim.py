"""The port's optimizers, LR schedule, clipping and gradient compression
against the JAX package's, on identical numpy inputs.

Tolerances: the optimizer trajectories (params and state, float32, 5
steps, clipping active) agree to 1e-6 absolute plus 1e-6 relative: the
two frameworks run the same float32 operations, and differ only in the
order of the sums (the global norm, Adafactor's means) and in the last
ulp of pow/rsqrt.  The schedule's scalars are compared exactly.
Compression is held bit for bit (the same float32 divisions, max and
round-half-to-even).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic smoke-subset fallback
    from _hypothesis_fallback import given, settings, strategies as st

from repro.optim import optimizers as jopt
from repro.runtime import compression as jcomp
from repro_torch.optim.optimizers import (OptimizerConfig, build_optimizer,
                                          clip_by_global_norm, cosine_lr)
from repro_torch.runtime.compression import (CompressionConfig,
                                             compress_decompress,
                                             compress_with_error_feedback,
                                             init_residual)
from repro_torch.tree import leaves, named_leaves, tree_map

TRAJ_TOL = dict(atol=1e-6, rtol=1e-6)


def _numpy_tree(seed):
    """Params of the shapes a model has: stacked over 3 units, a factored
    stacked matrix, a stacked norm scale (ndim 2: decayed), vectors."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": {"table": a(300, 128)},
            "final_norm": {"scale": 1.0 + 0.1 * a(128)},
            "units": {"b0": {"attn": {"wq": 0.1 * a(3, 160, 200),
                                      "bq": a(3, 40)},
                             "norm": {"scale": 1.0 + 0.1 * a(3, 64)}}},
            "w": a(256, 100)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, want, **tol):
    want = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {"/".join(path): v.numpy() for path, v in named_leaves(got)}
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_trajectory_matches_jax(name):
    cfg = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10)
    jo = jopt.build_optimizer(jopt.OptimizerConfig(**cfg))
    to = build_optimizer(OptimizerConfig(**cfg))
    params = _numpy_tree(0)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    _assert_trees_close(ts, js, atol=0, rtol=0)      # zeros, same keys
    for i in range(5):
        g = jax.tree.map(lambda a: 3.0 * a, _numpy_tree(100 + i))
        jp, js = jo.update(_to_jax(g), js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = to.update(_to_torch(g), ts, tp,
                           torch.tensor(i, dtype=torch.int32))
        _assert_trees_close(tp, jp, **TRAJ_TOL)
        _assert_trees_close(ts, js, **TRAJ_TOL)


def test_state_keys_and_factored_shapes_on_stacked_leaves():
    tp = _to_torch(_numpy_tree(0))
    st_ = build_optimizer(OptimizerConfig(name="adafactor")).init(tp)
    v = st_["v"]
    wq = v["units"]["b0"]["attn"]["wq"]               # (3, 160, 200)
    assert set(wq) == {"vr", "vc"}
    assert tuple(wq["vr"].shape) == (3, 160)
    assert tuple(wq["vc"].shape) == (3, 200)
    assert set(v["w"]) == {"v"}                        # 100 < 128
    assert set(v["units"]["b0"]["norm"]["scale"]) == {"v"}
    adam = build_optimizer(OptimizerConfig()).init(tp)
    assert set(adam) == {"mu", "nu"}
    assert all(x.dtype == torch.float32 for x in leaves(adam))


def test_stacked_norm_scale_gets_weight_decay_as_in_the_reference():
    """ndim >= 2 decides decay, so a (n_units, d) norm scale is decayed
    and a (d,) one is not (the reference's rule, kept)."""
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    opt = build_optimizer(cfg)
    params = {"stacked": torch.ones((2, 8)), "flat": torch.ones((8,))}
    grads = tree_map(torch.zeros_like, params)
    new, _ = opt.update(grads, opt.init(params), params, 0)
    assert float(new["flat"].max()) == 1.0
    assert float(new["stacked"].max()) < 1.0


# ---- mirrors of tests/test_runtime.py:36-80 against the port -------------

def _toy_params():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((256, 256))
                                  .astype(np.float32)),
            "b": torch.zeros((256,)),
            "nested": {"u": torch.from_numpy(
                rng.standard_normal((128, 512)).astype(np.float32))}}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(name):
    cfg = OptimizerConfig(name=name, lr=0.05, warmup_steps=0,
                          total_steps=200, weight_decay=0.0)
    opt = build_optimizer(cfg)
    params = _toy_params()
    target = tree_map(lambda p: torch.ones_like(p) * 0.5, params)
    state = opt.init(params)

    def loss(p):
        return sum(float(torch.sum((a - b) ** 2)) for a, b in
                   zip(leaves(p), leaves(target)))

    l0 = loss(params)
    for i in range(60):
        grads = tree_map(lambda a, b: 2.0 * (a - b), params, target)
        params, state = opt.update(grads, state, params, i)
    assert loss(params) < 0.2 * l0


def test_adafactor_state_is_factored():
    opt = build_optimizer(OptimizerConfig(name="adafactor"))
    st_ = opt.init({"w": torch.zeros((256, 512)), "b": torch.zeros((64,))})
    assert set(st_["v"]["w"]) == {"vr", "vc"}
    assert tuple(st_["v"]["w"]["vr"].shape) == (256,)
    assert tuple(st_["v"]["w"]["vc"].shape) == (512,)
    assert set(st_["v"]["b"]) == {"v"}        # small: unfactored


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_walks_large_leaves_in_slices_bit_for_bit(monkeypatch, dtype):
    """A leaf over `ADAMW_SLICE` entries is updated a slice at a time
    (the update's fp32 temporaries bounded on the card), a DTensor leaf
    on its local shard; every slice is computed as the whole leaf is, so
    three steps, clipping active, give the same bits as the whole-leaf
    update, in float32 and for bf16 params and gradients, as plain
    tensors and as DTensors on a 1-rank mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from _torch_dist import local_group
    from repro_torch.optim import optimizers as topt
    params = tree_map(lambda t: t.to(dtype), _to_torch(_numpy_tree(3)))
    grads = [tree_map(lambda t: (5.0 * t).to(dtype),
                      _to_torch(_numpy_tree(11 + i))) for i in range(3)]
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10)

    def run(place):
        opt = build_optimizer(cfg)
        p = place(params)
        state = opt.init(p)
        for i, g in enumerate(grads):
            p, state = opt.update(place(g), state, p, i)
        return [t.full_tensor() if isinstance(t, DTensor) else t
                for t in leaves({"params": p, "opt": state})]

    runs = []
    with local_group():
        mesh = init_device_mesh("cpu", (1,))
        for slice_ in (topt.ADAMW_SLICE, 999):   # the largest leaf: 96,000
            monkeypatch.setattr(topt, "ADAMW_SLICE", slice_)
            runs.append(run(lambda tree: tree))
            runs.append(run(lambda tree: tree_map(
                lambda t: distribute_tensor(t, mesh, [Shard(0)]), tree)))
    names = [n for n, _ in named_leaves({"params": params,
                                         "opt": build_optimizer(cfg).init(
                                             params)})]
    for other in runs[1:]:
        for name, a, b in zip(names, runs[0], other):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(torch.sum(clipped["a"] ** 2))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(10) * 100, rel=1e-5)


def test_clip_by_global_norm_matches_jax():
    tree = _numpy_tree(7)
    got, gn = clip_by_global_norm(_to_torch(tree), 1.0)
    want, jgn = jopt.clip_by_global_norm(_to_jax(tree), 1.0)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    _assert_trees_close(got, want, atol=1e-7, rtol=1e-6)
    same, _ = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(same["a"], torch.full((4,), 0.1))   # under the norm


def test_cosine_lr_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(cosine_lr(cfg, 0)) == pytest.approx(0.1)
    assert float(cosine_lr(cfg, 0)) > 0.0  # first step trains
    assert float(cosine_lr(cfg, 9)) == pytest.approx(1.0)
    assert float(cosine_lr(cfg, 100)) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10_000)])
def test_cosine_lr_equals_jax(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    cfg, jcfg = OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 5000, 10_000, 20_000):
        got = cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.cosine_lr(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(want), step


# ---- gradient compression ---------------------------------------------

def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((3, 200)) * scale).astype(np.float32),
            "small": rng.standard_normal((100,)).astype(np.float32),
            "v": (rng.standard_normal((1000,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_compress_decompress_bit_equal_to_jax(block, seed, scale):
    g = _grads(seed, scale)
    got = compress_decompress(_to_torch(g), CompressionConfig(block=block))
    want = jcomp.compress_decompress(_to_jax(g),
                                     jcomp.CompressionConfig(block=block))
    _assert_trees_close(got, want, atol=0, rtol=0)
    if block > 100:     # a leaf under one block passes through unchanged
        np.testing.assert_array_equal(got["small"].numpy(), g["small"])


def test_compress_with_error_feedback_bit_equal_to_jax():
    cfg, jcfg = CompressionConfig(block=128), jcomp.CompressionConfig(
        block=128)
    g0 = _grads(3)
    res, jres = init_residual(_to_torch(g0)), jcomp.init_residual(
        _to_jax(g0))
    for i in range(4):
        g = _grads(10 + i)
        out, res = compress_with_error_feedback(_to_torch(g), res, cfg)
        jout, jres = jcomp.compress_with_error_feedback(_to_jax(g), jres,
                                                        jcfg)
        _assert_trees_close(out, jout, atol=0, rtol=0)
        _assert_trees_close(res, jres, atol=0, rtol=0)


def test_round_half_to_even_at_exact_halves():
    """A block whose max is 127 makes the scale 1, so x/scale lands on
    exact halves, where round-half-to-even decides."""
    vals = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                    np.float32)
    g = {"w": np.tile(vals, 32)}
    got = compress_decompress(_to_torch(g), CompressionConfig(block=256))
    want = jcomp.compress_decompress(_to_jax(g),
                                     jcomp.CompressionConfig(block=256))
    _assert_trees_close(got, want, atol=0, rtol=0)
    np.testing.assert_array_equal(got["w"].numpy()[:8],
                                  [127, 0, 2, 2, 0, -2, -2, 4])


@given(st.integers(1, 5), st.floats(0.1, 100.0))
@settings(max_examples=20, deadline=None)
def test_compression_error_bounded(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy((rng.standard_normal((512,)) * scale)
                               .astype(np.float32))}
    out = compress_decompress(g, CompressionConfig(block=128))
    err = (out["w"] - g["w"]).abs().numpy()
    # int8 block quantisation: error <= blockmax/127 per element
    bm = g["w"].abs().numpy().reshape(-1, 128).max(1, keepdims=True)
    assert (err.reshape(-1, 128) <= bm / 127 + 1e-6).all()


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal((1024,)).astype(np.float32))
    grads = {"w": g_true}
    cfg = CompressionConfig(block=256)
    res = init_residual(grads)
    acc_ef = np.zeros(1024)
    acc_nf = np.zeros(1024)
    for _ in range(50):
        out, res = compress_with_error_feedback(grads, res, cfg)
        acc_ef += out["w"].numpy()
        acc_nf += compress_decompress(grads, cfg)["w"].numpy()
    true_sum = g_true.numpy() * 50
    assert np.abs(acc_ef - true_sum).mean() <= \
        np.abs(acc_nf - true_sum).mean() + 1e-6
