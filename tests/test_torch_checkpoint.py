"""The port's checkpointer and training loop: the JAX package's on-disk
format both ways (bit for bit, bf16 included), the checkpointer's own
properties (mirrors of `tests/test_checkpoint.py`), and crash recovery
through the launcher's loop with bit-exact continuation (the mirror of
`test_injected_failure_bitexact_continuation`,
`tests/test_fault_tolerance.py:145`)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_ckpt
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_steps, restore, save)
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launcher
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime.train import TrainConfig, make_train_step
from repro_torch.tree import named_leaves, tree_map

from _torch_parity import both_params, configs, numpy_params


def _bits(a):
    """The raw bits of a torch or numpy leaf, as a numpy array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _states(arch="mamba2-130m"):
    """One train state as a JAX tree and a port tree: bf16 params with
    float32 Mamba leaves, non-zero float32 moments, an int32 step."""
    jcfg, _ = configs(arch)
    jparams, tparams = both_params(numpy_params(jcfg), "bfloat16")
    rng = np.random.default_rng(0)
    moments = {k: jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
        for k in ("mu", "nu")}
    jstate = {"params": jparams,
              "opt": jax.tree.map(jnp.asarray, moments),
              "step": jnp.asarray(7, jnp.int32)}
    tstate = {"params": tparams,
              "opt": jax.tree.map(torch.from_numpy, moments),
              "step": torch.tensor(7, dtype=torch.int32)}
    return jstate, tstate


def _assert_bit_equal(got, want_named):
    got = {"/".join(p): v for p, v in named_leaves(got)}
    assert got.keys() == want_named.keys()
    for name, want in want_named.items():
        g, w = _bits(got[name]), _bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _jax_named(tree):
    return {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    jstate, tstate = _states()
    jax_ckpt.save(str(tmp_path), jstate, 7)
    out = restore(str(tmp_path), tstate, device="cpu")
    _assert_bit_equal(out, _jax_named(jstate))
    assert out["params"]["units"]["b0"]["norm"]["scale"].dtype == \
        torch.bfloat16
    assert out["params"]["units"]["b0"]["mamba"]["A_log"].dtype == \
        torch.float32
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7


def test_port_checkpoint_restores_through_jax_bit_for_bit(tmp_path):
    jstate, tstate = _states()
    save(str(tmp_path), tstate, 7)
    out = jax_ckpt.restore(str(tmp_path), jstate)
    want = {"/".join(p): v for p, v in named_leaves(tstate)}
    got = _jax_named(out)
    assert got.keys() == want.keys()
    for name in want:
        g, w = _bits(got[name]), _bits(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_manifest_matches_the_jax_packages(tmp_path):
    """Same leaf names (sorted dict keys, "/"-joined), npz keys, shapes
    and dtype strings as the JAX package writes for the same state."""
    jstate, tstate = _states()
    os.makedirs(tmp_path / "jax")          # the JAX save needs the dir
    dj = jax_ckpt.save(str(tmp_path / "jax"), jstate, 3)
    dt = save(str(tmp_path / "port"), tstate, 3)
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    mt = json.load(open(os.path.join(dt, "manifest.json")))
    assert mt["leaves"] == mj["leaves"]
    assert mt["step"] == mj["step"] == 3
    assert [s["file"] for s in mt["shards"]] == \
        [s["file"] for s in mj["shards"]]
    names = [leaf["name"] for leaf in mt["leaves"]]
    assert "opt/mu/units/b0/mamba/in_proj" in names and names[-1] == "step"
    assert {leaf["dtype"] for leaf in mt["leaves"]} == {
        "bfloat16", "float32", "int32"}


def test_shards_split_at_the_size_limit(tmp_path, monkeypatch):
    from repro_torch.checkpoint import checkpointer
    monkeypatch.setattr(checkpointer, "SHARD_BYTES", 1024)
    tree = {"a": torch.zeros(300), "b": torch.ones(300), "c": torch.ones(3)}
    d = save(str(tmp_path), tree, 1)
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert [leaf["shard"] for leaf in man["leaves"]] == [0, 1, 2]
    out = restore(str(tmp_path), tree, device="cpu")
    for k in tree:
        assert torch.equal(out[k], tree[k])


# ---- mirrors of tests/test_checkpoint.py ---------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((32, 16), generator=g),
                       "units": {"b0": torch.arange(12.0).reshape(3, 4)}},
            "step": torch.tensor(5, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), t, 5)
    out = restore(str(tmp_path), t)
    for (_, a), (_, b) in zip(named_leaves(t), named_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert b.device == a.device          # device=None: like's device


def test_latest_steps_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save_async(t, s)
        ck.wait()
    assert latest_steps(str(tmp_path)) == [3, 4]


def test_gc_keeps_three_by_default(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    for s in range(1, 7):
        ck.save_async(_tree(), s)
    ck.wait()
    assert latest_steps(str(tmp_path)) == [4, 5, 6]


def test_async_overlaps_and_is_complete(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ck.save_async(t, 7)
    t["params"]["w"].zero_()       # the host copy was taken before
    ck.wait()
    out = restore(str(tmp_path), _tree(), step=7)
    assert torch.equal(out["params"]["w"], _tree()["params"]["w"])


def test_async_error_is_raised_by_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    ck.save_async(_tree(), 1)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                      # reported once


def test_corruption_detected(tmp_path):
    t = _tree()
    d = save(str(tmp_path), t, 3)
    shard = [f for f in os.listdir(d) if f.startswith("shard_")][0]
    with open(os.path.join(d, shard), "r+b") as f:
        f.seek(100)
        f.write(b"\x42\x42\x42")
    with pytest.raises(IOError):
        restore(str(tmp_path), t)


def test_atomic_no_partial_checkpoint(tmp_path):
    """Temp dirs never surface as checkpoints."""
    t = _tree()
    save(str(tmp_path), t, 9)
    assert all(not d.startswith(".tmp") for d in os.listdir(tmp_path)
               if os.path.isdir(os.path.join(tmp_path, d))
               and d.startswith("step_"))
    assert latest_steps(str(tmp_path)) == [9]
    os.makedirs(tmp_path / ".tmp_ckpt_half" / "x")   # a crashed write
    assert latest_steps(str(tmp_path)) == [9]


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), _tree())


# ---- crash recovery through the launcher's loop --------------------------

def _training(n_steps=12):
    cfg = reduced(ARCHS["smollm-360m"])
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=50),
                       remat=False)
    step_fn, init_fn = make_train_step(cfg, tcfg, "cpu")
    dcfg = DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)

    def batch_fn(step):
        return launcher.device_batch(cfg, dcfg, step, "cpu")

    def init():
        return init_fn(torch.Generator().manual_seed(0))

    ref = init()
    for s in range(n_steps):
        ref, _ = step_fn(ref, batch_fn(s))
    return step_fn, init, batch_fn, ref


def _once_at(step):
    fired = {"done": False}

    def injector(s):
        if s == step and not fired["done"]:
            fired["done"] = True
            return True
        return False
    return injector


@pytest.mark.parametrize("fail_at,expect_restart_step", [(7, 6), (3, 0)])
def test_injected_failure_bitexact_continuation(tmp_path, fail_at,
                                                expect_restart_step):
    """Kill the run mid-training; the recovered run ends in exactly the
    uninterrupted run's state.  A failure after the step-5 checkpoint
    restores it (state step 6); one before any checkpoint restarts from
    the initial state, made again by `restart_fn`."""
    step_fn, init, batch_fn, ref = _training()
    ck = AsyncCheckpointer(str(tmp_path))
    final, stats = launcher.train_loop(step_fn, init(), batch_fn, 12, ck,
                                       ckpt_every=5, restart_fn=init,
                                       failure_injector=_once_at(fail_at))
    ck.wait()
    assert stats["recoveries"] == 1
    assert stats["steps_run"] == 12 + fail_at - expect_restart_step
    assert sorted(stats["ce"]) == list(range(12))
    for (path, a), (_, b) in zip(named_leaves(ref), named_leaves(final)):
        assert torch.equal(a, b), path
    assert latest_steps(str(tmp_path)) == [5, 10]


def test_recovery_gives_up_after_max_restarts(tmp_path):
    step_fn, init, batch_fn, _ = _training(0)
    with pytest.raises(RuntimeError, match="max_restarts"):
        launcher.train_loop(step_fn, init(), batch_fn, 12,
                            AsyncCheckpointer(str(tmp_path)),
                            restart_fn=init,
                            failure_injector=lambda s: s == 2,
                            max_restarts=3)


def test_failure_before_a_checkpoint_without_restart_fn_is_raised(tmp_path):
    step_fn, init, batch_fn, _ = _training(0)
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        launcher.train_loop(step_fn, init(), batch_fn, 4,
                            AsyncCheckpointer(str(tmp_path)),
                            failure_injector=lambda s: s == 1)


def test_not_implemented_is_not_recovered(tmp_path):
    def step_fn(state, batch):
        raise NotImplementedError("no such path")

    with pytest.raises(NotImplementedError):
        launcher.train_loop(step_fn, {"step": torch.tensor(0)}, lambda s: {},
                            4, AsyncCheckpointer(str(tmp_path)))


def test_launcher_resume_matches_an_uninterrupted_run(tmp_path):
    args = ["--device", "cpu", "--steps", "8", "--seq", "16", "--batch",
            "2", "--ckpt-every", "3", "--log-every", "100"]
    full, stats = launcher.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert stats["recoveries"] == 0
    assert latest_steps(str(tmp_path / "a")) == [3, 6, 8]
    os.rename(tmp_path / "a" / "step_00000006", tmp_path / "b")
    os.makedirs(tmp_path / "c")
    os.rename(tmp_path / "b", tmp_path / "c" / "step_00000006")
    resumed, stats = launcher.main(args + ["--ckpt-dir", str(tmp_path / "c"),
                                           "--resume"])
    assert stats["steps_run"] == 1          # step 7 only
    for (path, a), (_, b) in zip(named_leaves(full), named_leaves(resumed)):
        assert torch.equal(a, b), path
    assert tree_map(lambda t: t.device.type, resumed)["step"] == "cpu"
