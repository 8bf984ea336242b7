"""The port's fault tolerance against the reference's cases
(`tests/test_fault_tolerance.py`): heartbeat death and eviction, elastic
shrink of the data and pod axes, straggler detection, the recovery loop's
metrics roll-back and restart bound, and an injected failure whose
recovered run ends bit-equal to an uninterrupted one (reduced smollm on
the CPU, the port's checkpointer); and a plan's shape making its mesh.  The module is a copy of the
reference's, so its cases are the reference's tests on the port's copy.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import latest_steps, restore, save
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime.fault_tolerance import (ElasticPlan, Heartbeat,
                                                 StragglerMitigator,
                                                 run_with_recovery)
from repro_torch.runtime.train import TrainConfig, make_train_step
from repro_torch.tree import leaves


def test_heartbeat_marks_dead():
    hb = Heartbeat(timeout_s=10)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(0, now=8.0)
    assert hb.dead(now=12.0) == [1]
    assert hb.alive(now=12.0) == [0]


def test_elastic_plan_shrinks_data_axis_only():
    p = ElasticPlan.plan(256, model_parallel=16)
    assert p.mesh_shape == (16, 16)
    p2 = ElasticPlan.plan(200, model_parallel=16)   # lost chips
    assert p2.mesh_shape == (8, 16)                 # data halved, TP kept
    with pytest.raises(RuntimeError):
        ElasticPlan.plan(8, model_parallel=16)


def test_heartbeat_evict_stops_rereporting():
    """Regression: without evict(), dead() re-reports the same failed
    worker on every poll and the restart policy re-fires forever."""
    hb = Heartbeat(timeout_s=10)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(0, now=20.0)
    assert hb.dead(now=25.0) == [1]
    hb.evict(1)
    assert hb.dead(now=25.0) == []          # acted on: not reported again
    assert hb.alive(now=25.0) == [0]
    hb.evict(1)                             # idempotent


def test_elastic_plan_shrinks_pods_before_raising():
    """Regression: with pods > 1 the old guard ignored the pod factor and
    could claim more workers than there are alive chips
    (model=2, pods=2, alive=3 -> claimed 4)."""
    p = ElasticPlan.plan(3, model_parallel=2, pods=2)
    assert p.n_workers <= 3
    assert p.mesh_shape == (1, 2)           # pods shrunk to 1 -> 2-axis mesh
    # pods kept when they fit
    p2 = ElasticPlan.plan(8, model_parallel=2, pods=2)
    assert p2.mesh_shape == (2, 2, 2) and p2.n_workers == 8
    # partial shrink: 3 pods -> 2 pods of 2x2
    p3 = ElasticPlan.plan(11, model_parallel=2, pods=3)
    assert p3.n_workers <= 11
    with pytest.raises(ValueError):
        ElasticPlan.plan(4, model_parallel=2, pods=0)


def test_elastic_plan_lattice_never_overcommits():
    """Every feasible (alive, model, pods) cell yields a plan that fits
    the survivors, keeps the model axis, and is internally consistent."""
    for alive in range(1, 33):
        for model in (1, 2, 4, 8):
            for pods in (1, 2, 3, 4):
                if alive < model:
                    with pytest.raises(RuntimeError):
                        ElasticPlan.plan(alive, model, pods=pods)
                    continue
                p = ElasticPlan.plan(alive, model, pods=pods)
                assert p.n_workers <= alive, (alive, model, pods)
                assert p.mesh_shape[-1] == model
                assert int(np.prod(p.mesh_shape)) == p.n_workers
                assert len(p.mesh_axes) == len(p.mesh_shape)


def test_elastic_plan_shape_makes_the_mesh():
    """The plan's shape and axes feed `make_auto_mesh`: a 1-rank group
    plans (1, 1) over ("data", "model") and gets that mesh."""
    from _torch_dist import local_group
    from repro_torch.launch.mesh import make_auto_mesh
    plan = ElasticPlan.plan(1, model_parallel=1)
    with local_group():
        mesh = make_auto_mesh(plan.mesh_shape, plan.mesh_axes, "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="ranks"):
        with local_group():
            make_auto_mesh(ElasticPlan.plan(4, 2).mesh_shape,
                           ("data", "model"), "cpu")


def test_straggler_detection():
    sm = StragglerMitigator(threshold=1.5, min_steps=3)
    for step in range(6):
        for w in range(8):
            sm.record(w, 1.0 if w != 5 else 2.5)
    assert sm.stragglers() == [5]


def _counter_loop(n_steps, injector, checkpoint_every=4, **kw):
    """Minimal host-only harness for run_with_recovery: state is a step
    counter, metrics are the batch index, checkpoints are dict snapshots."""
    ckpt = {"state": {"step": 0}, "step": 0}

    def step_fn(state, batch):
        return {"step": state["step"] + 1}, batch["idx"]

    def batch_fn(step):
        return {"idx": step}

    def save_fn(state, step):
        ckpt["state"], ckpt["step"] = dict(state), step

    def restore_fn():
        return dict(ckpt["state"]), ckpt["step"]

    return run_with_recovery(step_fn, {"step": 0}, n_steps,
                             batch_fn, save_fn, restore_fn,
                             checkpoint_every=checkpoint_every,
                             failure_injector=injector, **kw)


def test_metrics_log_truncated_on_restore():
    """Regression: restore_fn() rewinds `step` but the old loop kept the
    metrics recorded past the checkpoint, so replayed steps appended
    duplicates (len 16 for a 12-step run failing at step 7 with
    checkpoints every 4).  Post-fix the log is exactly one entry per
    step, in order."""
    fired = {"done": False}

    def injector(step):
        if step == 7 and not fired["done"]:
            fired["done"] = True
            return True
        return False

    state, events, metrics = _counter_loop(12, injector)
    assert state["step"] == 12
    assert len(events) == 1 and events[0].step == 4
    assert metrics == list(range(12))       # no duplicates, right order
    assert len(metrics) == 12


def test_max_restarts_bounds_deterministic_injector():
    """Regression: a deterministic injector firing again at the restored
    step used to loop forever; now the loop raises after max_restarts
    with an actionable message."""
    with pytest.raises(RuntimeError, match="max_restarts"):
        _counter_loop(12, lambda step: step == 5, max_restarts=3)


def test_injected_failure_bitexact_continuation(tmp_path):
    """Kill the run mid-training; the recovered run must produce exactly
    the same final state as an uninterrupted run (stateless data pipeline
    + checkpoint restore)."""
    cfg = reduced(ARCHS["smollm-360m"])
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=50),
                       remat=False)
    step_fn, init_fn = make_train_step(cfg, tcfg, "cpu")
    dcfg = DataConfig(seq_len=16, global_batch=2,
                      vocab_size=cfg.vocab_size)

    def batch_fn(step):
        return {k: torch.from_numpy(v)
                for k, v in batch_for_model(cfg, dcfg, step).items()}

    # ---- uninterrupted reference
    state = init_fn(torch.Generator().manual_seed(0))
    for s in range(12):
        state, _ = step_fn(state, batch_fn(s))
    ref = state

    # ---- interrupted run with recovery
    ckdir = str(tmp_path)
    state2 = init_fn(torch.Generator().manual_seed(0))
    save(ckdir, state2, 0)
    failed = {"done": False}

    def injector(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            return True
        return False

    def save_fn(st, step):
        save(ckdir, st, step)

    def restore_fn():
        steps = latest_steps(ckdir)
        st = restore(ckdir, state2, step=steps[-1])
        return st, int(st["step"])

    final, events, _ = run_with_recovery(
        step_fn, state2, 12, batch_fn, save_fn, restore_fn,
        checkpoint_every=5, failure_injector=injector)

    assert len(events) == 1 and events[0].kind == "failure"
    assert int(final["step"]) == 12
    for a, b in zip(leaves(ref), leaves(final)):
        assert a.dtype == b.dtype and torch.equal(a, b)
