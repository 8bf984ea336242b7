"""The port's train step on a mesh, on the CPU: four gloo ranks on a
(2, 2) ("data", "model") mesh against the one-process step, and the
checkpoint's elastic restore across meshes.

- A checkpoint written from a (1, 1) mesh (DTensor state, saved whole)
  restores into the (2, 2) mesh's `state_shardings` bit for bit, each
  leaf with its sharding's placements; a state saved from the (2, 2)
  mesh (rank 0 writes, every rank waits for it) restores there too.
- Two AdamW steps from it, and two Adafactor steps with 2 microbatches
  from a fresh state, equal the one-process steps within float32
  tolerance: loss 1e-5 relative; optimizer state 1e-6 absolute; params
  1e-4 where the first moment is clear of zero (1e-3 of the leaf's
  largest), at most one step elsewhere (a gradient near zero may take
  either sign when the shards add in another order; the reasons are in
  `test_torch_train.py`).  Each rank runs its data shard (2 of the 4
  rows), and the gradients come back to the shards summed.
- Each batch leaf's rank shard (`sharding.leaf_shard`): its rows where
  the data axes divide them, else its slice of the sequence (pod-major
  over ("pod", "data")), else the whole leaf, with the split recorded.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import save
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.sharding import (SeqSplit, leaf_shard, place,
                                         state_shardings)
from repro_torch.tree import named_leaves

from _torch_dist import finish, local_group, start_ranks
from _torch_dist_worker import fp32_state, train_batches, train_setup

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-6
PARAM_ATOL = 1e-4
STEP_BOUND = 1e-3 * 1.1
TIMEOUT_S = 150


def _flat(tree):
    return {"/".join(p): t for p, t in named_leaves(tree)}


def _run_meshless(opt, microbatches, state):
    cfg, (step_fn, _) = train_setup(opt=opt, microbatches=microbatches)
    losses = []
    for batch in train_batches(cfg):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return losses, _flat(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_train")
    _, (_, init_adamw) = train_setup()
    state = fp32_state(init_adamw)
    with local_group():
        mesh = make_host_mesh("cpu")
        save(str(work / "ckpt"), place(state, state_shardings(
            mesh, state, "adamw")), 0)
    started = start_ranks("train", 4, work)
    try:
        want = {"saved": _flat(state),
                "adamw": _run_meshless("adamw", 1, state)}
        _, (_, init_ada) = train_setup(opt="adafactor", microbatches=2)
        want["adafactor"] = _run_meshless("adafactor", 2,
                                          fp32_state(init_ada))
    finally:
        got = finish(started, TIMEOUT_S)
    return got, want


def test_checkpoint_from_1x1_restores_exactly_into_2x2(runs):
    got, want = runs
    for rank in got:
        assert rank["restored"].keys() == want["saved"].keys()
        for name, t in want["saved"].items():
            r = rank["restored"][name]
            assert r.dtype == t.dtype and torch.equal(r, t), name
        for name, (have, spec) in rank["placements"].items():
            assert have == spec, name
    # saved from the 4 ranks (rank 0 writes) and restored by all of them
    assert all(rank["resaved_exact"] for rank in got)
    # the rules shard something on each axis of this mesh
    placed = " ".join(h for h, _ in got[0]["placements"].values())
    assert "Shard(dim=0)" in placed and "Shard(dim=1)" in placed


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_steps_on_2x2_mesh_match_one_process(runs, opt):
    got, want = runs
    want_losses, want_state = want[opt]
    old = want["saved"]
    for rank in got:
        np.testing.assert_allclose(rank[opt]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        state = rank[opt]["state"]
        assert state.keys() == want_state.keys()
        for name, w in want_state.items():
            g = state[name]
            if name.startswith("opt/") or name == "step":
                torch.testing.assert_close(g, w, rtol=0, atol=STATE_ATOL,
                                           msg=name)
                continue
            mu = want_state.get("opt/mu/" + name[len("params/"):])
            if mu is None:
                settled = torch.ones_like(w, dtype=torch.bool)
            else:
                settled = mu.abs() > 1e-3 * mu.abs().max()
            torch.testing.assert_close(g[settled], w[settled], rtol=0,
                                       atol=PARAM_ATOL, msg=name)
            assert float((g - w).abs().max()) <= 2 * STEP_BOUND, name
    # the steps moved the params
    assert any(not torch.equal(want_state[n], old[n]) for n in old
               if n.startswith("params/"))


class _Mesh:
    """A mesh as the rules see it: axis sizes, this rank's indices (0
    unless given)."""

    def __init__(self, index=None, **shape):
        self.shape, self._index = shape, index or {}

    def index(self, axis):
        return self._index.get(axis, 0)


def test_each_leaf_takes_its_rank_shard_by_its_batch_spec():
    x = torch.arange(3 * 8 * 2).reshape(3, 8, 2)
    # rows that divide the data axes: the rank's rows, no split
    got, split = leaf_shard(_Mesh({"data": 1}, data=2, model=2),
                            torch.arange(4 * 8).reshape(4, 8))
    assert split is None and torch.equal(got, torch.arange(16, 32).reshape(
        2, 8))
    # 3 rows on 2 ranks of 'data': the rank's slice of the sequence
    got, split = leaf_shard(_Mesh({"data": 1}, data=2, model=2), x)
    assert split == SeqSplit(("data",), 4, 8)
    assert torch.equal(got, x[:, 4:8])
    # over ("pod", "data"): pod-major, as the reference orders them
    got, split = leaf_shard(_Mesh({"pod": 1, "data": 0}, pod=2, data=2), x)
    assert split == SeqSplit(("pod", "data"), 4, 8)
    assert torch.equal(got, x[:, 4:6])
    # neither the rows nor the sequence divide: the whole leaf
    got, split = leaf_shard(_Mesh(data=2, model=2), x[:, :7])
    assert split == SeqSplit((), 0, 7) and torch.equal(got, x[:, :7])
    # one rank on the data axes: every row
    got, split = leaf_shard(_Mesh(data=1, model=4), x)
    assert split is None and torch.equal(got, x)


def test_kernel_wrappers_reject_dtensors():
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    with local_group():
        mesh = make_host_mesh("cpu")

        def dt(t):
            return distribute_tensor(t, mesh.device_mesh, [Replicate()] * 2)

        with pytest.raises(TypeError, match="DTensor"):
            rmsnorm(dt(torch.ones(4, 8)), torch.ones(8))
        q = torch.ones(1, 4, 2, 8)
        pos = torch.arange(4, dtype=torch.int32)
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention(dt(q), q, q, pos, pos)
        with pytest.raises(TypeError, match="DTensor"):
            ssd(dt(torch.ones(1, 8, 2, 4)), torch.ones(1, 8, 2),
                -torch.ones(2), torch.ones(1, 8, 4), torch.ones(1, 8, 4))
