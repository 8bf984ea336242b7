"""The port's meshes and parallel context (`launch/mesh.py`,
`runtime/parallel.py`) against the reference's API: the ambient mesh,
the production meshes (on torch's fake process group of 256 and 512
ranks), the host mesh of a 1-rank group, the context's defaults, and
`shard_batch` on a DTensor."""

import threading

import pytest
import torch
import torch.distributed as dist

from repro.runtime.parallel import ParallelContext as JContext
from repro_torch.launch.mesh import (get_abstract_mesh, init_process_group,
                                     make_host_mesh, make_production_mesh,
                                     use_mesh)
from repro_torch.runtime.parallel import (ParallelContext, get_context,
                                          parallel_context, shard_batch)
from repro_torch.runtime.serve import slot_rows

from _torch_dist import local_group


def test_context_defaults_are_the_reference_s():
    assert ParallelContext() == ParallelContext(**vars(JContext()))
    assert ParallelContext().expert_axis == "model"
    assert ParallelContext().data_axes == ("data",)
    assert ParallelContext().capacity_factor == 1.25


def test_ambient_mesh_and_context_nest_and_stay_in_their_thread():
    assert get_abstract_mesh().shape == {} and get_context() is None
    with local_group():
        mesh = make_host_mesh("cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            seen = {}
            t = threading.Thread(target=lambda: seen.update(
                mesh=get_abstract_mesh().shape, ctx=get_context()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            assert seen == {"mesh": {}, "ctx": None}
            assert get_abstract_mesh() is mesh
            with parallel_context(ParallelContext(capacity_factor=8.0)):
                assert get_context().capacity_factor == 8.0
            assert get_context() == ParallelContext()
        assert get_abstract_mesh().shape == {} and get_context() is None
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.device_type == "cpu"


@pytest.mark.parametrize("multi_pod,world,shape", [
    (False, 256, {"data": 16, "model": 16}),
    (True, 512, {"pod": 2, "data": 16, "model": 16})])
def test_production_meshes_on_the_fake_group(multi_pod, world, shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.shape == shape
        assert mesh.index("model") == 3 and mesh.index("data") == 0
    finally:
        dist.destroy_process_group()


def test_meshes_need_a_group_of_their_size():
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh("cpu")
    with local_group():
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")


def test_a_gloo_group_cannot_serve_the_card():
    with local_group():
        assert init_process_group("cpu") is False    # the group is reused
        with pytest.raises(RuntimeError, match="nccl"):
            init_process_group("cuda")


def test_shard_batch_pins_a_dtensor_to_the_data_axes():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.ones(4, 8)
    assert shard_batch(x) is x
    with local_group():
        mesh = make_host_mesh("cpu")
        dt = distribute_tensor(x, mesh.device_mesh, [Replicate()] * 2)
        assert shard_batch(dt) is dt                  # no context
        with parallel_context(ParallelContext()):
            assert shard_batch(x) is x                # a local tensor
            pinned = shard_batch(dt)
            assert tuple(pinned.placements) == (Shard(0), Replicate())
            assert torch.equal(pinned.full_tensor(), x)
            odd = distribute_tensor(torch.ones(8), mesh.device_mesh,
                                    [Replicate()] * 2)
            assert shard_batch(odd) is odd            # 1-d: unchanged


class _Mesh:
    def __init__(self, index=0, **shape):
        self.shape = shape
        self._index = index

    def index(self, axis):
        return self._index if axis == "data" else 0


def test_serve_loop_refuses_a_mesh_that_shards_the_slots():
    """The name is kept from when the loop refused a mesh whose data axes
    shard the slots.  The refusal is gone: the launcher has no
    `check_slots_unsharded`, and feeds each rank through `slot_rows`, its
    rows of the slots over the data axes, or every slot when they do not
    divide (`test_torch_tensor_parallel.py` serves on four ranks)."""
    import repro_torch.launch.serve as launcher
    assert not hasattr(launcher, "check_slots_unsharded")
    assert launcher.slot_rows is slot_rows
    feed = torch.arange(8)[:, None]
    assert slot_rows(_Mesh(index=1, data=2, model=4), feed).flatten(
        ).tolist() == [4, 5, 6, 7]
    assert torch.equal(slot_rows(_Mesh(index=1, data=2, model=4),
                                 feed[:3]), feed[:3])
