"""Device meshes: the JAX package's `launch/mesh.py` on torch.distributed.

A `Mesh` wraps a `DeviceMesh` and exposes `.shape` as an ordered
{axis name: size} mapping, as a JAX mesh does; that mapping is all the
sharding rules (`runtime/sharding.py`) and the MoE dispatcher read.
`use_mesh` installs an ambient mesh, thread-local as `runtime/parallel.py`
keeps its context; `get_abstract_mesh` returns it, or an empty mesh
(`.shape == {}`) when none is installed.

The reference's `shard_map` has no counterpart: the port's parallel
paths (`models/moe.py`) are functions that every rank runs, with explicit
collectives over the mesh's axis groups (`runtime/parallel.py`).

A mesh needs a process group of its size.  `init_process_group(device)`
starts a 1-rank group when none exists, over a `FileStore` in a temporary
directory (no TCP port): for the card NCCL serves CUDA tensors and gloo
CPU ones, as torch's default group does; for the CPU, gloo alone.  A group
that exists is used as it is, and one that cannot serve the device is
refused.  Multi-rank runs start their group themselves.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import threading
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

_state = threading.local()


class Mesh:
    """A `DeviceMesh` with JAX's view of its shape: `.shape` maps each
    axis name to its size, in the mesh's order.  `Mesh()` is the empty
    mesh that `get_abstract_mesh` returns when none is installed."""

    def __init__(self, device_mesh=None):
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = {}
        if device_mesh is not None:
            # `.shape`, not `.mesh.shape`: newer torch builds the mesh
            # tensor on each read, which a fake tensor mode refuses
            self.shape = dict(zip(device_mesh.mesh_dim_names,
                                  map(int, device_mesh.shape)))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _backend(device) -> str:
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


def init_process_group(device="cuda") -> bool:
    """Start a 1-rank group for `device` unless a group exists; returns
    whether it started one.  Raises if the existing group cannot serve
    `device` (a gloo-only group for the card)."""
    if dist.is_initialized():
        have = str(dist.get_backend())
        need = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if need not in have:
            raise RuntimeError(f"the process group's backend is {have!r}; "
                               f"{device} needs {need}")
        return False
    store = dist.FileStore(os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_pg_"), "store"), 1)
    kwargs = {}
    if torch.device(device).type == "cuda":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(_backend(device), store=store, rank=0,
                            world_size=1, **kwargs)
    return True


def make_auto_mesh(shape: Sequence[int], axes: Sequence[str],
                   device="cuda") -> Mesh:
    """A mesh of `shape` over the named `axes` on `device`'s type,
    covering the whole process group (whose size must be prod(shape))."""
    if not dist.is_initialized():
        raise RuntimeError("make_auto_mesh needs a process group "
                           "(launch.mesh.init_process_group starts one)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs "
                         f"{math.prod(shape)} ranks; the group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(torch.device(device).type, tuple(shape),
                                 mesh_dim_names=tuple(axes)))


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install `mesh` as the ambient mesh for the body."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def get_abstract_mesh() -> Mesh:
    """The ambient mesh, or the empty mesh when none is installed."""
    mesh: Optional[Mesh] = getattr(_state, "mesh", None)
    return mesh if mesh is not None else Mesh()


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks; the 'pod' axis carries cross-pod data
    parallelism.  Raises unless a group of that size is initialised."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device)


def make_host_mesh(device="cuda") -> Mesh:
    """(1, world) over ("data", "model"): every rank of the group on the
    model axis, as the reference's host mesh holds every local device."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return make_auto_mesh((1, world), ("data", "model"), device)
