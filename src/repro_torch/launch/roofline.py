"""Roofline of one call of the port, counted under fake tensors.

Three terms per call, as the JAX package's `launch/roofline.py` has them:

    t_compute    = FLOPs_per_device / PEAK_FLOPS
    t_memory     = bytes_per_device / HBM_BW
    t_collective = collective_link_bytes_per_device / (NVLINK_LINKS * NVLINK_BW)

The constants are one NVIDIA H100 SXM's, from its datasheet
(https://www.nvidia.com/en-us/data-center/h100/): 989 TFLOP/s of dense
bf16, 3.35 TB/s of HBM3, and 18 NVLink-4 links of 25 GB/s each way.  The
datasheet's 900 GB/s of NVLink counts both directions; the ring model
below counts the bytes one device sends, as the reference's does.  The
production meshes, (16, 16) and (2, 16, 16), are read as one NVLink
Switch domain of 256 (512) cards; across nodes a card has about 50 GB/s
of InfiniBand, so `t_collective` is optimistic for a mesh that crosses
nodes.

Where the reference compiles the program and reads XLA's
`cost_analysis()` and HLO text, `count(fn, *args)` runs `fn` once under
`FakeTensorMode` (shapes and dtypes, no data, no allocation) with three
modes on:

- `FlopCounterMode`, with a formula for `aten._grouped_mm` (the
  dropless MoE block's products), which torch does not count;
- a dispatch mode that adds up the input and output bytes of every aten
  operation that is not a view: every intermediate read and written
  once per use, an unfused upper bound, as XLA's `bytes accessed` is
  one (a kernel that fuses moves less; `Extras.floor_bytes`, arguments
  read once and outputs written once, is the other end);
- a recorder of the process group's collectives, functional
  (`_c10d_functional.*`, DTensor's redistributions) and in place
  (`c10d.*_`, the MoE paths' autograd collectives), each named as the
  reference names its HLO op and counted by its result's bytes, as the
  reference reads each op's result type: the gathered buffer of an
  all-gather, the shard of a reduce-scatter, the tensor of an all-reduce.

A fake process group (`fake_group`) gives a mesh of any size in one
process: its collectives return at once, and their shapes are right.
Counts are rank 0's.  Tensors are counted by their local shard, so a
DTensor's bytes are this rank's; a product of DTensors would count its
global FLOPs, but the port's paths take none (weights are gathered
first).  The port runs every unit of its loops, so the count covers the
whole program and nothing is extrapolated (the reference counts a scan
body once and adds `k` single-unit programs).

`MemTracker` (torch's memory tracker) gives the peak of live tensors on
rank 0 over the call, the arguments included; XLA's temporary and
generated-code sizes have no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM, datasheet, per card
PEAK_FLOPS = 989e12          # dense bf16
HBM_BW = 3.35e12             # B/s
NVLINK_BW = 25e9             # B/s per link, each way
NVLINK_LINKS = 18

# link bytes per payload byte for a ring schedule over n shards (n large)
_RING_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d operation (functional or in place) -> the reference's HLO op name
# (HLO has no broadcast: one rank's tensor sent to the others is a
# collective-permute fan-out there)
_COLLECTIVE_NAMES = (
    ("broadcast", "collective-permute"),
    ("reduce_scatter", "reduce-scatter"),
    ("allgather", "all-gather"), ("all_gather", "all-gather"),
    ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
    ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)
_C10D_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_NOT_TRAFFIC = ("wait_tensor", "barrier", "monitored_barrier")


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, float]
    payload_bytes: float          # sum of payloads
    link_bytes: float             # ring-multiplied

    def __add__(self, o: "CollectiveStats") -> "CollectiveStats":
        per = dict(self.per_op)
        for k, v in o.per_op.items():
            per[k] = per.get(k, 0.0) + v
        return CollectiveStats(per, self.payload_bytes + o.payload_bytes,
                               self.link_bytes + o.link_bytes)

    @staticmethod
    def zero() -> "CollectiveStats":
        return CollectiveStats({}, 0.0, 0.0)


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    coll_link_bytes: float        # per device
    coll_per_op: Dict[str, float]

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_link_bytes / (NVLINK_LINKS * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap upper bound; with perfect overlap it is the max."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_link_bytes": self.coll_link_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "coll_per_op": self.coll_per_op,
        }


@dataclasses.dataclass
class Extras:
    """What `count` measures beside the roofline's terms (rank 0's)."""
    argument_bytes: int           # the call's tensor arguments
    output_bytes: int             # the tensors it returns
    peak_bytes: int               # live tensors at their peak (MemTracker)
    flops_by_op: Dict[str, int]   # FlopCounterMode's totals by aten op
    coll_calls: Dict[str, int]    # collectives issued, by op name

    @property
    def floor_bytes(self) -> int:
        """Arguments read once and outputs written once: the least any
        implementation of the call moves."""
        return self.argument_bytes + self.output_bytes

    @property
    def t_floor(self) -> float:
        return self.floor_bytes / HBM_BW


def model_flops(param_count: int, active_param_count: int, tokens: int,
                mode: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * active_param_count * tokens


# --------------------------------------------------------------------------
# counting
# --------------------------------------------------------------------------

def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """2 flops a MAC of `torch._grouped_mm`, whatever its offsets hold:
    2-D x 3-D (rows, d) x (E, d, f) and 3-D x 2-D contract a dense dim;
    2-D x 2-D (d, rows) x (rows, f), autograd's weight gradient, runs the
    groups along the contraction and returns (E, d, f)."""
    if len(a_shape) == 2 and len(b_shape) == 2:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]
    return 2 * math.prod(out_shape) * a_shape[-1]


def flop_counter() -> "torch.utils.flop_counter.FlopCounterMode":
    """A FlopCounterMode that also counts `aten._grouped_mm` (passed as
    its own mapping, so torch's registry stays as it is)."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten._grouped_mm: _grouped_mm_flops})


def _tensors(tree):
    """The tensors in a nested dict / list / tuple, in order (a unit's
    `UnitShard`: its shard)."""
    from ..runtime.parallel import UnitShard
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, UnitShard):
        yield tree.local
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of the tensors of `tree` held by this rank (a DTensor's local
    shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def _collective_name(func) -> str:
    name = func.__name__
    for key, op in _COLLECTIVE_NAMES:
        if key in name:
            return op
    raise NotImplementedError(f"the roofline has no name for the "
                              f"collective {func}")


def _written(func, args, kwargs, out):
    """The tensors an operation writes: its mutated arguments, else its
    results, else its first argument (c10d's in-place operations take
    their output first, and some, `alltoall_base_`, do not mark it)."""
    schema = func._schema
    hit = []
    for i, a in enumerate(schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            hit.extend(_tensors(v))
    return hit or list(_tensors(out)) or list(_tensors(args[:1]))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds up the bytes of every non-view aten operation and records
    each collective of the process group."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0
        self.coll = CollectiveStats.zero()
        self.coll_calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _C10D_NAMESPACES:
            if func.__name__.split(".")[0] not in _NOT_TRAFFIC:
                op = _collective_name(func)
                nbytes = local_bytes(_written(func, args, kwargs, out))
                self.coll = self.coll + CollectiveStats(
                    {op: float(nbytes)}, nbytes, nbytes * _RING_FACTOR[op])
                self.coll_calls[op] = self.coll_calls.get(op, 0) + 1
        elif not _is_view(func):
            self.op_bytes += local_bytes(args) + local_bytes(kwargs) + \
                local_bytes(out)
        return out


def _fake_mode_of(tree):
    for t in _tensors(tree):
        mode = getattr(_local(t), "fake_mode", None)
        if mode is not None:
            return mode
    return None


@contextlib.contextmanager
def _propagation_apart():
    """DTensor's sharding propagation runs each new op on whole-shape fake
    tensors; under the count's modes MemTracker would count those as the
    rank's memory (its step's peak read as the whole model's state), and
    the other modes their FLOPs and bytes.  In the body propagation runs
    with every Python dispatch mode popped, under a fake mode of its own,
    so none of the count's modes sees it.  (A fake mode of its own alone
    is not enough: torch 2.11's MemTracker, still on the stack, counted
    the tensors made under it.)"""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def apart(self, op_schema):
        with _disable_current_modes():
            return real(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def count(fn, *args, **kwargs) -> Tuple[Roofline, Extras]:
    """Run `fn(*args, **kwargs)` once under fake tensors and count it.

    The tensor arguments are fake tensors (or DTensors of fake tensors)
    made under one FakeTensorMode, which the call runs under, so that it
    allocates nothing.  Returns the roofline's terms of rank 0 and the
    `Extras`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    mode = _fake_mode_of((args, kwargs)) or FakeTensorMode()
    flops, rec, mem = flop_counter(), _Recorder(), MemTracker()
    mem.track_external(*_tensors((args, kwargs)))
    with mode, flops, rec, mem, _propagation_apart():
        out = fn(*args, **kwargs)
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    roofline = Roofline(float(flops.get_total_flops()), float(rec.op_bytes),
                        rec.coll.link_bytes, rec.coll.per_op)
    by_op = {str(k): int(v)
             for k, v in flops.get_flop_counts().get("Global", {}).items()}
    extras = Extras(local_bytes((args, kwargs)), local_bytes(out), int(peak),
                    by_op, dict(rec.coll_calls))
    return roofline, extras


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of `world` ranks, this process rank 0, for the
    body: collectives return at once with the right shapes.  Refuses to
    start when a group exists (one default group per process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists; the fake group needs "
                           "the process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
