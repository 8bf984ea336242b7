"""Divisibility-aware partition rules: param path -> PartitionSpec, and
the DTensor placements that realise a spec on a mesh.

A port of the JAX package's `runtime/sharding.py`; the rules are the
reference's, spec for spec (megatron-style TP x FSDP x DP on mesh axes
("pod",) "data", "model"):

- weight matrices: tensor-parallel on the dimension that maps to heads /
  d_ff / experts ('model'), FSDP on the complementary dimension ('data');
- a dimension is only assigned to a mesh axis when the axis size divides
  it, else the rule falls down a preference list and finally to
  replication;
- activations: batch on ("pod", "data"); a batch whose rows those axes
  do not divide shards its sequence there instead (context parallelism,
  `leaf_shard`), or, where that does not divide either, is replicated;
- KV caches: batch on ("pod", "data"), kv-heads on 'model' when
  divisible, else sequence on 'model'.

The rules read only `mesh.shape` (axis name -> size), so they run on any
object that has one, a stub standing for 256 ranks included.  A spec is
`P`, a tuple whose entries are None, an axis name, or a tuple of names
(one tensor dim over several mesh axes, the first major).
`*_shardings` return `NamedSharding`s, whose placements on a real mesh
come from `spec_to_placements`.

What a rank computes with is the data axes' gather of its shard:
`compute_spec` keeps the 'model' entry of the weights that the model
code multiplies tensor-parallel (Megatron's column- and row-parallel
products, the Mamba2 mixer's projections, the vocab-parallel embedding
and unembedding, an MoE block's expert stacks at their path's shard)
and drops every other entry; `shard_slices` gives this rank's slice of each dimension of
a spec'd tensor (the vocabulary's, the sequence's and the rows' offsets
included), so that the model code asks the rules and never recomputes
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple


class P(tuple):
    """A PartitionSpec: `P("data", None)`, `P(("pod", "data"), "model")`.

    A one-name tuple entry is stored as the name, as JAX stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return int(mesh.shape[axis])


def _fits(mesh, dim: int, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _choose(mesh, shape: Tuple[int, ...], prefs) -> P:
    """prefs: per-dim list of candidate axes in preference order."""
    taken = set()
    spec: list = []
    for dim, cands in zip(shape, prefs):
        chosen = None
        for ax in cands:
            if ax is None:
                break
            flat = ax if isinstance(ax, tuple) else (ax,)
            if any(a in taken for a in flat):
                continue
            if _fits(mesh, dim, ax):
                chosen = ax
                taken.update(flat)
                break
        spec.append(chosen)
    return P(*spec)


DATA_AXES = ("pod", "data")


def _data(mesh):
    """The (possibly pod-extended) FSDP/data axis present in this mesh."""
    return tuple(a for a in DATA_AXES if a in mesh.shape) or (None,)


def param_spec(mesh, path: str, shape: Tuple[int, ...]) -> P:
    """Sharding rule for one parameter tensor, by name and rank."""
    fsdp = _data(mesh)
    if fsdp == (None,):
        fsdp = None
    last = path.split("/")[-1]

    def choose(*prefs):
        # strip leading stacked-unit axes (they stay unsharded)
        extra = len(shape) - len(prefs)
        return _choose(mesh, shape,
                       [[None]] * extra + [list(p) for p in prefs])

    if last in ("table",):            # (V, d): vocab-parallel embedding
        return choose(["model", None], [None])
    if last == "unembed":             # (d, V)
        return choose([None], ["model", None])
    if last in ("wq", "wk", "wv"):    # (d, H*hd): TP on the fused head dim
        return choose([fsdp, None], ["model", None])
    if last == "wo":                  # (H*hd, d)
        return choose(["model", None], [fsdp, None])
    if last in ("w_up", "w_gate"):    # (d, ff) or (E, d, ff)
        if len(shape) >= 3:           # expert-parallel; else TP on ff
            return choose(["model", None], [fsdp, None], ["model", None])
        return choose([fsdp, None], ["model", None])
    if last == "w_down":              # (ff, d) or (E, ff, d)
        if len(shape) >= 3:
            return choose(["model", None], ["model", None], [fsdp, None])
        return choose(["model", None], [fsdp, None])
    if last == "router":              # (d, E)
        return choose([fsdp, None], [None])
    if last in ("in_proj", "out_proj"):   # mamba: TP on d_inner side
        if last == "in_proj":
            return choose([fsdp, None], ["model", None])
        return choose(["model", None], [fsdp, None])
    if last in ("conv_w", "conv_b"):
        return choose(*[[None]] * len(shape))
    # norms, biases, scalars: replicated
    return P(*([None] * len(shape)))


#: weights computed tensor-parallel when the rules put 'model' on this
#: dimension (counted from the end): column-parallel projections and the
#: vocab-parallel unembedding, row-parallel output projection, the
#: vocab-parallel table, the Mamba2 mixer's column-parallel `in_proj`
#: and row-parallel `out_proj`; the dense MLP's under an "mlp" key (an
#: MoE block's stacks take their path's, `MOE_DIMS`)
TP_DIMS = {"wq": -1, "wk": -1, "wv": -1, "unembed": -1, "wo": -2,
           "table": -2, "in_proj": -1, "out_proj": -2}
MLP_TP_DIMS = {"w_up": -1, "w_gate": -1, "w_down": -2}
#: an MoE block's expert stacks, (E, d, ff) and (E, ff, d): the
#: dimension each explicit path computes split over 'model' (the
#: expert axis, or the expert hidden dim); the dropless path computes
#: on the stacks as placed (`compute_spec`)
MOE_DIMS = {"expert": {"w_gate": -3, "w_up": -3, "w_down": -3},
            "tp_ff": {"w_gate": -1, "w_up": -1, "w_down": -2},
            "dropless": {}}


def is_moe_stack(path: str) -> bool:
    names = path.split("/")
    return names[-2:-1] == ["moe"] and names[-1] in MLP_TP_DIMS


def tp_dim(path: str) -> Optional[int]:
    """The dimension (counted from the end) on which the weight at `path`
    is computed tensor-parallel when the rules put 'model' there, or
    None (`TP_DIMS`, `MLP_TP_DIMS`; an expert stack's is its path's)."""
    names = path.split("/")
    if is_moe_stack(path):
        return None
    dims = MLP_TP_DIMS if names[-2:-1] == ["mlp"] else TP_DIMS
    return dims.get(names[-1])


def compute_spec(mesh, path: str, shape: Tuple[int, ...],
                 moe: Optional[str] = None) -> P:
    """The spec of a parameter as a rank computes with it: 'model' on the
    dimension `param_spec` gives it for a tensor-parallel weight, nothing
    elsewhere (the data axes are gathered, and a weight sharded over
    'model' on any other dimension, such as a stacked unit axis, is
    gathered whole).

    An MoE block's expert stack is computed as the block's path `moe`
    takes it ("expert", "tp_ff", "dropless", `MOE_DIMS`; the dispatcher,
    `models/moe.py: moe_path`, chooses): 'model' on the expert axis or
    on the expert hidden dim, where the mesh has 'model', else whole;
    the dropless path computes on the stack as placed (`param_spec`:
    GSPMD's partial products on the shards, `models/moe.py`).  A stack
    without its path raises."""
    n = len(shape)
    if is_moe_stack(path):
        if moe not in MOE_DIMS:
            raise ValueError(f"{path}: an expert stack's compute spec "
                             f"needs its path, not {moe!r}")
        if moe == "dropless":
            return param_spec(mesh, path, shape)
        d = MOE_DIMS[moe].get(path.split("/")[-1])
        keep = d is not None and _axis_size(mesh, "model") > 1
        if keep and shape[n + d] % _axis_size(mesh, "model"):
            raise ValueError(f"{path} {shape}: 'model' does not divide "
                             f"dim {d} for the {moe} path")
        return P(*["model" if keep and i == n + d else None
                   for i in range(n)])
    d = tp_dim(path)
    spec = param_spec(mesh, path, shape)
    keep = (d is not None and _axis_size(mesh, "model") > 1
            and spec[n + d] == "model")
    return P(*["model" if keep and i == n + d else None for i in range(n)])


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_slices(mesh, spec: P, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    """This rank's slice of each dimension of a `shape` tensor placed by
    `spec` (an entry over several axes splits its dimension major axis
    first, as the placements do).  `mesh` needs `.shape` and `.index`."""
    out = []
    for dim, n in enumerate(shape):
        axes = _axes_of(spec[dim] if dim < len(spec) else None)
        k, i = 1, 0
        for a in axes:
            k, i = k * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def slot_rows(mesh, x):
    """This rank's rows of a (rows, ...) tensor under `batch_spec`: its
    shard over the data axes, or every row when they do not divide."""
    spec = batch_spec(mesh, tuple(x.shape))
    return x if spec[0] is None else \
        x[shard_slices(mesh, spec, tuple(x.shape))[0]]


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A batch leaf whose rows do not divide over the data axes, as a
    rank holds it (`leaf_shard`): positions [offset, offset + length /
    ranks) of each row's `length`, its part of the sequence over `axes`
    (their ranks in order, the first major), or, with no `axes`, the
    whole leaf, every rank the same."""
    axes: Tuple[str, ...]
    offset: int
    length: int


def leaf_shard(mesh, x) -> Tuple[Any, Optional[SeqSplit]]:
    """(this rank's shard of a global batch leaf under its `batch_spec`,
    the split it holds): its rows over the data axes (split None) where
    they divide the rows; else its slice of dim 1, which they divide;
    else the whole leaf (a `SeqSplit` over no axes)."""
    shape = tuple(x.shape)
    spec = batch_spec(mesh, shape)
    cut = shard_slices(mesh, spec, shape)
    if spec[0] is not None:
        return x[cut[0]], None
    if len(shape) < 2:
        return x, SeqSplit((), 0, 1)
    axes = _axes_of(spec[1])
    return x[:, cut[1]], SeqSplit(axes, cut[1].start, shape[1])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (`jax.sharding.NamedSharding`)."""
    mesh: Any
    spec: P

    @property
    def placements(self):
        return spec_to_placements(self.mesh, self.spec)


def spec_to_placements(mesh, spec: P):
    """The DTensor placements, one per mesh axis, that shard a tensor as
    `spec` does: `Shard(i)` on each axis named in entry i, `Replicate()`
    on the rest.  An entry naming several axes shards dim i over them
    with the first major (JAX's order), which DTensor's left-to-right
    order of mesh dims gives when the entry lists them in the mesh's
    order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.shape)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"{spec}: entry {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in where:
            if placements[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} used twice")
            placements[i] = Shard(dim)
    return tuple(placements)


def _map_named(fn, tree, prefix: Tuple[str, ...] = ()):
    """fn("/"-joined key path, leaf) over a nested dict, structure kept."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def params_shardings(mesh, params_tree: Any):
    """Tree of NamedShardings matching a params tree (leaves need only
    `.shape`)."""
    return _map_named(
        lambda name, x: NamedSharding(mesh, param_spec(mesh, name,
                                                       tuple(x.shape))),
        params_tree)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def opt_shardings(mesh, params_tree: Any, opt_name: str):
    """Optimizer-state shardings mirroring the optimizers' init structure.

    AdamW mu/nu inherit the parameter spec; Adafactor's factored vr/vc
    take the parameter spec minus the reduced dimension."""
    def per_param(name, x):
        shape = tuple(x.shape)
        spec = param_spec(mesh, name, shape)
        ns = NamedSharding(mesh, spec)
        if opt_name == "adamw":
            return ns
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if _factored(shape):
            return {"vr": NamedSharding(mesh, P(*parts[:-1])),
                    "vc": NamedSharding(mesh, P(*(parts[:-2] + parts[-1:])))}
        return {"v": ns}

    tree = _map_named(per_param, params_tree)
    if opt_name == "adamw":
        return {"mu": tree, "nu": tree}
    return {"v": tree}


def state_shardings(mesh, abstract_state: Any, opt_name: str):
    """Shardings for the full train state {params, opt, step}."""
    return {
        "params": params_shardings(mesh, abstract_state["params"]),
        "opt": opt_shardings(mesh, abstract_state["params"], opt_name),
        "step": NamedSharding(mesh, P()),
    }


def batch_spec(mesh, shape: Tuple[int, ...], kind: str = "tokens") -> P:
    """Activation/batch sharding: batch over ("pod", "data"); batch=1
    long-context shapes shard the sequence axis (context parallel)."""
    fsdp = _data(mesh)
    batch = shape[0]
    if batch % _axis_size(mesh, fsdp) == 0:
        rest = [None] * (len(shape) - 1)
        return P(fsdp, *rest)
    if len(shape) >= 2 and shape[1] % _axis_size(mesh, fsdp) == 0:
        return P(None, fsdp, *([None] * (len(shape) - 2)))
    return P(*([None] * len(shape)))


def cache_spec(mesh, shape: Tuple[int, ...]) -> P:
    """KV / SSM cache sharding (leading stacked-unit axes unsharded).

    KV caches arrive as (units..., B, L, kv_heads, hd) and SSM states as
    (units..., B, H, P, N)."""
    fsdp = _data(mesh)
    n_extra = max(0, len(shape) - 4)
    body = shape[n_extra:]
    spec: list = [None] * n_extra
    # batch axis
    if body and body[0] % _axis_size(mesh, fsdp) == 0:
        spec.append(fsdp)
        used_data = True
    else:
        spec.append(None)
        used_data = False
    rest = list(body[1:])
    # shard heads (axis -2) on model if divisible, else the seq axis
    model_done = False
    for i, dim in enumerate(rest):
        axis = None
        if not model_done and i == 1 and dim % _axis_size(mesh, "model") == 0:
            axis = "model"
            model_done = True
        spec.append(axis)
    if not model_done:
        # fall back: sequence (first body-rest axis) on model when divisible
        if rest and rest[0] % _axis_size(mesh, "model") == 0:
            spec[n_extra + 1] = "model"
        elif not used_data and rest and \
                rest[0] % _axis_size(mesh, fsdp) == 0:
            spec[n_extra + 1] = fsdp
    return P(*spec)


def cache_shardings(mesh, cache_tree: Any):
    return _map_named(
        lambda _, x: NamedSharding(mesh, cache_spec(mesh, tuple(x.shape))),
        cache_tree)


def logical_batch_shardings(mesh, batch_tree: Any):
    return _map_named(
        lambda _, x: NamedSharding(mesh, batch_spec(mesh, tuple(x.shape))),
        batch_tree)


def place(tree: Any, shardings: Any):
    """Each leaf of `tree` as a DTensor placed by the matching sharding
    (a tree of NamedShardings of the same structure): a DTensor is
    redistributed where its placements differ, a plain tensor, which
    every rank holds whole, is cut to this rank's shard (the
    reference's `device_put` / `out_shardings`).  Where that shard is
    the whole tensor (every axis the spec names holds one rank, as on a
    one-rank mesh), the DTensor wraps the tensor itself: no copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    placements = shardings.placements
    if isinstance(tree, DTensor):
        if tuple(tree.placements) == placements:
            return tree
        return tree.redistribute(tree.device_mesh, placements)
    mesh = shardings.mesh
    if all(_axis_size(mesh, e) == 1 for e in shardings.spec):
        return DTensor.from_local(tree, mesh.device_mesh, placements,
                                  run_check=False, shape=tree.shape,
                                  stride=tree.stride())
    return distribute_tensor(tree, mesh.device_mesh, placements,
                             src_data_rank=None)
