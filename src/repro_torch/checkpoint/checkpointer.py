"""Sharded checkpointing with an integrity manifest, in the JAX package's
on-disk format.

Layout (as `src/repro/checkpoint/checkpointer.py` writes it):

    <dir>/step_<N>/
        manifest.json      -- step, leaves (name, shard, key, shape, dtype),
                              shards (file, sha256)
        shard_<i>.npz      -- leaf arrays, ~256 MB per file

Leaf names are the "/"-joined dict keys, dict keys visited in sorted
order as `jax.tree_util` visits them (`opt/mu/units/b0/attn/wq`,
`step`); dtypes are numpy's names ("bfloat16", "float32", "int32"), and
bfloat16 is stored as its uint16 bits.  So a checkpoint the JAX package
wrote restores here and the other way round.  bfloat16 is read back
through an int16 view into `torch.bfloat16` (no `ml_dtypes` needed).

Properties the training loop depends on: a save is atomic (written to a
temporary directory, fsync'd, then renamed), integrity is checked (every
shard's sha256 is verified before any tensor is built), `AsyncCheckpointer`
writes on a background thread after one device-to-host copy, and the
data pipeline is step-indexed, so {state, step} is the whole restart
state.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import named_leaves, tree_map

SHARD_BYTES = 256 * 2**20


def _flatten(tree: Any):
    named = list(named_leaves(tree))
    return ["/".join(path) for path, _ in named], [x for _, x in named]


def _to_numpy(leaf: Any):
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # npz-safe; dtype kept in manifest
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":    # an ml_dtypes array (a JAX tree)
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _sha256(fp: str) -> str:
    with open(fp, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save(path: str, tree: Any, step: int) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays).
    Returns the final checkpoint directory."""
    names, leaves = _flatten(tree)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_ckpt_")
    manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes, shard_idx = 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        fn = f"shard_{shard_idx:05d}.npz"
        fp = os.path.join(tmp, fn)
        np.savez(fp, **shard)
        manifest["shards"].append({"file": fn, "sha256": _sha256(fp)})
        shard, shard_bytes = {}, 0
        shard_idx += 1

    for name, leaf in zip(names, leaves):
        arr, dtype = _to_numpy(leaf)
        key = name.replace("/", "__")
        manifest["leaves"].append({
            "name": name, "shard": shard_idx, "key": key,
            "shape": list(arr.shape), "dtype": dtype})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _host_copy(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Background-thread writer: save_async returns after the
    device-to-host copy; wait() joins the write in flight and raises the
    error it met, if any."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(path, exist_ok=True)

    def save_async(self, tree: Any, step: int) -> None:
        self.wait()
        host_tree = tree_map(_host_copy, tree)

        def run():
            try:
                save(self.path, host_tree, step)
                self._gc()
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(latest_steps(self.path))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)


def latest_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and os.path.isfile(
                os.path.join(path, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")     # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like: Any, step: Optional[int] = None,
            device=None, verify: bool = True) -> Any:
    """Restore the checkpoint at `step` (the latest by default) into the
    structure of `like`, each leaf in the dtype the manifest records.

    Each leaf goes to `device`; with device=None, to the device of the
    matching tensor in `like` (the card for a leaf of another kind)."""
    steps = latest_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    step = steps[-1] if step is None else step
    cdir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(cdir, "manifest.json")) as f:
        manifest = json.load(f)
    if verify:
        for sh in manifest["shards"]:
            if _sha256(os.path.join(cdir, sh["file"])) != sh["sha256"]:
                raise IOError(f"checkpoint shard corrupt: {sh['file']}")
    shards: Dict[int, Any] = {}
    by_name = {}
    try:
        for leaf in manifest["leaves"]:
            si = leaf["shard"]
            if si not in shards:
                shards[si] = np.load(os.path.join(
                    cdir, manifest["shards"][si]["file"]))
            by_name[leaf["name"]] = _to_torch(shards[si][leaf["key"]],
                                              leaf["dtype"])
    finally:
        for npz in shards.values():
            npz.close()

    def place(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: place(v, prefix + (str(k),)) for k, v in tree.items()}
        dev = device if device is not None else (
            tree.device if isinstance(tree, torch.Tensor) else "cuda")
        return by_name["/".join(prefix)].to(dev)

    return place(like)
