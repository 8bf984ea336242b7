"""`dse.provenance`: reproducibility records stamped into sweep results.

Every expensive search path (`dse.sweep_all`, `policy_sweep_all`,
`scaling_sweep`, the placement annealer, ...) attaches a provenance
dict — stable config hash, seed, points evaluated, wall time — so a
committed result can be traced back to exactly what produced it and
compared run-over-run without diffing float payloads.

A tensor renders as an ``ndarray`` of its dtype and values would, so a
configuration holding tensors hashes as the JAX package's holding the
same arrays; the port's config dataclasses carry the reference's names
and fields, so `config_hash` of one configuration is the same in both.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch


def _stable(obj: Any) -> Any:
    """A deterministic, order-independent representation of ``obj``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                **{f.name: _stable(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {str(k): _stable(v) for k, v in sorted(obj.items(),
                                                      key=lambda kv:
                                                      str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_stable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": str(obj.dtype), "data": obj.tolist()}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def config_hash(obj: Any) -> str:
    """Short sha256 of the stable representation of any config object."""
    h = hashlib.sha256(repr(_stable(obj)).encode()).hexdigest()
    return h[:16]


def make_provenance(kind: str, config: Any, *,
                    seed: Optional[int] = None, points: int = 0,
                    wall_s: float = 0.0) -> dict:
    """The `dse.provenance` record attached to sweep results."""
    return {
        "kind": kind,
        "config_hash": config_hash(config),
        "seed": seed,
        "points_evaluated": int(points),
        "wall_time_s": float(wall_s),
    }
