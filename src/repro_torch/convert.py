"""Carry a parameter tree from the JAX package into the port.

The caller hands the tree over as numpy arrays (for example
`jax.tree.map(np.asarray, params)`); this module never imports JAX.
Keys and shapes stay as they are.  bfloat16 arrays (ml_dtypes' numpy
dtype) go across through float32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_torch(tree, device)
