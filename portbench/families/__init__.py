"""Model families, one module each, found by the configuration's
`family`: `families/<family>.py`.

A family module states what the benchmark needs to know of its
architecture, and nothing else does:

- `blocks(params, cfg)`: the reference's layers in order, each a
  function (x, positions, matmul) -> x with its residual added, built
  from `reference/decoder.py`'s plain layers;
- `body_weights(cfg)`: the weights each token's forward multiplies by
  in the layers (the head apart), for the model FLOPs;
- `attention_layers(cfg)`, `mixers(cfg)`: attention applications and
  Mamba2 mixers a forward;
- `residual_branches(cfg)`: the branches the published model adds to
  its residual stream (the init's scale of a branch's last matrix).

A later family is a new file here.
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def get(family: str):
    if not _NAME.match(family):
        raise ValueError(f"not a family name: {family!r}")
    try:
        return importlib.import_module(f"portbench.families.{family}")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.families.{family}":
            raise
        raise ValueError(f"no family module for {family!r} "
                         f"(portbench/families/{family}.py)") from None
