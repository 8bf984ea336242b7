"""Weights and token ids drawn from the run's seed, on the device.

Each leaf of the program's parameter tree is drawn by a generator of its
own, seeded from the run's seed and the leaf's place in the tree, in one
call in the dtype it is served in: the same seed gives the same weights,
and any one leaf can be drawn again alone (`draw_leaf`), so that a
reference or a check can have the initial weights back without a copy
being kept.  The rules follow the leaf's name:

- norm scales and Mamba2's D: ones; biases and dt_bias: zeros;
- A_log: log(1..H) over the heads, as Mamba2 initialises it;
- every other leaf, an (..., in, out) matrix: N(0, 1 / in); the
  embedding table (vocab, d): N(0, 1 / d); the matrices that end a
  residual branch (a mixer's out_proj, attention's wo, an MLP's or an
  expert's w_down) are scaled again by 1 / sqrt(the branches the
  published model adds to its residual stream), as GPT-2 and Mamba
  initialise them.  Without it a random 72-branch zamba2 amplifies a
  relative perturbation of its input about 80-fold by the last layer,
  and bfloat16's rounding alone decorrelates its logits from float32's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

ZEROS = ("conv_b", "dt_bias", "bq", "bk", "bv")
ONES = ("scale", "D")
BRANCH_ENDS = ("out_proj", "wo", "w_down")


def residual_branches(config: dict) -> int:
    """Branches the published model adds to its residual stream, as its
    family (`portbench/families/`) counts them."""
    from .families import get
    return get(config["family"]).residual_branches(config)


def mix(*parts: int) -> int:
    """A 63-bit seed from whole numbers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(*parts))


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def draw_leaf(path: str, index: int, shape, dtype, seed: int, device,
              branches: int = 1) -> torch.Tensor:
    name = path.split("/")[-1]
    if name in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "A_log":
        heads = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
        return torch.log(heads).to(dtype).expand(shape).contiguous()
    fan = shape[-1] if path.endswith("embed/table") else shape[-2]
    if name in BRANCH_ENDS:
        fan *= branches
    w = torch.randn(shape, dtype=dtype, device=device,
                    generator=generator(device, seed, 1, index))
    return w.mul_(1.0 / math.sqrt(fan))


def draw(template, seed: int, device, branches: int = 1) -> dict:
    """A tree of `template`'s structure, shapes and dtypes (any device,
    meta included), every leaf drawn on `device`; `branches` as
    `residual_branches` gives it."""
    def build(tree, prefix, counter):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else k, counter)
                    for k, v in tree.items()}
        counter[0] += 1
        return draw_leaf(prefix, counter[0], tuple(tree.shape), tree.dtype,
                         seed, device, branches)
    return build(template, "", [0])


def leaf_specs(template) -> Dict[str, Tuple[int, tuple, torch.dtype]]:
    """{path: (index, shape, dtype)} in `draw`'s order."""
    return {path: (i + 1, tuple(t.shape), t.dtype)
            for i, (path, t) in enumerate(named_leaves(template))}


def tokens(seed: int, stream: int, index: int, shape, vocab: int,
           device) -> torch.Tensor:
    """Token ids, uniform over the vocabulary, int32: item `index` of the
    traffic's stream `stream` for this seed."""
    return torch.randint(0, vocab, shape, dtype=torch.int32, device=device,
                         generator=generator(device, seed, 2, stream, index))
