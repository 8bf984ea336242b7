"""Model facade: one interface over the decoder-only archs (dense, SSM,
hybrid).

    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.apply(params, batch)          # prefill
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.decode(params, cache, token, pos)

`batch` is a dict: {"tokens"} or {"embeds"} (frontend stubs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..tree import leaves
from . import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    apply: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]


def build_model(cfg: ModelConfig, impl: str = "auto", remat: bool = True,
                device="cuda") -> Model:
    transformer.check_supported(cfg)

    def init(gen: torch.Generator):
        return transformer.init_params(gen, cfg, device)

    def apply(params, batch):
        inputs = batch.get("embeds", batch.get("tokens"))
        return transformer.forward(params, inputs, cfg, impl, remat)

    def init_cache(batch_size, max_len):
        return transformer.init_cache(cfg, batch_size, max_len, device)

    def decode(params, cache, token, pos):
        return transformer.decode_step(params, cache, token, pos, cfg, impl)

    return Model(cfg, init, apply, init_cache, decode)


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))
