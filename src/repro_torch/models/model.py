"""Model facade: one interface over the decoder-only archs (dense, MoE,
SSM, hybrid) and the encoder-decoder.

    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.apply(params, batch)          # prefill
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.decode(params, cache, token, pos)

`batch` is a dict: {"tokens"} or {"embeds"} (frontend stubs), plus
{"src_embeds"} for enc-dec.  On a mesh, `apply` hands the forward the
split of each input's sequence that the train step recorded
(`runtime/parallel.py: leaf_split`; None for a rank's rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..tree import leaves
from . import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    apply: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]


def build_model(cfg: ModelConfig, impl: str = "auto", remat: bool = True,
                device="cuda") -> Model:
    if cfg.is_encdec:
        def init(gen: torch.Generator):
            return encdec.init_params(gen, cfg, device)

        def apply(params, batch):
            from ..runtime.parallel import leaf_split
            return encdec.forward(params, batch["src_embeds"],
                                  batch["tokens"], cfg, impl, remat,
                                  src_split=leaf_split("src_embeds"),
                                  split=leaf_split("tokens"))

        def init_cache(batch_size, max_len, src_len=1024):
            return encdec.init_cache(cfg, batch_size, max_len, src_len,
                                     device)

        def decode(params, cache, token, pos):
            return encdec.decode_step(params, cache, token, pos, cfg, impl)
    else:
        def init(gen: torch.Generator):
            return transformer.init_params(gen, cfg, device)

        def apply(params, batch):
            from ..runtime.parallel import leaf_split
            key = "embeds" if "embeds" in batch else "tokens"
            return transformer.forward(params, batch[key], cfg, impl, remat,
                                       split=leaf_split(key))

        def init_cache(batch_size, max_len, src_len=1024):
            return transformer.init_cache(cfg, batch_size, max_len, device)

        def decode(params, cache, token, pos):
            return transformer.decode_step(params, cache, token, pos, cfg,
                                           impl)

    return Model(cfg, init, apply, init_cache, decode)


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))
