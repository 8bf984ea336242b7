"""Mamba2 mixers and nothing else (mamba2): each layer x + mixer(norm
x)."""

from __future__ import annotations

from ..reference import decoder
from ..yardstick import mamba_weights


def blocks(params, cfg):
    eps, out = cfg["norm_eps"], []
    for u in range(cfg["n_layers"]):
        p = decoder.layer_at(params["units"], u)
        out.append(lambda x, pos, mm, p=p: x + decoder.mamba(
            p["b0"]["mamba"], decoder.rmsnorm(x, p["b0"]["norm"]["scale"], eps),
            cfg, mm))
    return out


def body_weights(cfg) -> int:
    return cfg["n_layers"] * mamba_weights(cfg)


def attention_layers(cfg) -> int:
    return 0


def mixers(cfg) -> int:
    return cfg["n_layers"]


def residual_branches(cfg) -> int:
    """One a layer, the mixer's."""
    return cfg.get("published", {}).get("n_layers", cfg["n_layers"])
