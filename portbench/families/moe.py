"""Attention + a top-k mixture of SwiGLU experts a layer (mixtral)."""

from __future__ import annotations

from ..reference import decoder
from ..yardstick import attn_weights, mlp_weights


def blocks(params, cfg):
    eps, out = cfg["norm_eps"], []
    for u in range(cfg["n_layers"]):
        p = decoder.layer_at(params["units"], u)
        out.append(lambda x, pos, mm, p=p: x + decoder.attention(
            p["b0"]["attn"], decoder.rmsnorm(x, p["b0"]["norm"]["scale"], eps),
            cfg, pos, mm, cfg.get("sliding_window")))
        out.append(lambda x, pos, mm, p=p: x + decoder.moe(
            p["b1"]["moe"], decoder.rmsnorm(x, p["b1"]["norm"]["scale"], eps),
            cfg, mm))
    return out


def body_weights(cfg) -> int:
    """Attention, the router and the top k experts' weights a layer."""
    per = (attn_weights(cfg) + cfg["d_model"] * cfg["n_experts"]
           + cfg["experts_per_token"]
           * mlp_weights(cfg, cfg.get("moe_d_ff") or cfg["d_ff"]))
    return cfg["n_layers"] * per


def attention_layers(cfg) -> int:
    return cfg["n_layers"]


def mixers(cfg) -> int:
    return 0


def residual_branches(cfg) -> int:
    """Two a layer: attention's and the experts'."""
    return 2 * cfg.get("published", {}).get("n_layers", cfg["n_layers"])
