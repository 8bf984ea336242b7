"""Encoder-decoder model (SeamlessM4T backbone).

Encoder: bidirectional self-attention + MLP over precomputed frame
embeddings (the speech frontend is a stub, as in the reference: the
caller supplies (B, S_src, d) embeddings).  Decoder: causal
self-attention + cross-attention + MLP, with ring-buffer KV-cache decode
against cross K/V computed once from the encoder output.

A port of `repro.models.encdec`: the same parameter keys and stacked
(n_layers, ...) unit axes, a Python loop over the unit index where the
reference scans, `torch.utils.checkpoint` where it uses `jax.checkpoint`.
Norms and prefill attention take the hand-written kernels under impl
"auto"/"kernel" on CUDA tensors, as in `models/transformer.py`.

Cross-attention RoPE, mirrored from the reference on purpose: the
teacher-forced `forward` rotates the cross query at the decoder
positions (the `kv_override` branch of `attention`) and leaves the
encoder keys unrotated (`_rope_kv_cross`), while `decode_step`'s cross
attention rotates neither.  So decode does not reproduce the forward
after position 0, in either package; a test pins the port's divergence
to the reference's.

Context parallelism (`forward`'s splits): the source and the target
each take their own `batch_spec` on a mesh, so each may be split on its
sequence over the data axes, or whole.  The encoder's bidirectional
self-attention gathers the source's keys over its axes
(`models/attention.py`), the cross-attention the encoder states' keys
and values (`attention.whole_sequence`), at the source's global
positions, and
the decoder's positions are the target's global ones (the cross query
rotated at them, as above).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from ..configs.base import ModelConfig
from .attention import (_project_qkv, attention, attention_init,
                        decode_attention, init_kv_cache, whole_sequence)
from .layers import (embed, embedding_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)
from .transformer import (_stack, _stacked_zeros, _unit, outside,
                          positions_of, run_units)

Params = Dict[str, Any]


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """Same keys, shapes, dtypes and distributions as the reference's
    `init_params`; the numbers differ (another generator)."""
    d = cfg.d_model

    def enc_unit():
        return {"norm1": rmsnorm_init(d, device),
                "attn": attention_init(gen, cfg, device),
                "norm2": rmsnorm_init(d, device),
                "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, device)}

    def dec_unit():
        return {"norm1": rmsnorm_init(d, device),
                "self_attn": attention_init(gen, cfg, device),
                "norm_x": rmsnorm_init(d, device),
                "cross_attn": attention_init(gen, cfg, device),
                "norm2": rmsnorm_init(d, device),
                "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, device)}

    return {
        "embed": embedding_init(gen, cfg, device),
        "enc_units": _stack(enc_unit, cfg.n_encoder_layers),
        "dec_units": _stack(dec_unit, cfg.n_layers),
        "enc_norm": rmsnorm_init(d, device),
        "final_norm": rmsnorm_init(d, device),
    }


#: the stacked unit trees, gathered one unit at a time (`run_units`)
STACKS = ("enc_units", "dec_units")


def _run_units(unit_fn, x, stacked, n, prefix, remat):
    x, _ = run_units(lambda x, p: (unit_fn(x, p), 0.0), x, stacked, n,
                     prefix, remat)
    return x


def _enc_unit(p: Params, x, cfg: ModelConfig, positions, impl):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    from ..runtime.parallel import shard_batch
    x = shard_batch(x)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps, impl)
    x = x + attention(p["attn"], h, cfg, positions, impl=impl, causal=False)
    h = rmsnorm(p["norm2"], x, cfg.norm_eps, impl)
    return x + mlp(p["mlp"], h, cfg.activation, cfg.d_ff)


def _dec_unit(p: Params, x, enc, cfg: ModelConfig, positions, enc_pos,
              impl, src_split=None):
    """One decoder layer of the teacher-forced forward: causal
    self-attention, cross-attention over the encoder states (those of
    the whole source under its split, `attention.whole_sequence`), the
    MLP."""
    from ..runtime.parallel import shard_batch
    x = shard_batch(x)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps, impl)
    x = x + attention(p["self_attn"], h, cfg, positions, impl=impl)
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps, impl)
    kv = whole_sequence(*_rope_kv_cross(p["cross_attn"], enc, cfg), enc_pos,
                        src_split)
    # the query is rotated at the decoder positions (see the module
    # docstring: mirrored from the reference)
    x = x + attention(p["cross_attn"], h, cfg, positions, impl=impl,
                      kv_override=kv, causal=False)
    h = rmsnorm(p["norm2"], x, cfg.norm_eps, impl)
    return x + mlp(p["mlp"], h, cfg.activation, cfg.d_ff)


def _dec_step(p: Params, self_cache, cross_cache, x, cfg: ModelConfig,
              pos: int, impl):
    """One decoder layer of a decode step (the self cache written in
    place, the cross cache only read)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps, impl)
    y, _ = decode_attention(p["self_attn"], h, self_cache, cfg, pos)
    x = x + y
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps, impl)
    y, _ = decode_attention(p["cross_attn"], h, cross_cache, cfg, pos,
                            cross=True)
    x = x + y
    h = rmsnorm(p["norm2"], x, cfg.norm_eps, impl)
    return x + mlp(p["mlp"], h, cfg.activation, cfg.d_ff)


def encode(params: Params, src_embeds: torch.Tensor, cfg: ModelConfig,
           impl: str = "auto", remat: bool = True, split=None
           ) -> torch.Tensor:
    """src_embeds: (B, S_src, d) -> encoder states (B, S_src, d).
    `split`: the source's (`transformer.forward` says what it does)."""
    from ..runtime.parallel import seq_split
    params = outside(params, STACKS)
    x = src_embeds.to(torch.bfloat16)
    positions = positions_of(x, split)

    def unit(x, p):
        return _enc_unit(p, x, cfg, positions, impl)

    with seq_split(split):
        x = _run_units(unit, x, params["enc_units"], cfg.n_encoder_layers,
                       "enc_units", remat)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps, impl)


def forward(params: Params, src_embeds: torch.Tensor,
            dec_tokens: torch.Tensor, cfg: ModelConfig,
            impl: str = "auto", remat: bool = True, src_split=None,
            split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward. Returns (logits fp32 (B, S, V), aux=0).

    `src_split` and `split`: the source's and the target's sequence
    splits (`sharding.SeqSplit`; each leaf takes its own `batch_spec`,
    so one may split while the other is whole).  The encoder runs under
    the source's, the decoder under the target's; the cross-attention
    gathers the encoder states' keys and values over the source's axes,
    at the source's global positions."""
    from ..runtime.parallel import seq_split, shard_batch
    params = outside(params, STACKS)
    enc = shard_batch(encode(params, src_embeds, cfg, impl, remat,
                             src_split))
    x = embed(params["embed"], dec_tokens, cfg)
    positions = positions_of(x, split)
    enc_pos = positions_of(enc, src_split)

    def unit(x, p):
        return _dec_unit(p, x, enc, cfg, positions, enc_pos, impl,
                         src_split)

    with seq_split(split):
        x = _run_units(unit, x, params["dec_units"], cfg.n_layers,
                       "dec_units", remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x, cfg), aux


def _rope_kv_cross(attn_params: Params, enc: torch.Tensor, cfg: ModelConfig):
    """Cross-attention keys/values from encoder states (no RoPE)."""
    return _project_qkv(attn_params, enc, cfg, "kv")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
               device=None) -> Params:
    """Self-attention ring caches + cross K/V (filled by `prefill_cross`),
    stacked over the decoder layers."""
    lead = (cfg.n_layers,)
    return {"self": _stacked_zeros(init_kv_cache(cfg, batch, max_len,
                                                 device=device), lead),
            "cross": _stacked_zeros(init_kv_cache(cfg, batch, src_len,
                                                  device=device), lead)}


def prefill_cross(params: Params, src_embeds: torch.Tensor,
                  cfg: ModelConfig, cache: Params,
                  impl: str = "auto") -> Params:
    """Run the encoder once and store each decoder layer's cross K/V (on
    a mesh, each layer's cross-attention weights gathered as it is
    reached)."""
    from ..runtime.parallel import gather_unit, unit_shards
    params = outside(params, STACKS)
    enc = encode(params, src_embeds, cfg, impl)
    ks, vs = zip(*(_rope_kv_cross(gather_unit(s["cross_attn"]), enc, cfg)
                   for s in unit_shards(params["dec_units"], cfg.n_layers,
                                        "dec_units")))
    cross = {"k": torch.stack(ks).to(torch.bfloat16),
             "v": torch.stack(vs).to(torch.bfloat16)}
    return {"self": cache["self"], "cross": cross}


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) int; pos: int position.  Returns (logits (B, 1, V)
    fp32, cache); the self-attention caches are updated in place, as in
    `transformer.decode_step`, and the cross caches only read; on a mesh
    each layer's params are gathered as the step reaches it."""
    from ..runtime.parallel import gather_unit, unit_shards
    params = outside(params, STACKS)
    x = embed(params["embed"], token, cfg)
    for u, shards in enumerate(unit_shards(params["dec_units"], cfg.n_layers,
                                           "dec_units")):
        x = _dec_step(gather_unit(shards), _unit(cache["self"], u),
                      _unit(cache["cross"], u), x, cfg, pos, impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    return unembed(params["embed"], x, cfg), cache
