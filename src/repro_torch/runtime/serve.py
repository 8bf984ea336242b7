"""Serving: batched prefill + single-token decode steps.

The same three functions as the reference's `make_serve_fns`; the
continuous-batching driver in `launch/serve.py` runs `decode_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models import build_model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    attention_impl: str = "auto"
    temperature: float = 0.0          # 0 => greedy


def make_serve_fns(cfg: ModelConfig, scfg: ServeConfig, device="cuda"):
    model = build_model(cfg, impl=scfg.attention_impl, remat=False,
                        device=device)
    # sampling draws from a generator seeded 0, as the reference samples
    # with PRNGKey(0); greedy decoding never touches it
    gen = torch.Generator(device=device).manual_seed(0)

    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        """Full-sequence forward; returns the last position's logits."""
        logits, _ = model.apply(params, batch)
        return logits[:, -1]

    @torch.no_grad()
    def decode_step(params, cache, token, pos):
        logits, cache = model.decode(params, cache, token, pos)
        last = logits[:, -1]
        if scfg.temperature == 0.0:
            nxt = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last / scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return nxt.to(torch.int32)[:, None], logits, cache

    def init_cache(batch_size: int, max_len: Optional[int] = None,
                   src_len: int = 1024):
        return model.init_cache(batch_size, max_len or scfg.max_len, src_len)

    return prefill, decode_step, init_cache


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             scfg: Optional[ServeConfig] = None) -> torch.Tensor:
    """Greedy generation loop: the prompt goes through decode steps too
    (simple and cache-exact), then n_tokens new ones.  prompt: (B, P)."""
    scfg = scfg if scfg is not None else ServeConfig()
    _, decode_step, init_cache = make_serve_fns(cfg, scfg, prompt.device)
    B, P = prompt.shape
    cache = init_cache(B, P + n_tokens + 1)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(P + n_tokens - 1):
        nxt, _, cache = decode_step(params, cache, tok, i)
        tok = prompt[:, i + 1:i + 2] if i + 1 < P else nxt
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
