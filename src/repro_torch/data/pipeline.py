"""Deterministic synthetic LM data pipeline (a copy of the JAX package's
`data/pipeline.py`: the same batches, bit for bit).

Stateless and step-indexed: batch(step) is a pure function of (seed, step,
shape), so an elastic restart — even on a different mesh — reproduces the
exact token stream with no iterator state to checkpoint.  This is the
property real pipelines buy with expensive checkpointable readers; the
synthetic pipeline gets it for free and the training loop is written
against exactly this contract (see checkpoint/ and runtime/train.py).

The stream is a Zipf-ish unigram mix with induced bigram structure, so the
loss actually falls during the example runs (pure-uniform tokens would
pin CE at log V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 32000


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (seed, step): tokens + next-token labels."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    V = cfg.vocab_size
    # Zipf unigram distribution over a truncated head of the vocab
    head = min(V, 4096)
    ranks = np.arange(1, head + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(head, size=(cfg.global_batch, cfg.seq_len + 1),
                      p=probs)
    # induced bigram structure: with p=0.5, token[t+1] = f(token[t])
    follow = (toks[:, :-1] * 7 + 11) % head
    mask = rng.random((cfg.global_batch, cfg.seq_len)) < 0.5
    toks[:, 1:][mask] = follow[mask]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def batch_for_model(model_cfg: ModelConfig, data_cfg: DataConfig,
                    step: int) -> Dict[str, np.ndarray]:
    """Model-aware batch: adds stub frontend embeddings where assigned."""
    base = synthetic_batch(
        dataclasses.replace(data_cfg, vocab_size=model_cfg.vocab_size), step)
    rng = np.random.default_rng(np.uint64(data_cfg.seed * 7 + step))
    if model_cfg.is_encdec:
        src = rng.standard_normal(
            (data_cfg.global_batch, max(32, data_cfg.seq_len // 4),
             model_cfg.d_model)).astype(np.float32)
        return {"src_embeds": src, **base}
    if model_cfg.frontend == "embed":
        emb = rng.standard_normal(
            (data_cfg.global_batch, data_cfg.seq_len,
             model_cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "labels": base["labels"]}
    return base


def stream(model_cfg: ModelConfig, data_cfg: DataConfig,
           start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_for_model(model_cfg, data_cfg, step)
        step += 1
