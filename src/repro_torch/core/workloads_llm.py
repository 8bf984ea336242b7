"""LLM workload frontier: transformer/MoE layer graphs from `repro_torch.configs`.

The paper's evaluation stops at batch-1 inference over 15 CNN/RNN graphs;
its companion characterization (arXiv:2410.22262) shows that at
multi-chiplet scale the dominant traffic is *collective*.  This module
bridges the port's LLM model zoo (`repro_torch.configs.ARCHS`) to the traffic
generator: each `"<model>:<phase>"` workload derives a prefill- or
decode-phase layer graph directly from the `ModelConfig` (dims, GQA
heads, expert counts, sliding windows, activation arity), annotated with
the collective hints (`Layer.collective`) that
`mapper.tensor_parallel_mapping` / `expert_parallel_mapping` turn into
all-reduce and all-to-all phases at layer boundaries.

Phase semantics:

- **prefill**: one pass over ``PREFILL_SEQ`` prompt tokens (batch 1).
  Compute and collective volume both scale with the token count — the
  tensor-parallel all-reduce at each o-proj/ff2 boundary carries the
  full ``seq x d_model`` activation, the MoE dispatch/combine carry it
  ``experts_per_token``-fold.  KV-cache writes ride the activation path.
- **decode**: one token step for ``DECODE_BATCH`` concurrent sequences
  at context ``DECODE_CTX``.  Per-step activations are tiny; the
  traffic is dominated by streamed weights and KV-cache reads (modelled
  as the attention layer's fetched bytes) — the memory-bound regime.

The graphs repeat the config's pattern unit ``units`` times (default
`DEFAULT_UNITS`): traffic is periodic across identical units, so two
units capture the steady state plus the boundary while keeping the
packetised trace tractable; per-layer times simply scale with depth.
Giant models coarsen the packet granularity via `auto_packet_bytes`
(flit aggregation — aggregates are granularity-independent).

Supported families: ``dense`` and ``moe`` (the attn/mlp/moe block
kinds).  SSM/hybrid/multimodal archs raise with a pointer here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import ARCHS, ModelConfig

from .topology import AcceleratorConfig, build_topology
from .traffic import PACKET_BYTES, TrafficTrace, WEIGHT_SRAM_BYTES, build_trace
from .workloads import BYTES, GraphBuilder, Layer

# LLM workload id -> repro_torch.configs arch id
LLM_MODELS: Dict[str, str] = {
    "smollm_360m": "smollm-360m",
    "gemma2_2b": "gemma2-2b",
    "chatglm3_6b": "chatglm3-6b",
    "qwen2p5_32b": "qwen2.5-32b",
    "mixtral_8x22b": "mixtral-8x22b",
    "kimi_k2": "kimi-k2-1t-a32b",
}
PHASES = ("prefill", "decode")
LLM_WORKLOADS: Tuple[str, ...] = tuple(
    f"{m}:{p}" for m in LLM_MODELS for p in PHASES)

PREFILL_SEQ = 2048       # prompt tokens per prefill pass
DECODE_BATCH = 8         # concurrent sequences per decode step
DECODE_CTX = 2048        # KV context length at the decode step
DEFAULT_UNITS = 2        # pattern-unit repetitions in the graph
TARGET_PACKETS = 30_000  # packet-count budget steering auto granularity


class _LLMBuilder(GraphBuilder):
    """`GraphBuilder` without the CNN zoo's implicit BATCH scaling (LLM
    phases carry their token/batch counts explicitly)."""

    batch = 1


def _act_mult(cfg: ModelConfig) -> int:
    return 3 if cfg.activation in ("silu", "geglu") else 2


def _attn_block(g: _LLMBuilder, cfg: ModelConfig, tag: str, tokens: int,
                ctx: int, kv_read: float) -> None:
    """QKV -> attention core -> o-proj (all-reduce boundary)."""
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    g.add(f"{tag}_qkv",
          macs=tokens * d * (q_dim + 2 * kv_dim),
          act_in=BYTES * tokens * d,
          weights=BYTES * d * (q_dim + 2 * kv_dim),
          act_out=BYTES * tokens * (q_dim + 2 * kv_dim))
    # attention core: QK^T + AV (two passes over the context; prefill's
    # causal half and the dual matmul fold to one ctx-wide pass per token)
    g.add(f"{tag}_attn",
          macs=2.0 * tokens * ctx * q_dim,
          act_in=BYTES * tokens * (q_dim + 2 * kv_dim),
          weights=kv_read,          # decode: streamed KV-cache bytes
          act_out=BYTES * tokens * q_dim)
    g.add(f"{tag}_o",
          macs=tokens * q_dim * d,
          act_in=BYTES * tokens * q_dim,
          weights=BYTES * q_dim * d,
          act_out=BYTES * tokens * d,
          collective="all_reduce")   # row-parallel partial sums


def _mlp_block(g: _LLMBuilder, cfg: ModelConfig, tag: str, tokens: int,
               d_ff: int) -> None:
    d, am = cfg.d_model, _act_mult(cfg)
    g.add(f"{tag}_ff_in",
          macs=tokens * d * d_ff * (am - 1),
          act_in=BYTES * tokens * d,
          weights=BYTES * (am - 1) * d * d_ff,
          act_out=BYTES * tokens * d_ff)
    g.add(f"{tag}_ff_out",
          macs=tokens * d_ff * d,
          act_in=BYTES * tokens * d_ff,
          weights=BYTES * d_ff * d,
          act_out=BYTES * tokens * d,
          collective="all_reduce")


def _moe_block(g: _LLMBuilder, cfg: ModelConfig, tag: str,
               tokens: int) -> None:
    d, am = cfg.d_model, _act_mult(cfg)
    d_ff = cfg.moe_d_ff or cfg.d_ff
    n_exp, ept = cfg.n_experts, cfg.experts_per_token
    # router: tiny matmul whose decisions fan out to every expert owner
    g.add(f"{tag}_router",
          macs=tokens * d * n_exp,
          act_in=BYTES * tokens * d,
          weights=BYTES * d * n_exp,
          act_out=BYTES * tokens * n_exp,
          collective="broadcast")
    # expert pool: each token runs `ept` experts; the pass touches (and
    # therefore fetches) at most `tokens * ept` distinct experts
    touched = min(n_exp, tokens * ept)
    g.add(f"{tag}_experts",
          macs=tokens * ept * am * d * d_ff,
          act_in=BYTES * tokens * d,
          weights=BYTES * am * d * d_ff * touched,
          act_out=BYTES * tokens * d,
          collective="moe", n_experts=n_exp, experts_per_token=ept)


def llm_layers(cfg: ModelConfig, phase: str,
               units: int | None = None) -> List[Layer]:
    """Layer graph of one prefill pass / decode step of ``cfg``."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if any(b.kind not in ("attn", "mlp", "moe") for b in cfg.unit):
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} has block kinds beyond "
            f"attn/mlp/moe; the LLM traffic frontier models dense and moe "
            f"archs (see workloads_llm docstring)")
    units = units if units is not None else min(cfg.n_units, DEFAULT_UNITS)
    n_seqs = 1 if phase == "prefill" else DECODE_BATCH
    tokens = PREFILL_SEQ if phase == "prefill" else DECODE_BATCH
    g = _LLMBuilder()
    for u in range(units):
        for bi, blk in enumerate(cfg.unit):
            tag = f"u{u}b{bi}"
            if blk.kind == "attn":
                window = blk.window if not blk.is_global else None
                if phase == "prefill":
                    ctx = min(PREFILL_SEQ, window or PREFILL_SEQ)
                    kv_read = 0.0      # cache is written, not re-read
                else:
                    ctx = min(DECODE_CTX, window or DECODE_CTX)
                    kv_read = (BYTES * 2 * ctx * cfg.n_kv_heads
                               * cfg.head_dim * n_seqs)
                _attn_block(g, cfg, tag, tokens, ctx, kv_read)
            elif blk.kind == "mlp":
                _mlp_block(g, cfg, tag, tokens, blk.d_ff or cfg.d_ff)
            else:
                _moe_block(g, cfg, tag, tokens)
    # LM head over the live positions only (one per sequence), vocab-
    # parallel: the logit shards are synced across the group
    g.add("lm_head",
          macs=n_seqs * cfg.d_model * cfg.vocab_size,
          act_in=BYTES * n_seqs * cfg.d_model,
          weights=BYTES * cfg.d_model * cfg.vocab_size,
          act_out=BYTES * n_seqs * cfg.vocab_size,
          collective="all_reduce")
    return g.layers


def llm_workload(name: str) -> List[Layer]:
    """`get_workload` hook: ``"<model>:<phase>"`` -> layer graph."""
    model, phase = parse_name(name)
    return llm_layers(ARCHS[LLM_MODELS[model]], phase)


def parse_name(name: str) -> Tuple[str, str]:
    model, sep, phase = name.partition(":")
    if not sep or model not in LLM_MODELS or phase not in PHASES:
        raise KeyError(
            f"unknown LLM workload {name!r}; use '<model>:<phase>' with "
            f"model in {sorted(LLM_MODELS)} and phase in {PHASES}")
    return model, phase


def auto_packet_bytes(layers: List[Layer]) -> float:
    """Packetisation granularity keeping the trace near `TARGET_PACKETS`.

    Estimates the dominant byte volume (streamed weights + a collective
    multiple of the activations) and rounds the per-packet size up to a
    power of two, never below the 64 KiB NoP packet.
    """
    streamed = sum(lyr.weights for lyr in layers
                   if lyr.weights > WEIGHT_SRAM_BYTES)
    acts = sum(lyr.act_out for lyr in layers)
    est = streamed + 4.0 * acts
    size = PACKET_BYTES
    while size * TARGET_PACKETS < est:
        size *= 2
    return size


def make_llm_trace(name: str, acc: AcceleratorConfig | None = None,
                   mapping: str | None = None,
                   units: int | None = None,
                   packet_bytes: float | None = None,
                   device=None) -> TrafficTrace:
    """LLM workload name -> `TrafficTrace` on the (default) platform.

    ``mapping=None`` picks the family's natural parallelism: expert-
    parallel for MoE configs, tensor-parallel otherwise.  Explicit
    values accept "tensor", "tensor_ring" (wired-optimal ring
    all-reduce), "expert", "pipeline", "spatial".  The trace lands on
    ``device`` (the CUDA card when None, as `traffic.build_trace`).
    """
    from .mapper import (expert_parallel_mapping, pipeline_mapping,
                         spatial_mapping, tensor_parallel_mapping)
    model, phase = parse_name(name)
    cfg = ARCHS[LLM_MODELS[model]]
    layers = llm_layers(cfg, phase, units=units)
    topo = build_topology(acc)
    if mapping is None:
        mapping = "expert" if cfg.n_experts else "tensor"
    if mapping == "expert":
        mapped = expert_parallel_mapping(layers, topo)
    elif mapping == "tensor":
        mapped = tensor_parallel_mapping(layers, topo)
    elif mapping == "tensor_ring":
        mapped = tensor_parallel_mapping(layers, topo, algorithm="ring")
    elif mapping == "pipeline":
        mapped = pipeline_mapping(layers, topo)
    elif mapping == "spatial":
        mapped = spatial_mapping(layers, topo)
    else:
        raise ValueError(f"unknown mapping {mapping!r}")
    if packet_bytes is None:
        packet_bytes = auto_packet_bytes(layers)
    return build_trace(layers, mapped, topo, packet_bytes, device)
