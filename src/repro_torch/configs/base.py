"""Model configuration: the port's own copy of the architecture record.

Field for field the same as the JAX package's `configs/base.py`, so a
configuration means the same model in both packages.  A config fully
determines the model: the repeating pattern unit (one loop iteration
over the stacked unit parameters), attention flavour, MoE/SSM settings
and the modality frontend stub.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sub-block inside the repeating pattern unit."""

    kind: str                    # "attn" | "mlp" | "moe" | "mamba"
    # attention options
    window: Optional[int] = None          # sliding-window size (None = full)
    is_global: bool = True                # False => local/sliding layer
    # mlp options — d_ff taken from the model config unless overridden
    d_ff: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // n_heads

    # pattern unit: repeats n_units times over stacked parameters.
    # Built by `build_unit()` if left empty.
    unit: Tuple[BlockSpec, ...] = ()

    # attention variants
    rope_theta: float = 1e4
    rope_fraction: float = 1.0            # chatglm 2d-RoPE: 0.5
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # mixtral SWA / gemma2 local
    tie_embeddings: bool = False
    activation: str = "silu"              # silu | geglu | gelu

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None        # per-expert hidden

    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (zamba2): one SHARED attention block applied every
    # `shared_attn_every` layers
    shared_attn_every: int = 0

    # encoder-decoder
    n_encoder_layers: int = 0

    # modality frontend stub: "none" => token ids in; "embed" => the
    # caller feeds precomputed embeddings (B, S, d_model)
    frontend: str = "none"
    encoder_frontend: str = "none"

    norm_eps: float = 1e-6
    # whether this arch can run the 524k-token long-context decode shape
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.unit:
            object.__setattr__(self, "unit", self.build_unit())
        layers_per_unit = max(
            1, sum(1 for b in self.unit if b.kind in ("attn", "mamba")))
        if self.n_layers % layers_per_unit:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not "
                             f"a multiple of {layers_per_unit} layers/unit")

    def build_unit(self) -> Tuple[BlockSpec, ...]:
        if self.family in ("ssm", "hybrid"):
            return (BlockSpec("mamba"),)
        if self.family == "moe":
            return (BlockSpec("attn", window=self.sliding_window,
                              is_global=self.sliding_window is None),
                    BlockSpec("moe"))
        return (BlockSpec("attn", window=self.sliding_window,
                          is_global=self.sliding_window is None),
                BlockSpec("mlp"))

    @property
    def n_units(self) -> int:
        """Loop trip count: layers grouped into identical pattern units."""
        layers_per_unit = max(
            1, sum(1 for b in self.unit if b.kind in ("attn", "mamba")))
        return self.n_layers // layers_per_unit

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def kv_cache_dtype_bytes(self) -> int:
        return 2  # bf16

    def param_count(self) -> int:
        """Analytic parameter count, for MODEL_FLOPS = 6*N*D."""
        d, h = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) \
            + (self.n_heads * h) * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * h
        act_mult = 3 if self.activation in ("silu", "geglu") else 2
        per_mlp = act_mult * d * self.d_ff
        per_moe = (self.n_experts * act_mult * d * (self.moe_d_ff or self.d_ff)
                   + d * self.n_experts)
        dssm = self.d_inner
        g_n = 2 * self.ssm_state  # single B/C group
        per_mamba = (d * (2 * dssm + g_n + self.n_ssm_heads)  # in_proj
                     + self.d_conv * (dssm + g_n)             # conv
                     + 3 * self.n_ssm_heads                   # A, D, dt_bias
                     + dssm * d)                              # out_proj
        norms = 2 * d
        kinds = {"attn": per_attn + norms, "mlp": per_mlp + norms,
                 "moe": per_moe + norms, "mamba": per_mamba + norms}
        total = emb + self.n_units * sum(kinds[b.kind] for b in self.unit)
        if self.shared_attn_every:
            total += per_attn + per_mlp + 2 * norms
        if self.is_encdec:
            total += self.n_encoder_layers * (per_attn + per_mlp + 2 * norms)
            total += self.n_layers * (per_attn + norms)  # cross attention
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of the expert pool)."""
        if not self.n_experts:
            return self.param_count()
        act_mult = 3 if self.activation in ("silu", "geglu") else 2
        per_moe_total = self.n_experts * act_mult * self.d_model * \
            (self.moe_d_ff or self.d_ff)
        per_moe_active = self.experts_per_token * act_mult * self.d_model * \
            (self.moe_d_ff or self.d_ff)
        n_moe_layers = self.n_units * sum(1 for b in self.unit
                                          if b.kind == "moe")
        return self.param_count() - n_moe_layers * (per_moe_total -
                                                    per_moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the LM-scale study."""

    name: str
    seq_len: int
    global_batch: int
    mode: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
