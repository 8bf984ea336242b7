"""The yardstick: the card's peaks, the model's operations and the
kernels' operations and bytes, computed from the configuration's sizes.

Frozen here so that a change to the program cannot move it.  Model
FLOPs count the work the model needs, not what an implementation does:

- training: 6 x (weights used per token) x tokens, plus, for each
  attention layer, 3 x the causal forward's 2 B H S^2 D, plus, for each
  Mamba2 mixer, 3 x the scan's recurrent 4 H P N a token; remat's
  replay is not model work;
- prefill: 2 x (weights used per token, the top k of the experts) x
  tokens, the head at the last position only, plus 2 B H S^2 D for each
  attention layer and 4 H P N a token for each mixer.

Kernel bounds are max(operations / peak, bytes / bandwidth), each input
byte read once and each output byte written once (`ssd_cost`,
`ssd_bwd_cost`, `fa_cost`, `gmm_cost`).  The SSD scan is counted at a
fixed chunk, 256 rows forward and 128 backward, whatever chunk a kernel
runs.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SSD_FWD_CHUNK = 256
SSD_BWD_CHUNK = 128


def _bound(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def ssd_cost(b, L, H, P, N, chunk=SSD_FWD_CHUNK):
    """(flops, bytes, bound s) of the bf16 SSD scan: per (batch row,
    chunk) C.B^T, the gated product, the carried state's term and the
    state update over full Q x Q blocks; x, B, C read (bf16), dt, A
    (fp32), y written (bf16)."""
    flops = (b * (L // chunk) * 2
             * (chunk * chunk * N + chunk * chunk * H * P
                + 2 * chunk * H * P * N))
    nbytes = 2 * 2 * b * L * H * P + 4 * b * L * H + 4 * H + 2 * 2 * b * L * N
    return flops, nbytes, _bound(flops, nbytes)


def ssd_bwd_cost(b, L, H, P, N, chunk=SSD_BWD_CHUNK):
    """(flops, bytes, bound s) of the SSD scan's VJP on bf16 x, B, C and
    dy: per (batch row, chunk) C.B^T, W B and W^T C, and per head dy.x^T,
    G^T dy and the four state products; x, dy, B, C (bf16), dt, A (fp32)
    read, dx, dB, dC (bf16), ddt, dA (fp32) written."""
    nc = -(-L // chunk)
    per_head = 2 * (2 * chunk * chunk * P + 4 * chunk * P * N)
    flops = b * nc * (3 * 2 * chunk * chunk * N + H * per_head)
    nbytes = (2 * 3 * b * L * H * P + 4 * 2 * b * L * H + 4 * 2 * H
              + 2 * 4 * b * L * N)
    return flops, nbytes, _bound(flops, nbytes)


def fa_cost(B, S, H, K, D, window=None):
    """(flops, bytes, bound s) of bf16 causal attention of S queries on S
    keys: QK^T and PV over the visible pairs (S(S+1)/2, fewer under a
    window that binds), 2 flops a MAC; q, k, v read, the output written,
    the positions (int32) read."""
    if window is None or window >= S:
        pairs = S * (S + 1) // 2
    else:
        pairs = sum(min(i + 1, window) for i in range(S))
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D) + 4 * 2 * S
    return flops, nbytes, _bound(flops, nbytes)


def gmm_cost(rows, d, f, experts_used):
    """(flops, bytes, bound s) of a bf16 grouped GEMM: the rows read, the
    weights of the experts that have rows read, the output written."""
    flops = 2 * rows * d * f
    nbytes = 2 * (rows * d + experts_used * d * f + rows * f)
    return flops, nbytes, _bound(flops, nbytes)


def attn_weights(c) -> int:
    d, hd = c["d_model"], c["head_dim"]
    return d * c["n_heads"] * hd * 2 + d * c["n_kv_heads"] * hd * 2


def mlp_weights(c, d_ff) -> int:
    return 3 * c["d_model"] * d_ff


def mamba_weights(c) -> int:
    d, N = c["d_model"], c["ssm_state"]
    dssm = c["expand"] * d
    H = dssm // c["ssm_head_dim"]
    return (d * (2 * dssm + 2 * N + H) + c["d_conv"] * (dssm + 2 * N)
            + dssm * d)


def _family(c):
    from .families import get
    return get(c["family"])


def weights_per_token(c) -> dict:
    """Weights each token's forward multiplies by, split by where: the
    layers' ("body", as the family counts them: an MoE layer's router
    and its top-k experts) and the head's."""
    return {"body": _family(c).body_weights(c),
            "head": c["d_model"] * c["vocab_size"]}


def attention_apps(c) -> int:
    return _family(c).attention_layers(c)


def mixers(c) -> int:
    return _family(c).mixers(c)


def _scan_flops_per_token(c) -> int:
    if not mixers(c):
        return 0
    dssm = c["expand"] * c["d_model"]
    return 4 * dssm * c["ssm_state"] * mixers(c)      # 4 H P N a mixer


def _attention_flops(c, B, S) -> float:
    return attention_apps(c) * 2 * B * c["n_heads"] * S * S * c["head_dim"]


def train_flops(c, B, S) -> float:
    """Model FLOPs of one training step on B rows of S tokens."""
    w = weights_per_token(c)
    T = B * S
    return (6 * (w["body"] + w["head"]) * T + 3 * _attention_flops(c, B, S)
            + 3 * _scan_flops_per_token(c) * T)


def prefill_flops(c, B, S) -> float:
    """Model FLOPs of one prefill of B prompts of S tokens (the head at
    the last position only)."""
    w = weights_per_token(c)
    return (2 * w["body"] * B * S + 2 * w["head"] * B
            + _attention_flops(c, B, S) + _scan_flops_per_token(c) * B * S)
