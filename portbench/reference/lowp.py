"""The control: the reference with its weight products in float8.

A configuration in bfloat16 tempts a later change to run its products in
float8.  `fp8_matmul` models that step in the reference's place: both
operands of each product are scaled per tensor to float8 e4m3's range,
rounded to it and scaled back, and multiplied in float32 (as an fp8 tensor
core accumulates); in the backward the incoming gradient is rounded to
e5m2 the same way and each operand product is taken on the rounded
operands.  Everything else stays float32.  A comparison that cannot tell
this from the program at its stated precision cannot tell a fault of that
size either.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).float() / scale


def e4m3(t: torch.Tensor) -> torch.Tensor:
    return _round(t, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(t: torch.Tensor) -> torch.Tensor:
    return _round(t, torch.float8_e5m2, E5M2_MAX)


class _FP8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = e4m3(a), e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = e5m2(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = (qa.reshape(-1, qa.shape[-1]).T
              @ qg.reshape(-1, qg.shape[-1])).reshape(qb.shape)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8Matmul.apply(a, b)
