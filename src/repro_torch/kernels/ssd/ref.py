"""Plain PyTorch versions of the SSD chunked-scan kernel.

- `ssd_ref`: the sequential O(L) recurrence, a port of the reference's
  oracle (`src/repro/kernels/ssd/ref.py`); independent of any chunking,
  so it cross-checks both the kernel and `ssd_plain`.
- `ssd_plain`: the chunked function the CUDA kernel computes, in float32
  throughout.  The decay matrix is masked before `exp` (the TPU kernel
  exponentiates the whole (Q, Q) block and zeroes the upper triangle
  afterwards, which overflows to inf once a chunk's decay is steep), and
  a ragged last chunk is simply shorter: nothing is padded.
- `ssd_tc_plain`: the bf16 tensor-core kernel's own decomposition
  (chunk states, state passing, chunk outputs), with each operand
  derived in fp32 split into bf16 hi + lo as its MMAs take it; it is to
  that kernel what `ssd_plain` is to the float32 one.

Shapes as in the reference: x (b, L, H, P); dt (b, L, H), post-softplus;
A (H,), negative; B, C (b, L, N), one group.  y comes back in x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_ref(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T;
    y_t = C_t . state_t.  Returns (y (b, L, H, P), final state
    (b, H, P, N)), both in x's dtype."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af)                       # (b, H)
        state = state * dA[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    return y.to(x.dtype), state.to(x.dtype)


def ssd_plain(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD in float32, chunks of `chunk` tokens (the last one may
    be shorter).  Per chunk: the masked decay-gated quadratic term plus
    the carried state's term, then the state update.  Returns y in x's
    dtype."""
    if chunk < 1:
        raise ValueError(f"ssd_plain: chunk must be positive, got {chunk}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, L, chunk):
        t1 = min(t0 + chunk, L)
        q = t1 - t0
        xc, dtc = xf[:, t0:t1], dtf[:, t0:t1]            # (b,q,H,P), (b,q,H)
        Bc, Cc = Bf[:, t0:t1], Cf[:, t0:t1]                  # (b, q, N)
        cum = torch.cumsum(dtc * Af, dim=1)                  # (b, q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (b, i, j, H)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)
        xdt = xc * dtc[..., None]
        y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * decay, xdt)
        y = y + torch.einsum("bin,bhpn->bihp", Cc,
                             state) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum)                # (b, q, H)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", Bc,
                                xdt * to_end[..., None]))
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    return y.to(x.dtype)


def split_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v (float32) = hi + lo up to ~2^-16 relative: hi = bf16(v),
    lo = bf16(v - hi), both returned as float32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_tc_plain(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in chunks of `chunk` (the
    kernel's is 128): per chunk, the cumsum of dt A; y = G.x +
    diag(exp cum) C.S^T with the gate G = (C.B^T) exp(cum_i - cum_j) dt_j
    (masked before exp); the chunk's own state sum_j (w_j B_j) x_j^T,
    w_j = exp(cum_last - cum_j) dt_j; and the carried state
    S <- exp(cum_last) S + own, fp32.  For bf16 inputs G, w.B and S are
    split hi + lo, each part multiplied against the exact bf16 operand
    and the two products summed in fp32; float32 inputs take no split.
    Returns y in x's dtype."""
    if chunk < 1:
        raise ValueError(f"ssd_tc_plain: chunk must be positive, got {chunk}")
    b, L, H, P = x.shape
    split = split_bf16 if x.dtype == torch.bfloat16 else (lambda v: (v,))
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    state = None
    ys = []
    for t0 in range(0, L, chunk):
        t1 = min(t0 + chunk, L)
        q = t1 - t0
        xc, dtc = xf[:, t0:t1], dtf[:, t0:t1]            # (b,q,H,P), (b,q,H)
        Bc, Cc = Bf[:, t0:t1], Cf[:, t0:t1]                  # (b, q, N)
        cum = torch.cumsum(dtc * Af, dim=1)                  # (b, q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (b, i, j, H)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)
        gate = scores[..., None] * (decay * dtc[:, None, :, :])
        y = sum(torch.einsum("bijh,bjhp->bihp", g, xc) for g in split(gate))
        if state is not None:
            off = sum(torch.einsum("bin,bhpn->bihp", Cc, s)
                      for s in split(state))
            y = off * torch.exp(cum)[..., None] + y
        ys.append(y)
        w = torch.exp(cum[:, -1:] - cum) * dtc               # (b, q, H)
        wB = w[..., None] * Bc[:, :, None, :]                # (b, q, H, N)
        own = sum(torch.einsum("bjhn,bjhp->bhpn", v, xc) for v in split(wB))
        state = (own if state is None else
                 state * torch.exp(cum[:, -1])[..., None, None] + own)
    y = torch.cat(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    return y.to(x.dtype)
