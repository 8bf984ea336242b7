"""Plain PyTorch versions of the SSD chunked-scan kernel.

- `ssd_ref`: the sequential O(L) recurrence, a port of the reference's
  oracle (`src/repro/kernels/ssd/ref.py`); independent of any chunking,
  so it cross-checks both the kernel and `ssd_plain`.
- `ssd_plain`: the chunked function the CUDA kernel computes, in float32
  throughout.  The decay matrix is masked before `exp` (the TPU kernel
  exponentiates the whole (Q, Q) block and zeroes the upper triangle
  afterwards, which overflows to inf once a chunk's decay is steep), and
  a ragged last chunk is simply shorter: nothing is padded.

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
