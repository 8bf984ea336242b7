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
- `ssd_bwd_plain`: the gradients of `ssd_plain` written out chunk by
  chunk in fp32, what the backward kernel computes; it is to that
  kernel what `ssd_plain` is to the forward.
- `ssd_bwd_tc_plain`: the bf16 backward kernel's decomposition (its
  chunk, head groups and hi + lo splits); it is to that kernel what
  `ssd_tc_plain` is to the forward's.

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


#: rows of a chunk of the bf16 tensor-core kernels, forward and backward
#: (`tc::kQ` in ssd.cu)
TC_CHUNK = 128


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


def ssd_bwd_plain(x, dt, A, B, C, dy, chunk: int = 128):
    """Gradients of `ssd_plain` for the output gradient dy, written out
    chunk by chunk in fp32: what the backward kernel computes.  Returns
    (dx, ddt, dA, dB, dC) in x's, dt's, A's, B's and C's dtypes.

    Per chunk (cum the inclusive cumsum of dt A within it, S the state
    before it, dS the gradient of the state after it, zero after the
    last), with G_ij = (C_i.B_j) exp(cum_i - cum_j) and W_ij =
    exp(cum_i - cum_j) dt_j (dy_i.x_j) for j <= i:
      u_j  = sum_{i>=j} G_ij dy_i + exp(cum_last - cum_j) dS B_j,
      dx_j = dt_j u_j,
      dC_i = sum_{j<=i} W_ij B_j + exp(cum_i) S^T dy_i    (summed over heads),
      dB_j = sum_{i>=j} W_ij C_i + exp(cum_last - cum_j) dt_j dS^T x_j,
      dcum_i = sum_{j<i} M_ij - sum_{k>i} M_ki + exp(cum_i) dy_i.(S C_i)
               - K_i, plus <dS, S_after> on the last row, with
               M_ij = W_ij (C_i.B_j) and K_j = exp(cum_last - cum_j) dt_j
               x_j.(dS B_j) (the diagonal, whose two terms cancel, left
               out of both sums, so that it cancels exactly),
      ddt_t = A R_t + x_t.u_t and dA = sum dt_t R_t, R_t = sum_{i>=t} dcum_i;
    and the state's gradient carried to the chunk before,
    dS <- exp(cum_last) dS + sum_i exp(cum_i) dy_i C_i^T.
    """
    if chunk < 1:
        raise ValueError(f"ssd_bwd_plain: chunk must be positive, got {chunk}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    Af = A.float()
    starts = list(range(0, L, chunk))
    # the forward's states: before[k] and after[k] of chunk k
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    before, after = [], []
    for t0 in starts:
        t1 = min(t0 + chunk, L)
        xc, dtc, Bc = xf[:, t0:t1], dtf[:, t0:t1], Bf[:, t0:t1]
        cum = torch.cumsum(dtc * Af, dim=1)
        before.append(state)
        w = torch.exp(cum[:, -1:] - cum) * dtc                # (b, q, H)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", Bc, xc * w[..., None]))
        after.append(state)
    dS = torch.zeros_like(state)
    dA = torch.zeros((H,), dtype=torch.float32, device=x.device)
    dxs, ddts, dBs, dCs = [], [], [], []
    for k in reversed(range(len(starts))):
        t0 = starts[k]
        t1 = min(t0 + chunk, L)
        q = t1 - t0
        xc, dtc, dyc = xf[:, t0:t1], dtf[:, t0:t1], dyf[:, t0:t1]
        Bc, Cc, S = Bf[:, t0:t1], Cf[:, t0:t1], before[k]
        cum = torch.cumsum(dtc * Af, dim=1)                   # (b, q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (b, i, j, H)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        W = torch.einsum("bihp,bjhp->bijh", dyc, xc) * decay \
            * dtc[:, None, :, :]
        wend = torch.exp(cum[:, -1:] - cum)                   # (b, q, H)
        ecum = torch.exp(cum)
        dsb = torch.einsum("bjn,bhpn->bjhp", Bc, dS)
        u = (torch.einsum("bijh,bihp->bjhp", cb[..., None] * decay, dyc)
             + wend[..., None] * dsb)
        off = ecum[..., None] * torch.einsum("bihp,bhpn->bihn", dyc, S)
        dCs.append(torch.einsum("bijh,bjn->bin", W, Bc) + off.sum(2))
        dBs.append(torch.einsum("bijh,bin->bjn", W, Cc)
                   + torch.einsum("bjh,bjhp,bhpn->bjn", wend * dtc, xc, dS))
        dxs.append(dtc[..., None] * u)
        xu = (xc * u).sum(-1)                                 # (b, q, H)
        M = W * (cb * tri.tril(-1))[..., None]   # strictly below the diagonal
        K = wend * dtc * (xc * dsb).sum(-1)
        dcum = (M.sum(2) - M.sum(1) + torch.einsum("bin,bihn->bih", Cc, off)
                - K)
        dcum[:, -1] += (dS * after[k]).sum((-1, -2))
        R = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddts.append(Af * R + xu)
        dA = dA + (dtc * R).sum((0, 1))
        dS = (dS * torch.exp(cum[:, -1])[..., None, None]
              + torch.einsum("bih,bihp,bin->bhpn", ecum, dyc, Cc))

    def cat(parts, like, shape):
        out = torch.cat(parts[::-1], dim=1) if parts else \
            torch.zeros(shape, dtype=torch.float32, device=x.device)
        return out.to(like.dtype)

    return (cat(dxs, x, (b, 0, H, P)), cat(ddts, dt, (b, 0, H)),
            dA.to(A.dtype), cat(dBs, B, (b, 0, N)), cat(dCs, C, (b, 0, N)))


def ssd_bwd_tc_plain(x, dt, A, B, C, dy, group: int):
    """The bf16 backward kernel's arithmetic: `ssd_bwd_plain`'s formulas
    in the kernel's chunks of `TC_CHUNK` rows, grouped and split as the
    kernel takes them.  Returns (dx, ddt, dA, dB, dC) in x's, dt's, A's,
    B's and C's dtypes.

    - The states S before each chunk are the forward's tensor-core states
      (`ssd_tc_plain`: the own state sum_j x_j (w_j B_j)^T with w.B
      split), fp32; the state gradients dS carry each chunk's own term
      sum_i dy_i (exp(cum_i) C_i)^T, exp(cum).C split, against dy.
    - u = G^T dy (G split) + diag(wend) B dS^T (dS split); dx = dt u.
    - The terms of dB and dC through W are taken once per group of
      `group` heads (the kernel's `ops.bwd_heads_per_group`): W summed
      over the group's heads in fp32, split, against C or B; the groups'
      terms summed in order.  The state terms, diag(exp cum) dy S (S
      split) and diag(wend dt) x dS (dS split), are summed over the heads.
    - dcum, R, ddt and dA as `ssd_bwd_plain`, with the split products.

    Every fp32-derived operand is split hi + lo (`split_bf16`), whatever
    the inputs' dtype, as the kernel splits them."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    if group < 1:
        raise ValueError(f"ssd_bwd_tc_plain: group must be positive, got "
                         f"{group}")
    chunk, sp = TC_CHUNK, split_bf16
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    Af = A.float()
    dev = x.device
    starts = list(range(0, L, chunk))

    def cums(t0):
        t1 = min(t0 + chunk, L)
        return t1, torch.cumsum(dtf[:, t0:t1] * Af, dim=1)

    # the forward's states before and after each chunk, and each chunk's
    # own state gradient (dy against exp(cum).C split)
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
    before, after, own_ds = [], [], []
    for t0 in starts:
        t1, cum = cums(t0)
        xc, dtc, dyc = xf[:, t0:t1], dtf[:, t0:t1], dyf[:, t0:t1]
        before.append(state)
        w = torch.exp(cum[:, -1:] - cum) * dtc                # (b, q, H)
        wB = w[..., None] * Bf[:, t0:t1, None, :]             # (b, q, H, N)
        own = sum(torch.einsum("bjhn,bjhp->bhpn", v, xc) for v in sp(wB))
        state = state * torch.exp(cum[:, -1])[..., None, None] + own
        after.append(state)
        eC = torch.exp(cum)[..., None] * Cf[:, t0:t1, None, :]
        own_ds.append(sum(torch.einsum("bihn,bihp->bhpn", v, dyc)
                          for v in sp(eC)))
    dS = torch.zeros_like(state)
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    dxs, ddts, dBs, dCs = [], [], [], []
    heads = [slice(h0, min(H, h0 + group)) for h0 in range(0, H, group)]
    for k in reversed(range(len(starts))):
        t0 = starts[k]
        t1, cum = cums(t0)
        q = t1 - t0
        xc, dtc, dyc = xf[:, t0:t1], dtf[:, t0:t1], dyf[:, t0:t1]
        Bc, Cc, S = Bf[:, t0:t1], Cf[:, t0:t1], before[k]
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (b, i, j, H)
        tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        W = torch.einsum("bihp,bjhp->bijh", dyc, xc) * decay \
            * dtc[:, None, :, :]
        wend = torch.exp(cum[:, -1:] - cum)                   # (b, q, H)
        ecum = torch.exp(cum)
        G = cb[..., None] * decay
        dsb = sum(torch.einsum("bjn,bhpn->bjhp", Bc, s) for s in sp(dS))
        u = (sum(torch.einsum("bijh,bihp->bjhp", s, dyc) for s in sp(G))
             + wend[..., None] * dsb)
        dxs.append(dtc[..., None] * u)
        off = ecum[..., None] * sum(torch.einsum("bihp,bhpn->bihn", dyc, s)
                                    for s in sp(S))
        dB2 = (wend * dtc)[..., None] * sum(
            torch.einsum("bjhp,bhpn->bjhn", xc, s) for s in sp(dS))
        dC, dB = off.sum(2), dB2.sum(2)
        for hs in heads:
            Wg = W[..., hs].sum(-1)                           # (b, i, j)
            dC = dC + sum(torch.einsum("bij,bjn->bin", s, Bc)
                          for s in sp(Wg))
            dB = dB + sum(torch.einsum("bij,bin->bjn", s, Cc)
                          for s in sp(Wg))
        dCs.append(dC)
        dBs.append(dB)
        xu = (xc * u).sum(-1)                                 # (b, q, H)
        M = W * (cb * tri.tril(-1))[..., None]   # strictly below the diagonal
        K = wend * dtc * (xc * dsb).sum(-1)
        dcum = (M.sum(2) - M.sum(1) + torch.einsum("bin,bihn->bih", Cc, off)
                - K)
        dcum[:, -1] += (dS * after[k]).sum((-1, -2))
        R = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddts.append(Af * R + xu)
        dA = dA + (dtc * R).sum((0, 1))
        dS = dS * torch.exp(cum[:, -1])[..., None, None] + own_ds[k]

    def cat(parts, like, shape):
        out = torch.cat(parts[::-1], dim=1) if parts else \
            torch.zeros(shape, dtype=torch.float32, device=dev)
        return out.to(like.dtype)

    return (cat(dxs, x, (b, 0, H, P)), cat(ddts, dt, (b, 0, H)),
            dA.to(A.dtype), cat(dBs, B, (b, 0, N)), cat(dCs, C, (b, 0, N)))
