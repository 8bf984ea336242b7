"""Port kernels against their plain versions on the CUDA card.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips,
with the reason, where there is none.  Run on the H100 with
`PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py`.

Tolerances: float32 2e-5 (the kernel sums in another order than the
plain version, errors ~1e-6 on O(1) outputs); bfloat16 2e-2 plus a
relative 2^-7 (both round an fp32 result to bf16 and may land one ulp
apart, and one bf16 ulp is at most 2^-7 of the value: 2^-5 at [4, 8)).
SSD in float32: 5e-4 plus a relative 1e-5 (sums of up to 1024 terms in
64-row tiles against the plain version's chunks, outputs up to ~40;
2.1e-4 seen on the H100).

bfloat16 SSD runs the tensor-core kernel, whose arithmetic (128-row
chunks, fp32-derived operands split into bf16 hi + lo) `ssd_tc_plain`
models; it is also held to `ssd_tc_plain` at 2^-9 plus a relative 2^-7:
the two round the same fp32 function to bf16 once and differ before that
only by the order of fp32 sums and exp approximations, so they land at
most one output ulp apart (at most 2^-7 relative), and 2^-9 covers
outputs near zero.

The SSD backward kernel against autograd through `ssd_plain`: float32
(the scalar route) 1e-4 of each gradient's largest (sums in another
order; dA, ddt and the decay's cumsum gradient sum whole chunks),
bfloat16 (the tensor-core route) 2e-2 plus a relative 2^-7 (both round
an fp32 result once), and also against `ssd_bwd_tc_plain`, its
arithmetic (128-row chunks, hi + lo splits, head groups), from which it
differs before that rounding only by the order of fp32 sums and exp
approximations: dx, dB and dC at that bound, the fp32 ddt and dA at
1e-4 of their largest.

bfloat16 flash attention runs the tensor-core kernel, which rounds P to
bf16 before P.V as `flash_plain` does; it is also held to `flash_plain`
at 2^-8 plus a relative 2^-7: the two round an fp32 result to bf16 once
(one output ulp, at most 2^-7 relative) and differ before that only by
the order of fp32 sums and exp2 against exp, which can move a rare
weight across a bf16 rounding boundary (2^-8 of that weight).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, _build
from repro_torch.kernels.flash_attention.ops import flash_attention, tc_block_k
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_plain
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_bwd,
                                             rmsnorm_gated, rmsnorm_gated_bwd,
                                             rmsnorm_split,
                                             rmsnorm_split_bwd,
                                             rmsnorm_split_gated_bwd)
from repro_torch.kernels.rmsnorm.ref import (gate_ref, rmsnorm_bwd_ref,
                                             rmsnorm_gated_bwd_ref,
                                             rmsnorm_gated_ref, rmsnorm_ref,
                                             rmsnorm_split_bwd_ref,
                                             rmsnorm_split_gated_bwd_ref,
                                             rmsnorm_split_ref)
from repro_torch.kernels.ssd.ops import (TC_CHUNK, _launch, _launch_bwd,
                                         bwd_heads_per_group, ssd)
from repro_torch.kernels.ssd.ref import (ssd_bwd_plain, ssd_bwd_tc_plain,
                                         ssd_plain, ssd_ref, ssd_tc_plain)

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine; these tests run on the "
                    "H100 with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(KERNELS)
    return torch.device("cuda")


def _t(a, dtype, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


def _rmsnorm_kernels(fn):
    """(fn's result, the kernels the RMSNorm library launched in it: its
    own count of its launches)."""
    n0 = rmsnorm_ops.kernels_launched()
    out = fn()
    torch.cuda.synchronize()
    return out, rmsnorm_ops.kernels_launched() - n0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", [
    (1, 128, 128, 4, 2, 64, True, None, None),
    (2, 256, 256, 8, 4, 64, True, None, 50.0),
    (1, 200, 200, 4, 4, 48, True, 128, None),
    (1, 128, 384, 4, 2, 64, True, None, None),
    (1, 128, 128, 4, 1, 64, False, None, None),
    (1, 130, 130, 2, 2, 32, True, None, None),
    (1, 100, 100, 2, 2, 32, False, None, None),   # ragged, non-causal
    (2, 70, 70, 4, 2, 16, True, 32, None),        # reduced-config head_dim
    (1, 96, 96, 8, 4, 256, True, 64, 50.0),       # gemma2 head_dim
    (4, 1024, 1024, 15, 5, 64, True, None, None),  # smollm prefill
    (2, 1024, 1024, 32, 32, 80, True, None, None),  # zamba2 prefill
    (1, 1000, 1000, 4, 4, 80, True, None, None),  # D = 80, ragged T
    (1, 300, 300, 6, 2, 64, True, None, None),     # G = 3, as smollm
    (1, 512, 512, 4, 4, 80, True, 128, None),      # window at D = 80
    (1, 64, 1000, 4, 2, 64, True, None, None),     # 64 queries at offsets
    (4, 1024, 1024, 48, 8, 128, True, None, None),  # mixtral prefill
    (2, 1024, 1024, 64, 8, 112, True, None, None),  # kimi prefill, D = 112
    (2, 1024, 1024, 32, 8, 128, True, None, None),  # pixtral prefill
    (4, 1000, 1000, 16, 16, 64, False, None, None),  # seamless encoder
    (4, 1024, 1000, 16, 16, 64, False, None, None),  # seamless cross
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, T, H, K, D, causal,
                                    window, softcap):
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((B, S, H, D)), DTYPES[dtype], cuda)
    k = _t(rng.standard_normal((B, T, K, D)), DTYPES[dtype], cuda)
    v = _t(rng.standard_normal((B, T, K, D)) + 3.0, DTYPES[dtype], cuda)
    qp = torch.arange(T - S, T, dtype=torch.int32, device=cuda)
    kp = torch.arange(T, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    tc_before = flash_attention.tc_launches
    out = flash_attention(q, k, v, qp, kp, window=window, softcap=softcap,
                          causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # bf16 takes the tensor-core kernel, float32 the scalar one
    assert flash_attention.tc_launches == tc_before + (dtype == "bfloat16")
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qp, kp)
    opts = dict(scale=D ** -0.5, causal=causal, window=window,
                softcap=softcap)
    ref = attention_ref(*args, **opts).transpose(1, 2)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=TOL[dtype],
                               rtol=RTOL[dtype])
    if dtype == "bfloat16":
        model = flash_plain(*args, **opts, block_k=tc_block_k(D))
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   model.transpose(1, 2).float().cpu().numpy(),
                                   atol=2.0 ** -8, rtol=2.0 ** -7)


def test_flash_kernel_fully_masked_rows_average_v(cuda):
    """Queries before every key see nothing: the row averages V, as the
    plain version's softmax over NEG_INF scores does."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 70, 2, 32)), torch.float32, cuda)
    k = _t(rng.standard_normal((1, 90, 2, 32)), torch.float32, cuda)
    v = _t(rng.standard_normal((1, 90, 2, 32)), torch.float32, cuda)
    qp = torch.arange(70, dtype=torch.int32, device=cuda)
    kp = torch.arange(90, dtype=torch.int32, device=cuda) + 40
    out = flash_attention(q, k, v, qp, kp)
    ref = flash_attention(q.cpu(), k.cpu(), v.cpu(), qp.cpu(), kp.cpu())
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_flash_kernel_fully_masked_rows_average_v_bf16(cuda):
    """The same in bf16, through the tensor-core kernel: no key tile may
    be skipped, and the masked rows average V over every key."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 70, 2, 32)), torch.bfloat16, cuda)
    k = _t(rng.standard_normal((1, 90, 2, 32)), torch.bfloat16, cuda)
    v = _t(rng.standard_normal((1, 90, 2, 32)), torch.bfloat16, cuda)
    qp = torch.arange(70, dtype=torch.int32, device=cuda)
    kp = torch.arange(90, dtype=torch.int32, device=cuda) + 40
    tc_before = flash_attention.tc_launches
    out = flash_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert flash_attention.tc_launches == tc_before + 1
    ref = flash_attention(q.cpu(), k.cpu(), v.cpu(), qp.cpu(), kp.cpu())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), atol=TOL["bfloat16"],
                               rtol=RTOL["bfloat16"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, None), (True, 50),
                                           (False, None)])
def test_flash_kernel_arbitrary_positions(cuda, dtype, causal, window):
    """Shuffled key positions with empty ring slots at int32 max, and
    queries in no order: the kernel classifies tiles from the positions,
    never from the indices."""
    rng = np.random.default_rng(7)
    T, S = 300, 200
    kp = rng.permutation(T).astype(np.int32)
    kp[rng.permutation(T)[:40]] = np.iinfo(np.int32).max
    qp = rng.integers(0, T, S).astype(np.int32)
    q = _t(rng.standard_normal((2, S, 4, 64)), DTYPES[dtype], cuda)
    k = _t(rng.standard_normal((2, T, 2, 64)), DTYPES[dtype], cuda)
    v = _t(rng.standard_normal((2, T, 2, 64)) + 3.0, DTYPES[dtype], cuda)
    qp, kp = (torch.from_numpy(a).to(cuda) for a in (qp, kp))
    out = flash_attention(q, k, v, qp, kp, window=window, causal=causal)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), qp, kp, scale=0.125,
                        causal=causal, window=window).transpose(1, 2)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=TOL[dtype],
                               rtol=RTOL[dtype])


def test_flash_kernel_bf16_strided_and_misaligned_views(cuda):
    """q, k, v split from one fused projection go to TMA in place; a view
    whose base is not 16-byte aligned, or a KV head expanded with stride
    0, is copied first; all agree with the plain version."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 128, 3, 4, 64)), torch.bfloat16, cuda)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    pos = torch.arange(128, dtype=torch.int32, device=cuda)
    flat = torch.empty(1 + q.numel(), dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), pos, pos,
                        scale=0.125).transpose(1, 2).float().cpu().numpy()
    for qq in (q, shifted):
        out = flash_attention(qq, k, v, pos, pos)
        np.testing.assert_allclose(out.float().cpu().numpy(), ref,
                                   atol=TOL["bfloat16"],
                                   rtol=RTOL["bfloat16"])
    # one KV head expanded to all four (stride 0): copied, then the kernel
    k1, v1 = (t[:, :, :1].expand(-1, -1, 4, -1) for t in (k, v))
    assert k1.stride(2) == 0
    ref1 = attention_ref(q.transpose(1, 2), k1.transpose(1, 2),
                         v1.transpose(1, 2), pos, pos,
                         scale=0.125).transpose(1, 2).float().cpu().numpy()
    tc_before = flash_attention.tc_launches
    out = flash_attention(q, k1, v1, pos, pos)
    torch.cuda.synchronize()
    assert flash_attention.tc_launches == tc_before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(), ref1,
                               atol=TOL["bfloat16"], rtol=RTOL["bfloat16"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [64, 80])
def test_flash_kernel_queries_sparser_than_keys(cuda, dtype, D):
    """128 queries at positions 0, 4, ..., 508 against 512 keys: the
    first half of the query tile sees keys 0..252 only, so key tiles
    visible to the second half are invisible to the first.  The kernel
    must still finish and agree with the plain version."""
    rng = np.random.default_rng(9)
    S, T = 128, 512
    q = _t(rng.standard_normal((1, S, 2, D)), DTYPES[dtype], cuda)
    k = _t(rng.standard_normal((1, T, 2, D)), DTYPES[dtype], cuda)
    v = _t(rng.standard_normal((1, T, 2, D)) + 3.0, DTYPES[dtype], cuda)
    qp = 4 * torch.arange(S, dtype=torch.int32, device=cuda)
    kp = torch.arange(T, dtype=torch.int32, device=cuda)
    out = flash_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), qp, kp,
                        scale=D ** -0.5).transpose(1, 2)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=TOL[dtype],
                               rtol=RTOL[dtype])


def test_flash_kernel_grad_flows(cuda):
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((1, 128, 2, 64)), torch.float32, cuda)
    kv = _t(rng.standard_normal((1, 128, 2, 64)), torch.float32, cuda)
    pos = torch.arange(128, dtype=torch.int32, device=cuda)
    q.requires_grad_()
    flash_attention(q, kv, kv, pos, pos).sum().backward()
    assert bool(torch.isfinite(q.grad).all())
    assert float(q.grad.abs().max()) > 0


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 2, 20), device=cuda)        # D not a multiple of 8
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, pos, pos)
    h = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h, h, pos, pos)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 64, 128), (300, 96), (1, 1, 256),
                                   (257, 384), (4096, 960), (4, 1, 960),
                                   (33, 100), (4096, 1536), (2048, 5120),
                                   (4096, 768), (2048, 2560), (4, 768),
                                   (4, 1536), (2, 2560), (2, 5120),
                                   (4096, 6144), (2048, 7168), (4096, 1024),
                                   (4, 6144), (2, 7168)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal(shape), DTYPES[dtype], cuda)
    s = _t(np.linspace(0.5, 1.5, shape[-1]), DTYPES[dtype], cuda)
    before = rmsnorm.launches
    out = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    ref = rmsnorm_ref(x, s)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=TOL[dtype] if dtype == "bfloat16"
                               else 1e-5)


def test_rmsnorm_kernel_mixed_scale_dtype_and_strided_rows(cuda):
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((64, 2, 960)), torch.bfloat16, cuda)[:, 0]
    s = _t(np.linspace(0.5, 1.5, 960), torch.float32, cuda)
    out = rmsnorm(x, s)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               rmsnorm_ref(x, s).float().cpu().numpy(),
                               atol=2e-2)


SSD_TOL = {"float32": (5e-4, 1e-5), "bfloat16": (2e-2, 2.0 ** -7)}
TC_PLAIN_TOL = (2.0 ** -9, 2.0 ** -7)


def _ssd_inputs(b, L, H, P, N, dtype, dev, steep=False, seed=5):
    rng = np.random.default_rng(seed)
    x = _t(0.5 * rng.standard_normal((b, L, H, P)), dtype, dev)
    dt = _t(np.logaddexp(rng.standard_normal((b, L, H)), 0.0)
            + (5.0 if steep else 0.0), torch.float32, dev)
    A = _t(np.full(H, -50.0) if steep
           else -np.exp(0.3 * rng.standard_normal(H)), torch.float32, dev)
    B = _t(0.5 * rng.standard_normal((b, L, N)), dtype, dev)
    C = _t(0.5 * rng.standard_normal((b, L, N)), dtype, dev)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", [
    (1, 64, 4, 16, 16, 16, False),      # tests/test_kernels.py's shapes
    (2, 256, 8, 32, 32, 128, False),
    (1, 100, 4, 16, 32, 32, False),
    (1, 128, 1, 64, 128, 64, False),
    (1, 1000, 4, 64, 128, 256, False),  # ragged L, mamba2 widths
    (1, 64, 2, 16, 16, 64, True),       # steep decay: A = -50, dt ~ 5
    (4, 1024, 24, 64, 128, 256, False),  # mamba2-130m prefill
    (2, 1024, 80, 64, 64, 256, False),  # zamba2-2.7b prefill
])
def test_ssd_kernel_matches_plain(cuda, dtype, b, L, H, P, N, chunk, steep):
    x, dt, A, B, C = _ssd_inputs(b, L, H, P, N, DTYPES[dtype], cuda, steep)
    before, tc_before = ssd.launches, ssd.tc_launches
    y, none = ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert none is None and ssd.launches == before + 1
    assert ssd.tc_launches == tc_before + (dtype == "bfloat16")
    assert y.dtype == x.dtype and bool(torch.isfinite(y).all())
    want = ssd_plain(x, dt, A, B, C, chunk)
    atol, rtol = SSD_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)
    if dtype == "bfloat16":
        model = ssd_tc_plain(x, dt, A, B, C, TC_CHUNK)
        atol, rtol = TC_PLAIN_TOL
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   model.float().cpu().numpy(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("b,H,N", [(4, 24, 128), (2, 80, 64)])
def test_ssd_tc_kernel_in_the_models_strided_layout(cuda, b, H, N):
    """x, B and C as the model hands them in: views of one (b, L, H.P + 2N)
    bf16 conv output (mamba2-130m's and zamba2-2.7b's widths)."""
    rng = np.random.default_rng(10)
    L, P = 1024, 64
    xBC = _t(0.5 * rng.standard_normal((b, L, H * P + 2 * N)),
             torch.bfloat16, cuda)
    x, B, C = torch.split(xBC, [H * P, N, N], dim=-1)
    x = x.reshape(b, L, H, P)
    dt = _t(np.logaddexp(rng.standard_normal((b, L, H)), 0.0),
            torch.float32, cuda)
    A = _t(-np.exp(0.3 * rng.standard_normal(H)), torch.float32, cuda)
    before = ssd.tc_launches
    y, _ = ssd(x, dt, A, B, C, chunk=256)
    torch.cuda.synchronize()
    assert ssd.tc_launches == before + 1
    want = ssd_plain(x, dt, A, B, C, 256)
    atol, rtol = SSD_TOL["bfloat16"]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


def test_ssd_tc_kernel_shorter_than_its_chunk(cuda):
    """L = 100 < 128: one chunk, the single-launch path, at mamba2's
    widths."""
    x, dt, A, B, C = _ssd_inputs(2, 100, 4, 64, 128, torch.bfloat16, cuda,
                                 seed=11)
    y, _ = ssd(x, dt, A, B, C)
    torch.cuda.synchronize()
    want = ssd_plain(x, dt, A, B, C, 128)
    atol, rtol = SSD_TOL["bfloat16"]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("P,N", [(48, 64), (64, 96), (128, 64), (64, 256),
                                 (8, 16)])
def test_ssd_tc_kernel_rejects_unsupported_widths(cuda, P, N):
    x, dt, A, B, C = _ssd_inputs(1, 64, 2, P, N, torch.bfloat16, cuda)
    before = ssd.launches
    with pytest.raises(ValueError, match="tensor-core kernel"):
        ssd(x, dt, A, B, C)
    assert ssd.launches == before


def test_ssd_kernel_matches_sequential_ref_and_strided_views(cuda):
    """The model hands the kernel split views of the conv output (row
    stride d_inner + 2N); against the sequential oracle, as
    `tests/test_kernels.py` holds the TPU kernel (1e-3)."""
    rng = np.random.default_rng(6)
    b, L, H, P, N = 2, 130, 4, 16, 32
    xBC = _t(0.5 * rng.standard_normal((b, L, H * P + 2 * N)),
             torch.float32, cuda)
    x, B, C = torch.split(xBC, [H * P, N, N], dim=-1)
    x = x.reshape(b, L, H, P)
    dt = _t(np.logaddexp(rng.standard_normal((b, L, H)), 0.0),
            torch.float32, cuda)
    A = _t(-np.exp(0.3 * rng.standard_normal(H)), torch.float32, cuda)
    y, _ = ssd(x, dt, A, B, C)
    want, _ = ssd_ref(x, dt, A, B, C)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3)


def test_ssd_kernel_rejects_what_it_cannot_take(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 16, 16, torch.float32, cuda)
    xg = x.clone().requires_grad_()        # a gradient: the backward kernel
    before = ssd.bwd_launches
    ssd(xg, dt, A, B, C)[0].sum().backward()
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1
    assert xg.grad.shape == x.shape and bool(torch.isfinite(xg.grad).all())
    with pytest.raises(ValueError, match="one device"):
        ssd(x, dt, A, B.cpu(), C)
    with pytest.raises(TypeError):
        ssd(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd(x[..., :14], dt, A, B, C)
    big = _ssd_inputs(1, 8, 1, 64, 512, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd(*big)
    wide = _ssd_inputs(1, 8, 1, 512, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd(*wide)


# ---- training: the RMSNorm backward kernel and one train step ------------

def _dscale_bound(x, g, dtype):
    """float32 sums over rows in another order (1e-5 of the sum of the
    terms' magnitudes |g x r|) plus, in bf16, one ulp of the result."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    mag = (gf * xf * r).abs().reshape(-1, x.shape[-1]).sum(0)
    return 1e-5 * mag, (2.0 ** -7 if dtype == "bfloat16" else 0.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scale_dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (8192, 960),        # smollm-360m's training rows
    (4, 1024, 960), (257, 384), (33, 100), (1, 1, 256), (3, 12),
    (1001, 1536), (7, 2560), (2049, 5120), (5, 20000)])
def test_rmsnorm_backward_kernel_matches_plain(cuda, dtype, scale_dtype,
                                               shape):
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal(shape), DTYPES[dtype], cuda)
    g = _t(rng.standard_normal(shape), DTYPES[dtype], cuda)
    s = _t(1.0 + 0.3 * rng.standard_normal(shape[-1]), DTYPES[scale_dtype],
           cuda)
    before = rmsnorm.bwd_launches
    dx, ds = rmsnorm_bwd(x, g, s)
    torch.cuda.synchronize()
    assert rmsnorm.bwd_launches == before + 1
    rdx, rds = rmsnorm_bwd_ref(x, g, s)
    assert dx.dtype == x.dtype and ds.dtype == s.dtype
    torch.testing.assert_close(dx.float(), rdx.float(), atol=TOL[dtype],
                               rtol=RTOL[dtype])
    atol, rtol = _dscale_bound(x, g, scale_dtype)
    err = (ds.float() - rds.float()).abs()
    assert bool((err <= atol + rtol * rds.float().abs()).all())
    dx2, ds2 = rmsnorm_bwd(x, g, s)           # no atomics: the same bits
    assert torch.equal(dx2, dx) and torch.equal(ds2, ds)


def test_rmsnorm_autograd_launches_the_backward_kernel(cuda):
    rng = np.random.default_rng(12)
    x = _t(rng.standard_normal((2, 37, 96)), torch.bfloat16, cuda)
    s = _t(1.0 + 0.3 * rng.standard_normal(96), torch.bfloat16, cuda)
    g = _t(rng.standard_normal((2, 37, 96)), torch.bfloat16, cuda)
    xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
    fwd0, bwd0 = rmsnorm.launches, rmsnorm.bwd_launches
    rmsnorm(xa, sa).backward(g)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm.bwd_launches) == (fwd0 + 1, bwd0 + 1)
    rdx, rds = rmsnorm_bwd_ref(x, g, s)
    assert torch.equal(xa.grad, rmsnorm_bwd(x, g, s)[0])
    torch.testing.assert_close(xa.grad.float(), rdx.float(),
                               atol=TOL["bfloat16"], rtol=RTOL["bfloat16"])
    atol, rtol = _dscale_bound(x, g, "bfloat16")
    err = (sa.grad.float() - rds.float()).abs()
    assert bool((err <= atol + rtol * rds.float().abs()).all())


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b"])
def test_train_step_kernels_match_plain_path(cuda, arch):
    """One reduced train step on the card, float32 weights, remat on:
    impl "auto" (the flash-attention and RMSNorm kernels, the RMSNorm
    backward kernel) against impl "naive" (plain attention and norms).
    Loss 1e-5 relative; gradients 1e-4 of each leaf's largest (float32
    sums in another order through two layers, as on the CPU against JAX);
    the launch counts of one step with remat: each block's norm twice
    (forward and recompute) plus the final norm, each attention block
    twice, and one norm backward per norm."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.runtime.train import (TrainConfig, make_loss_fn,
                                           value_and_grad)
    from repro_torch.tree import leaves, named_leaves, tree_map
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.float().to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    out = {}
    for impl in ("auto", "naive"):
        rmsnorm.launches = rmsnorm.bwd_launches = 0
        flash_attention.launches = 0
        loss_fn = make_loss_fn(cfg, TrainConfig(attention_impl=impl,
                                                remat=True), cuda)
        out[impl] = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        counts = (rmsnorm.launches, rmsnorm.bwd_launches,
                  flash_attention.launches)
        blocks = len(cfg.unit) * cfg.n_units
        attn = sum(b.kind == "attn" for b in cfg.unit) * cfg.n_units
        assert counts == ((2 * blocks + 1, blocks + 1, 2 * attn)
                          if impl == "auto" else (0, 0, 0)), counts
    ((la, _), ga), ((ln, _), gn) = out["auto"], out["naive"]
    assert float(la) == pytest.approx(float(ln), rel=1e-5)
    for (path, a), b in zip(named_leaves(ga), leaves(gn)):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                   msg=str(path))


# ---- SSM training: the SSD backward kernel, the split-row norm's -------

def _ssd_grads_close(got, want, dtype, model=False):
    """float32: 1e-4 of each gradient's largest; bf16: one output ulp,
    save that against the rounding model (`model`) the fp32 outputs ddt
    and dA, which no bf16 rounding blurs, hold to 1e-4 of their largest
    (3.0e-5 seen on an H100 80GB HBM3)."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        g, w = g.float(), w.float()
        if dtype == "float32" or (model and name in ("ddt", "dA")):
            err = float((g - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (name, err)
        else:
            torch.testing.assert_close(g, w, atol=2e-2, rtol=2.0 ** -7,
                                       msg=name)


def _bwd_kernel(x, dt, A, B, C, dy):
    """`_launch_bwd` as `_SSD` calls it: a bf16 call reads the states its
    forward kept.  Returns the gradients and the states."""
    states = (_launch(x, dt, A, B, C, keep=True)[1]
              if x.dtype == torch.bfloat16 else None)
    return _launch_bwd(x, dt, A, B, C, dy, states), states


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,L,H,P,N,steep", [
    (1, 64, 4, 16, 16, False), (1, 100, 4, 16, 32, False),
    (2, 256, 8, 32, 32, False), (1, 1000, 4, 64, 128, False),
    (1, 64, 2, 16, 16, True),           # steep decay: A = -50, dt ~ 5
    (8, 1024, 24, 64, 128, False),      # mamba2-130m's train shape
    (2, 1024, 80, 64, 64, False),       # zamba2-2.7b's
    (2, 384, 3, 16, 64, False),         # the tensor-core route's least P
    (1, 256, 2, 64, 16, False),         # ... and least N
    (2, 130, 3, 32, 128, False)])       # ragged: 2 chunks, 2 rows in the last
def test_ssd_backward_kernel_matches_plain(cuda, dtype, b, L, H, P, N,
                                           steep):
    """Against autograd through `ssd_plain` and `ssd_bwd_plain`; bf16 (the
    tensor-core route) also against its rounding model
    `ssd_bwd_tc_plain` (ddt and dA at 1e-4 of their largest), with dA
    exactly 0 at the steep decay."""
    x, dt, A, B, C = _ssd_inputs(b, L, H, P, N, DTYPES[dtype], cuda, steep)
    dy = _t(np.random.default_rng(7).standard_normal((b, L, H, P)),
            DTYPES[dtype], cuda)
    before, tc_before = ssd.bwd_launches, ssd.bwd_tc_launches
    got, states = _bwd_kernel(x, dt, A, B, C, dy)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1
    assert ssd.bwd_tc_launches == tc_before + (dtype == "bfloat16")
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(ssd_plain(*ins, 64), ins, dy)
    _ssd_grads_close(got, want, dtype)
    _ssd_grads_close(got, ssd_bwd_plain(x, dt, A, B, C, dy, 64), dtype)
    if dtype == "bfloat16":
        _ssd_grads_close(got, ssd_bwd_tc_plain(
            x, dt, A, B, C, dy, bwd_heads_per_group(b, L, H, cuda)), dtype,
            model=True)
    if steep:
        assert bool((got[2] == 0).all())
    again = _launch_bwd(x, dt, A, B, C, dy, states)   # no atomics
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_ssd_tc_backward_rejects_what_it_cannot_take(cuda):
    """The bf16 backward reads the forward's states and takes the forward
    route's widths; it raises, without launching, for anything else."""
    x, dt, A, B, C = _ssd_inputs(1, 200, 2, 16, 16, torch.bfloat16, cuda)
    dy = torch.ones_like(x)
    states = _launch(x, dt, A, B, C, keep=True)[1]
    before = ssd.bwd_launches
    with pytest.raises(ValueError, match="forward's states"):
        _launch_bwd(x, dt, A, B, C, dy)
    with pytest.raises(ValueError, match="forward's states"):
        _launch_bwd(x, dt, A, B, C, dy, states[:, :0])
    for P, N in ((48, 16), (16, 256)):
        w = _ssd_inputs(1, 200, 2, P, N, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="tensor-core kernel"):
            _launch_bwd(*w, torch.ones_like(w[0]), states)
    assert ssd.bwd_launches == before


def test_ssd_forward_keeps_states_only_for_a_gradient(cuda):
    """A bf16 forward whose inputs need a gradient saves its fp32 states
    for the backward beside its inputs; without grad, or with no input
    that needs one, it saves nothing."""
    b, L, H, P, N = 2, 300, 4, 64, 64
    x, dt, A, B, C = _ssd_inputs(b, L, H, P, N, torch.bfloat16, cuda)
    shape = (b, -(-L // TC_CHUNK) - 1, H, P, N)
    packed = []

    def run():
        """y, and the states among the tensors autograd saved"""
        packed.clear()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            y = ssd(*leaves)[0]
        return y, [t for t in packed if t.shape == shape]

    leaves = [x, dt, A, B, C]
    for grad in (False, True):              # no input needs a gradient
        with torch.set_grad_enabled(grad):
            y, kept = run()
        assert y.grad_fn is None and kept == []
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    with torch.no_grad():
        y, kept = run()
    assert y.grad_fn is None and kept == []
    y, kept = run()
    assert y.grad_fn is not None and len(packed) == 6 and len(kept) == 1
    assert kept[0].dtype == torch.float32


def test_ssd_autograd_launches_the_backward_kernel(cuda):
    """bf16 split views of one conv output, as the model hands them in:
    the wrapper's forward once, its backward kernel once, and the
    gradient of the conv output equal to autograd through `ssd_plain` on
    the same views."""
    rng = np.random.default_rng(8)
    b, L, H, P, N = 2, 300, 4, 64, 64
    xBC = _t(0.5 * rng.standard_normal((b, L, H * P + 2 * N)),
             torch.bfloat16, cuda)
    dt = _t(np.logaddexp(rng.standard_normal((b, L, H)), 0.0),
            torch.float32, cuda)
    A = _t(-np.exp(0.3 * rng.standard_normal(H)), torch.float32, cuda)
    dy = _t(rng.standard_normal((b, L, H, P)), torch.bfloat16, cuda)
    grads = []
    for run in ("kernel", "plain"):
        leaves = [xBC.clone().requires_grad_(), dt.clone().requires_grad_(),
                  A.clone().requires_grad_()]
        x, B, C = torch.split(leaves[0], [H * P, N, N], dim=-1)
        x = x.reshape(b, L, H, P)
        fwd0, bwd0, tc0 = ssd.launches, ssd.bwd_launches, ssd.bwd_tc_launches
        y = (ssd(x, leaves[1], leaves[2], B, C)[0] if run == "kernel"
             else ssd_plain(x, leaves[1], leaves[2], B, C, 64))
        y.backward(dy)
        torch.cuda.synchronize()
        assert (ssd.launches - fwd0, ssd.bwd_launches - bwd0,
                ssd.bwd_tc_launches - tc0) == (
            (1, 1, 1) if run == "kernel" else (0, 0, 0))
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,whole,ranks", [(2048, 5120, 16), (33, 300, 3),
                                              (2, 5120, 4), (257, 1536, 4)])
def test_rmsnorm_split_backward_matches_plain(cuda, dtype, rows, whole,
                                              ranks):
    """Each simulated rank's backward pair, its `sum_rows` adding the
    other ranks' dots, against autograd through every rank's
    `rmsnorm_split_ref` on float32 copies (one loss over all ranks'
    outputs) and against `rmsnorm_split_bwd_ref`; dscale to the whole
    backward's bound (`_dscale_bound`)."""
    rng = np.random.default_rng(13)
    xw = _t(rng.standard_normal((rows, whole)), DTYPES[dtype], cuda)
    gw = _t(rng.standard_normal((rows, whole)), DTYPES[dtype], cuda)
    sw = _t(1.0 + 0.3 * rng.standard_normal(whole), DTYPES[dtype], cuda)
    d = whole // ranks
    cols = [slice(r * d, (r + 1) * d) for r in range(ranks)]
    xs = [xw[:, c].float().requires_grad_() for c in cols]
    ss = [sw[c].float().requires_grad_() for c in cols]
    loss = sum((rmsnorm_split_ref(xs[r], ss[r], whole, lambda v, r=r: v + sum(
        (xs[k] * xs[k]).sum(-1) for k in range(ranks) if k != r))
        * gw[:, c].float()).sum() for r, c in enumerate(cols))
    auto = torch.autograd.grad(loss, xs + ss)
    sq = (xw.float() ** 2).sum(-1)
    dots = [(gw[:, c].float() * sw[c].float() * xw[:, c].float()).sum(-1)
            for c in cols]
    for r, c in enumerate(cols):
        def sum_dots(v, r=r):
            return v + sum(dots[k] for k in range(ranks) if k != r)
        before = rmsnorm.bwd_launches
        dx, ds = rmsnorm_split_bwd(xw[:, c], gw[:, c].contiguous(),
                                   sw[c].contiguous(), sq, whole, sum_dots)
        torch.cuda.synchronize()
        assert rmsnorm.bwd_launches == before + 1
        assert dx.dtype == xw.dtype and ds.dtype == sw.dtype
        rdx, rds = rmsnorm_split_bwd_ref(xw[:, c], gw[:, c], sw[c], sq,
                                         whole, sum_dots)
        for want in (auto[r], rdx):
            torch.testing.assert_close(dx.float(), want.float(),
                                       atol=TOL[dtype], rtol=RTOL[dtype])
        atol = 1e-5 * (gw[:, c].float() * xw[:, c].float() * torch.rsqrt(
            sq / whole + 1e-6)[:, None]).abs().sum(0)
        rtol = RTOL[dtype]
        for want in (auto[ranks + r], rds):
            err = (ds.float() - want.float()).abs()
            assert bool((err <= atol + rtol * want.float().abs()).all())


def test_rmsnorm_split_autograd_launches_the_backward_pair(cuda):
    """`rmsnorm_split` under autograd: the forward pair once, the
    backward pair once, `sum_rows` called again in the backward; one
    rank's columns, the rest of the rows' sums added by `sum_rows`."""
    rng = np.random.default_rng(14)
    xw = _t(rng.standard_normal((3, 37, 256)), torch.bfloat16, cuda)
    gw = _t(rng.standard_normal((3, 37, 64)), torch.bfloat16, cuda)
    s = _t(1.0 + 0.3 * rng.standard_normal(64), torch.bfloat16, cuda)
    other_sq = (xw[..., 64:].float() ** 2).sum(-1).reshape(-1)
    calls = []

    def sum_rows(v):
        calls.append(v.shape)
        return v + (other_sq if len(calls) == 1 else other_dot)

    xa, sa = xw[..., :64].clone().requires_grad_(), s.clone().requires_grad_()
    other_dot = torch.zeros_like(other_sq)       # the other ranks' g is 0
    before = (rmsnorm.launches, rmsnorm.split_launches, rmsnorm.bwd_launches)
    rmsnorm_split(xa, sa, 256, sum_rows).backward(gw)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm.split_launches,
            rmsnorm.bwd_launches) == tuple(n + 1 for n in before)
    assert calls == [(3 * 37,), (3 * 37,)]
    sq = (xw.float() ** 2).sum(-1).reshape(-1)
    rdx, rds = rmsnorm_split_bwd_ref(xw[..., :64], gw, s, sq, 256,
                                     lambda v: v)
    torch.testing.assert_close(xa.grad.float(), rdx.float(),
                               atol=TOL["bfloat16"], rtol=RTOL["bfloat16"])
    torch.testing.assert_close(sa.grad.float(), rds.float(), atol=2e-2,
                               rtol=RTOL["bfloat16"])


# ---- the gated norm (the Mamba2 mixer's y * silu(z), folded in) ----------

def _gated_inputs(rng, shape, dtype, dev, z_offset=None):
    """y, z, g from the seed; z a column view of a wider tensor (as
    `in_proj`'s output hands it over) starting at `z_offset`, else
    contiguous."""
    d = shape[-1]
    y = _t(rng.standard_normal(shape), dtype, dev)
    g = _t(rng.standard_normal(shape), dtype, dev)
    if z_offset is None:
        z = _t(2.0 * rng.standard_normal(shape), dtype, dev)
    else:
        wide = _t(2.0 * rng.standard_normal(shape[:-1] + (2 * d + 40,)),
                  dtype, dev)
        z = wide[..., z_offset:z_offset + d]
    return y, z, g


def _dscale_bound_gated(y, z, g, dtype):
    """`_dscale_bound` at v = y * silu(z), the rounded v the norm sees."""
    return _dscale_bound(gate_ref(y, z), g, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,z_offset", [
    ((8192, 1536), 0),      # mamba2-130m's train rows, z a column view
    ((2048, 5120), 0),      # zamba2-2.7b's
    ((2, 64, 128), None), ((300, 96), None), ((1, 1, 256), 8),
    ((3, 37, 1536), 16),    # a view at an aligned offset
    ((33, 100), None),      # d not a multiple of 8: bf16's scalar kernels
    ((257, 384), 3),        # z not 16-byte aligned: read by elements
    ((3, 9000), None),      # wider than the gated vector kernels take
    ((5, 20000), None)])    # wider than the vector kernels take
def test_rmsnorm_gated_matches_plain(cuda, dtype, shape, z_offset):
    """The gated norm's forward and backward kernels against
    `rmsnorm_gated_ref` and `rmsnorm_gated_bwd_ref` (the same rounding
    points; dv kept in fp32 in both): outputs, dy and dz at the file's
    tolerances, dscale at `_dscale_bound`; one launch each way, dscale's
    sum folded in (no `rmsnorm_dscale_sum`: the library's own count of
    its launches), the same bits when repeated."""
    rng = np.random.default_rng(15)
    y, z, g = _gated_inputs(rng, shape, DTYPES[dtype], cuda, z_offset)
    s = _t(1.0 + 0.3 * rng.standard_normal(shape[-1]), DTYPES[dtype], cuda)
    n0 = (rmsnorm.launches, rmsnorm.gated_launches)
    out, n = _rmsnorm_kernels(lambda: rmsnorm_gated(y, z, s))
    assert (rmsnorm.launches, rmsnorm.gated_launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    assert n == 1
    torch.testing.assert_close(out.float(),
                               rmsnorm_gated_ref(y, z, s).float(),
                               atol=TOL[dtype], rtol=RTOL[dtype])
    b0 = (rmsnorm.bwd_launches, rmsnorm.gated_bwd_launches)
    (dy, dz, ds), n = _rmsnorm_kernels(lambda: rmsnorm_gated_bwd(y, z, g, s))
    assert (rmsnorm.bwd_launches, rmsnorm.gated_bwd_launches) == (
        b0[0] + 1, b0[1] + 1)
    assert n == 1                            # no rmsnorm_dscale_sum
    rdy, rdz, rds = rmsnorm_gated_bwd_ref(y, z, g, s)
    assert (dy.dtype, dz.dtype, ds.dtype) == (y.dtype, y.dtype, s.dtype)
    for got, want in ((dy, rdy), (dz, rdz)):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=RTOL[dtype])
    atol, rtol = _dscale_bound_gated(y, z, g, dtype)
    err = (ds.float() - rds.float()).abs()
    assert bool((err <= atol + rtol * rds.float().abs()).all())
    again = rmsnorm_gated_bwd(y, z, g, s)    # no atomics in the sums
    assert all(torch.equal(a, b) for a, b in zip(again, (dy, dz, ds)))


def test_rmsnorm_gated_takes_one_dtype(cuda):
    """The gated kernels take y, z and the scale in one dtype (the
    mixer's): another scale dtype raises, before any launch."""
    y = torch.ones((4, 64), dtype=torch.bfloat16, device=cuda)
    n0 = rmsnorm.launches
    with pytest.raises(TypeError, match="one dtype"):
        rmsnorm_gated(y, y, torch.ones(64, device=cuda))
    with pytest.raises(TypeError, match="one dtype"):
        rmsnorm_split(y, torch.ones(64, device=cuda), 128, lambda v: v,
                      gate=y)
    assert rmsnorm.launches == n0


def test_rmsnorm_gated_autograd_saves_y_and_z(cuda):
    """`rmsnorm_gated` under autograd: one forward and one backward
    launch, the gradients the backward kernel's, of y, of z (a column
    view) and of the scale."""
    rng = np.random.default_rng(16)
    y, z, g = _gated_inputs(rng, (2, 37, 192), torch.bfloat16, cuda, 0)
    s = _t(1.0 + 0.3 * rng.standard_normal(192), torch.bfloat16, cuda)
    wide = z._base.clone().requires_grad_()
    ya, sa = y.clone().requires_grad_(), s.clone().requires_grad_()
    n0 = (rmsnorm.launches, rmsnorm.bwd_launches)
    rmsnorm_gated(ya, wide[..., :192], sa).backward(g)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    dy, dz, ds = rmsnorm_gated_bwd(y, z, g, s)
    assert torch.equal(ya.grad, dy) and torch.equal(sa.grad, ds)
    assert torch.equal(wide.grad[..., :192], dz)
    assert not bool(wide.grad[..., 192:].any())


@pytest.mark.parametrize("gated", [False, True])
def test_folded_dscale_keeps_the_two_launch_bits(cuda, gated):
    """dscale's sum folded into the backward kernel adds the partial rows
    in `rmsnorm_dscale_sum`'s order: the whole row's backward, plain and
    gated, with the fold equals its two-launch version bit for bit
    (vector and scalar kernels, one partial row and many)."""
    rng = np.random.default_rng(17)
    for shape in ((8192, 1536), (2048, 5120), (33, 100), (3, 12),
                  (5, 20000)):
        y, z, g = _gated_inputs(rng, shape, torch.bfloat16, cuda, 0)
        s = _t(1.0 + 0.3 * rng.standard_normal(shape[-1]),
               torch.bfloat16 if gated else torch.float32, cuda)
        z = z if gated else None
        two = rmsnorm_ops._bwd(y, z, g, s, 1e-6, fold=False)
        for _ in range(2):
            got = rmsnorm_ops._bwd(y, z, g, s, 1e-6, fold=True)
            assert all(a is b or torch.equal(a, b)
                       for a, b in zip(got, two)), shape


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,whole,ranks,z_offset", [
    (2048, 5120, 16, 0), (2048, 5120, 4, 0), (33, 300, 3, None),
    (2, 5120, 4, 0), (257, 1536, 4, 3)])
def test_rmsnorm_split_gated_matches_plain(cuda, dtype, rows, whole, ranks,
                                           z_offset):
    """Each simulated rank's gated split pair, its `sum_rows` adding the
    other ranks' squares (forward) or dots (backward), against its plain
    versions (`rmsnorm_split_ref(..., gate=z)`,
    `rmsnorm_split_gated_bwd_ref`) and the forward against the whole
    row's gated norm; two launches each way, dscale's sum folded into the
    second, the same bits when repeated."""
    rng = np.random.default_rng(18)
    yw, zw, gw = _gated_inputs(rng, (rows, whole), DTYPES[dtype], cuda,
                               z_offset)
    sw = _t(1.0 + 0.3 * rng.standard_normal(whole), DTYPES[dtype], cuda)
    d = whole // ranks
    cols = [slice(r * d, (r + 1) * d) for r in range(ranks)]
    vw = gate_ref(yw, zw).float()
    sq = (vw * vw).sum(-1)
    dots = [(gw[:, c].float() * sw[c].float() * vw[:, c]).sum(-1)
            for c in cols]
    whole_out = rmsnorm_gated_ref(yw, zw, sw)
    for r, c in enumerate(cols):
        local_sq = (vw[:, c] * vw[:, c]).sum(-1)

        def sum_rows(v, r=r, local_sq=local_sq):
            return v + (sq - local_sq)

        def sum_dots(v, r=r):
            return v + sum(dots[k] for k in range(ranks) if k != r)

        y, z, g, s = yw[:, c], zw[:, c], gw[:, c].contiguous(), \
            sw[c].contiguous()
        n0 = (rmsnorm.launches, rmsnorm.split_launches,
              rmsnorm.gated_launches)
        out, n = _rmsnorm_kernels(
            lambda: rmsnorm_split(y, s, whole, sum_rows, gate=z))
        assert (rmsnorm.launches, rmsnorm.split_launches,
                rmsnorm.gated_launches) == tuple(k + 1 for k in n0)
        assert n == 2
        for want in (rmsnorm_split_ref(y, s, whole, sum_rows, gate=z),
                     whole_out[:, c]):
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[dtype], rtol=RTOL[dtype])
        b0 = rmsnorm.bwd_launches
        (dy, dz, ds), n = _rmsnorm_kernels(
            lambda: rmsnorm_split_gated_bwd(y, z, g, s, sq, whole,
                                            sum_dots))
        assert rmsnorm.bwd_launches == b0 + 1
        assert n == 2                        # no rmsnorm_dscale_sum
        rdy, rdz, rds = rmsnorm_split_gated_bwd_ref(y, z, g, s, sq, whole,
                                                    sum_dots)
        for got, want in ((dy, rdy), (dz, rdz)):
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=RTOL[dtype])
        atol = 1e-5 * (g.float() * vw[:, c] * torch.rsqrt(
            sq / whole + 1e-6)[:, None]).abs().sum(0)
        err = (ds.float() - rds.float()).abs()
        assert bool((err <= atol + RTOL[dtype] * rds.float().abs()).all())
        again = rmsnorm_split_gated_bwd(y, z, g, s, sq, whole, sum_dots)
        assert all(torch.equal(a, b) for a, b in zip(again, (dy, dz, ds)))


def test_rmsnorm_split_backward_pair_folds_dscale(cuda):
    """The ungated split backward is two launches too, dscale's sum
    folded into its second; the whole row's ungated backward keeps its
    two (the kernel, then `rmsnorm_dscale_sum`)."""
    rng = np.random.default_rng(19)
    x = _t(rng.standard_normal((2048, 320)), torch.bfloat16, cuda)
    g = _t(rng.standard_normal((2048, 320)), torch.bfloat16, cuda)
    s = _t(1.0 + 0.3 * rng.standard_normal(320), torch.bfloat16, cuda)
    sq = (x.float() ** 2).sum(-1) * 16
    _, n = _rmsnorm_kernels(
        lambda: rmsnorm_split_bwd(x, g, s, sq, 5120, lambda v: v))
    assert n == 2
    _, n = _rmsnorm_kernels(lambda: rmsnorm_bwd(x, g, s))
    assert n == 2                            # the whole row's: two launches


def ssm_train_launches(cfg):
    """Launches of one train step with remat of an SSM arch: every
    Mamba2 block's pre-norm and gated norm, and each shared block's two
    norms, in the forward and again in the recompute, the final norm
    once; one norm backward per norm; the SSD forward twice and its
    backward once a mixer; the shared blocks' attention twice."""
    mixers = cfg.n_layers
    shared = cfg.n_layers // cfg.shared_attn_every if \
        cfg.shared_attn_every else 0
    norms = 2 * mixers + 2 * shared
    return {"rmsnorm": 2 * norms + 1, "rmsnorm.bwd": norms + 1,
            "flash_attention": 2 * shared, "ssd": 2 * mixers,
            "ssd_bwd": mixers}


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_train_step_kernels_match_plain_path(cuda, arch):
    """One reduced train step on the card, float32 weights, remat on:
    impl "auto" (the SSD kernel and its backward, the RMSNorm kernels
    and, in zamba2's shared blocks, flash attention) against impl
    "naive" (`ssd_scan`, plain attention and norms): loss 1e-5 relative,
    gradients 1e-4 of each leaf's largest, as the dense archs' test; the
    launch counts of `ssm_train_launches`."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.runtime.train import (TrainConfig, make_loss_fn,
                                           value_and_grad)
    from repro_torch.tree import leaves, named_leaves, tree_map
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.float().to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 101),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    wrappers = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "ssd": ssd}
    out = {}
    for impl in ("auto", "naive"):
        for w in wrappers.values():
            w.launches = 0
        rmsnorm.bwd_launches = ssd.bwd_launches = 0
        loss_fn = make_loss_fn(cfg, TrainConfig(attention_impl=impl,
                                                remat=True), cuda)
        out[impl] = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        counts.update({"rmsnorm.bwd": rmsnorm.bwd_launches,
                       "ssd_bwd": ssd.bwd_launches})
        want = ssm_train_launches(cfg) if impl == "auto" else \
            dict.fromkeys(counts, 0)
        assert counts == want, (impl, counts)
    ((la, _), ga), ((ln, _), gn) = out["auto"], out["naive"]
    assert float(la) == pytest.approx(float(ln), rel=1e-5)
    for (path, a), b in zip(named_leaves(ga), leaves(gn)):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                   msg=str(path))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,d,f,rows", [
    (8, 6144, 16384, 8192),      # mixtral: 4 x 1024 tokens, top 2
    (384, 7168, 2048, 16384),    # kimi: 2 x 1024 tokens, top 8
    (8, 64, 32, 40),             # reduced configs
])
def test_grouped_mm_on_the_card_matches_the_per_expert_loop(cuda, dtype, E,
                                                            d, f, rows):
    """The MoE block's grouped GEMM (`torch._grouped_mm`, a library call)
    against its plain per-expert loop, with uneven and empty groups (a
    skewed draw of each row's expert); tolerances as the kernels'."""
    from repro_torch.models.moe import grouped_mm, grouped_mm_plain
    gen = torch.Generator().manual_seed(0)
    pick = torch.multinomial(torch.rand(E, generator=gen) ** 3, rows,
                             replacement=True, generator=gen)
    sizes = torch.bincount(pick, minlength=E).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(rows, d, generator=gen, device=cuda).to(DTYPES[dtype])
    w = (torch.randn(E, d, f, generator=gen, device=cuda) / d ** 0.5).to(
        DTYPES[dtype])
    got = grouped_mm(x, w, sizes)
    want = grouped_mm_plain(x, w, sizes)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (rows, f)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=TOL[dtype],
                               rtol=RTOL[dtype])


def test_parallel_moe_paths_across_four_cards_match_gloo(tmp_path):
    """The expert-parallel and TP-ff blocks (and the dropless path with
    the mesh) on four cards, one NCCL rank each on a (2, 2) mesh, against
    the same four ranks on gloo on the CPU: y, aux and the summed
    gradients within 1e-5 of the largest (float32, TF32 off; the cards'
    matmuls and reductions add in another order).  Skips on fewer than
    four cards (run it with four)."""
    from _torch_dist import finish, moe_results, start_ranks
    from _torch_dist_worker import moe_inputs
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (one NCCL rank each)")
    runs = {}
    for device in ("cpu", "cuda"):
        work = tmp_path / device
        work.mkdir()
        np.savez(work / "moe_in.npz", **moe_inputs())
        runs[device] = finish(start_ranks("moe", 4, work, device), 300)
    names = ["ep_8.0", "tp_8.0", "ep_1.25", "tp_1.25", "gspmd"]
    for name in names:
        (y_c, aux_c, g_c), (y_g, aux_g, g_g) = (
            moe_results(runs[d], name) for d in ("cpu", "cuda"))
        np.testing.assert_allclose(y_g, y_c, rtol=0,
                                   atol=1e-5 * np.abs(y_c).max(),
                                   err_msg=name)
        assert abs(aux_g - aux_c) <= 1e-5 * abs(aux_c), name
        for k, want in g_c.items():
            np.testing.assert_allclose(
                g_g[k], want, rtol=0, atol=1e-5 * np.abs(want).max(),
                err_msg=f"{name} {k}")
    # at capacity 1.25 rows drop on the cards as on the CPU
    y_drop = moe_results(runs["cuda"], "ep_1.25")[0]
    y_all = moe_results(runs["cuda"], "ep_8.0")[0]
    assert np.abs(y_drop - y_all).max() > 1e-2


#: first moments within this fraction of each leaf's largest
#: (`chip_smoke.py` phase 5's bound); second moments within twice it, as
#: nu is quadratic in the gradient: (1 - b2) 2 g dg against (1 - b2) g_max^2
MU_RTOL = 1e-4
NU_RTOL = 2e-4
SETTLED_ATOL = 1e-6


def _adam_reach(opt, t):
    """The largest |m_hat| / sqrt(v_hat) AdamW's step t (from 1) can take
    (Cauchy-Schwarz over the moments' weights: 1 at the first step)."""
    a = [(1 - opt.b1) * opt.b1 ** (t - i) for i in range(1, t + 1)]
    c = [(1 - opt.b2) * opt.b2 ** (t - i) for i in range(1, t + 1)]
    return (sum(x * x / y for x, y in zip(a, c)) * (1 - opt.b2 ** t)) \
        ** 0.5 / (1 - opt.b1 ** t)


def _update_spread(opt, t, mu, nu):
    """How far AdamW's step-t update u = m_hat / (sqrt(v_hat) + eps) of
    each element can move while its moments stay within MU_RTOL and
    NU_RTOL of the leaf's largest of `mu` and `nu` (u is monotone in
    each; clamped to the reach of `_adam_reach`)."""
    bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    dm = MU_RTOL * float(mu.abs().max())
    dv = NU_RTOL * float(nu.abs().max())

    def u(m, v):
        return (m / bc1) / (torch.sqrt(v.clamp(min=0) / bc2) + opt.eps)

    hi_m, lo_m = mu + dm, mu - dm
    hi = torch.where(hi_m >= 0, u(hi_m, nu - dv), u(hi_m, nu + dv))
    lo = torch.where(lo_m < 0, u(lo_m, nu - dv), u(lo_m, nu + dv))
    reach = _adam_reach(opt, t)
    mid = u(mu, nu)
    return torch.maximum(hi.clamp(max=reach) - mid,
                         mid - lo.clamp(min=-reach))


def _states_close(got, want, opt, where, readings):
    """Full-width float32 states on a mesh, after each step, against the
    meshless ones.  Every optimizer leaf within MU_RTOL (mu) or NU_RTOL
    (nu) of its largest.  Params within what those moment errors let
    AdamW's updates move them: per element the sum over steps of lr x
    `_update_spread` (with weight decay's share of the earlier error),
    plus 2^-22 of the leaf's largest for float32 rounding; except that
    the first step moves a weight whose first moment is clear of zero by
    twice MU_RTOL of the largest by lr x sign(g) on both sides, so there
    it counts SETTLED_ATOL (`chip_smoke.py` phase 5's bound).  Appends
    each leaf's readings to `readings`."""
    from repro_torch.optim.optimizers import cosine_lr
    from repro_torch.tree import named_leaves
    assert len(got) == len(want)
    bound = {}
    for t, (g_state, w_state) in enumerate(zip(got, want), start=1):
        w_state = {"/".join(p): v.cpu() for p, v in named_leaves(w_state)}
        assert g_state.keys() == w_state.keys()
        lr = float(cosine_lr(opt, torch.tensor(t - 1)))
        for name, w in w_state.items():
            if not name.startswith("params/"):
                continue
            leaf = name[len("params/"):]
            mu, nu = w_state["opt/mu/" + leaf], w_state["opt/nu/" + leaf]
            decay = opt.weight_decay if w.ndim >= 2 else 0.0
            step_bound = lr * _update_spread(opt, t, mu, nu)
            if t == 1:
                settled = mu.abs() > 2 * MU_RTOL * mu.abs().max()
                step_bound = torch.where(settled, SETTLED_ATOL, step_bound)
            bound[leaf] = bound.get(leaf, 0.0) * abs(1 - lr * decay) + \
                step_bound
        for name, w in w_state.items():
            g = g_state[name]
            d = (g - w).abs()
            if name == "step":
                assert torch.equal(g, w), f"{where} step {t}"
                continue
            top = max(float(w.abs().max()), 1e-30)
            if name.startswith("opt/"):
                rtol = MU_RTOL if name.startswith("opt/mu/") else NU_RTOL
                err = float(d.max()) / top
                readings.append(dict(where=where, step=t, leaf=name,
                                     err_of_largest=err))
                assert err <= rtol, \
                    f"{where} step {t} {name}: {err:.3g} of the largest"
                continue
            leaf = name[len("params/"):]
            mu = w_state["opt/mu/" + leaf].abs()
            allowed = bound[leaf] + 2.0 ** -22 * top
            worst = int(torch.argmax(d / allowed))
            old_mask = mu > 1e-3 * mu.max()
            old_fail = old_mask & (d > 1e-4)
            readings.append(dict(
                where=where, step=t, leaf=name, max_err=float(d.max()),
                worst_share_of_bound=float(d.flatten()[worst]
                                           / allowed.flatten()[worst]),
                mu_at_max_err_of_largest=float(
                    mu.flatten()[int(torch.argmax(d))] / mu.max()),
                old_check_failures=int(old_fail.sum()),
                old_check_failing_mu_of_largest=(
                    [float(mu[old_fail].min() / mu.max()),
                     float(mu[old_fail].max() / mu.max())]
                    if old_fail.any() else None)))
            assert bool((d <= allowed).all()), \
                f"{where} step {t} {name}: {float(d.flatten()[worst]):.3g} " \
                f"against {float(allowed.flatten()[worst]):.3g}"


def test_tensor_parallel_full_width_smollm_across_four_cards(tmp_path):
    """Full-width smollm-360m in float32 (TF32 off) on four cards, one
    NCCL rank each: two AdamW train steps (4 x 256 tokens each, remat on,
    as the step runs by default: each unit's weights gathered in the
    forward and again in the recompute) on (1, 4) and (2, 2) meshes
    equal the meshless steps on one card (losses 1e-5
    relative; rank 0's whole state after each step as `_states_close`),
    and on (2, 2) `serve_loop` (4 requests on 4 slots) gives the meshless
    loop's tokens.  At full width 15 heads do not divide 'model', so the
    projections are gathered and every rank attends with every head; the
    vocabulary (49152) is vocab-parallel.  Prints each leaf's readings,
    and each rank's largest `max_memory_allocated` of a step (the
    weights gathered one unit at a time), one JSON line each (run with
    -s).  Skips on fewer than four cards (run it with four)."""
    import dataclasses
    import json

    from _torch_dist import finish, start_ranks
    from _torch_dist_worker import seeded_params

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.optim.optimizers import (OptimizerConfig,
                                              build_optimizer)
    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import named_leaves, tree_map
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (one NCCL rank each)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["smollm-360m"]
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [{k: torch.from_numpy(v) for k, v in batch_for_model(
        cfg, DataConfig(seq_len=256, global_batch=4,
                        vocab_size=cfg.vocab_size), i).items()}
        for i in (0, 1)]
    train = {"smollm": {"cfg": cfg, "opt": opt, "batches": batches,
                        "params": 0, "every_step": True, "remat": True}}
    serve = {"smollm": {"cfg": cfg, "params": 1, "slots": 4, "max_new": 6,
                        "max_len": 32,
                        "queue": make_requests(4, cfg.vocab_size)}}
    got = {}
    for shape in ((1, 4), (2, 2)):
        work = tmp_path / f"{shape[0]}x{shape[1]}"
        work.mkdir()
        spec = {"mesh": shape, "train": train}
        if shape == (2, 2):
            spec["serve"] = serve
        torch.save(spec, work / "tp_in.pt")
        got[shape] = finish(start_ranks("tp", 4, work, "cuda"), 600)
    dev = torch.device("cuda")
    params = seeded_params(cfg, 0, dev)
    old = {"/".join(p): t.cpu() for p, t in named_leaves(params)}
    ocfg = OptimizerConfig(**opt)
    step, _ = make_train_step(cfg, TrainConfig(optimizer=ocfg, remat=True),
                              dev)
    state = {"params": params, "opt": build_optimizer(ocfg).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    losses, states = [], []
    for b in batches:
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
        states.append(tree_map(lambda t: t.cpu(), state))
    del state, params
    run = serve["smollm"]
    want_tokens, _ = serve_loop(seeded_params(cfg, 1, dev), cfg,
                                ServeConfig(max_len=run["max_len"]),
                                [list(q) for q in run["queue"]],
                                run["slots"], run["max_new"], dev)
    for rank in got[(2, 2)]:
        assert rank["serve"]["smollm"] == want_tokens
    readings = [dict(where=f"{shape}", rank=r, max_memory_allocated=rank[
        "train"]["smollm"]["max_memory_allocated"])
        for shape, ranks in got.items() for r, rank in enumerate(ranks)]
    try:
        for shape, ranks in got.items():
            for r, rank in enumerate(ranks):
                res = rank["train"]["smollm"]
                np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
                assert len(res["states"]) == (2 if r == 0 else 0)
            _states_close(ranks[0]["train"]["smollm"]["states"], states,
                          ocfg, f"{shape}", readings)
    finally:
        for line in readings:
            print("readings:", json.dumps(line))
    last = {"/".join(p): t for p, t in named_leaves(states[-1])}
    assert any(not torch.equal(last[f"params/{n}"], t)
               for n, t in old.items())
    assert dataclasses.asdict(cfg)["n_heads"] % 4      # heads split


def test_context_parallel_full_width_smollm_across_four_cards(tmp_path):
    """Full-width smollm-360m's train step at batch 2 x 1024 on a (4, 1)
    mesh of four cards, one NCCL rank each: 'data' does not divide the 2
    rows, so each rank trains on its 256 positions of both rows (context
    parallelism: the keys and values of the whole sequence gathered
    over 'data' after RoPE, the queries at the rank's positions).
    float32 (TF32 off), the kernel routes (flash attention forward,
    RMSNorm forward and backward), remat on.  Two AdamW steps equal one
    card's (losses 1e-5 relative; rank 0's whole state after each step
    as `_states_close`, the bounds of the tensor-parallel test above),
    and each rank launches flash attention, RMSNorm and its backward as
    often a step as one card.  Prints each leaf's readings, and each
    rank's largest `max_memory_allocated` of a step beside one card's,
    one JSON line each (run with -s).  Skips on fewer than four cards
    (run it with four)."""
    import json

    from _torch_dist import finish, start_ranks
    from _torch_dist_worker import seeded_params

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.optim.optimizers import (OptimizerConfig,
                                              build_optimizer)
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import tree_map
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (one NCCL rank each)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["smollm-360m"]
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [{k: torch.from_numpy(v) for k, v in batch_for_model(
        cfg, DataConfig(seq_len=1024, global_batch=2,
                        vocab_size=cfg.vocab_size), i).items()}
        for i in (0, 1)]
    train = {"smollm": {"cfg": cfg, "opt": opt, "batches": batches,
                        "params": 0, "every_step": True, "remat": True,
                        "impl": "auto"}}
    torch.save({"mesh": (4, 1), "train": train}, tmp_path / "tp_in.pt")
    got = finish(start_ranks("tp", 4, tmp_path, "cuda"), 900)
    dev = torch.device("cuda")
    params = seeded_params(cfg, 0, dev)
    ocfg = OptimizerConfig(**opt)
    step, _ = make_train_step(cfg, TrainConfig(optimizer=ocfg, remat=True,
                                               attention_impl="auto"), dev)
    state = {"params": params, "opt": build_optimizer(ocfg).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    losses, states, launches, peak = [], [], [], 0
    for b in batches:
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = rmsnorm.launches = 0
        rmsnorm.bwd_launches = 0
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        peak = max(peak, torch.cuda.max_memory_allocated())
        launches.append({"flash_attention": flash_attention.launches,
                         "rmsnorm": rmsnorm.launches,
                         "rmsnorm.bwd": rmsnorm.bwd_launches})
        losses.append(float(m["loss"]))
        states.append(tree_map(lambda t: t.cpu(), state))
    del state
    readings = [dict(where="(4, 1)", rank=r, max_memory_allocated=rank[
        "train"]["smollm"]["max_memory_allocated"],
        launches=rank["train"]["smollm"]["launches"])
        for r, rank in enumerate(got)]
    readings.append(dict(where="one card", max_memory_allocated=peak,
                         launches=launches))
    try:
        for r, rank in enumerate(got):
            res = rank["train"]["smollm"]
            np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
            assert res["launches"] == launches, r
            assert len(res["states"]) == (2 if r == 0 else 0)
        assert min(launches[0].values()) > 0
        _states_close(got[0]["train"]["smollm"]["states"], states, ocfg,
                      "(4, 1)", readings)
    finally:
        for line in readings:
            print("readings:", json.dumps(line))


def _tree(flat):
    """A nested dict from {"a/b/c": leaf}."""
    out = {}
    for name, leaf in flat.items():
        node, parts = out, name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return out


#: full-width float32 zamba2-2.7b's last-position logits on a (1, 4)
#: mesh against one card: the row-parallel sums and the split norm's
#: squares add over 'model' in another order, float32 rounding that 54
#: random-init layers carry to the logits.  9.19e-4 seen on four H100s
#: (logits up to 4.93); a 1e-7 relative change of the embedding alone
#: moves them by 2.68e-3 (logits up to 7.68; `tests/_torch_perturb.py`
#: at full width on an H100 machine's CPU, plain routes).  The bound is
#: about three times the reading, just over the one-point change.
FULL_ZAMBA2_ATOL = 3e-3


def test_unit_gather_mixtral_and_zamba2_across_four_cards(tmp_path):
    """Reduced mixtral (expert-parallel on (2, 2): its 8 experts divide
    'model', each rank gathers its 4 experts of a unit over 'data') and
    reduced zamba2 (its super-units gathered one at a time, the mixers'
    projections at their 'model' shard, the decode on the rank's shard
    of the state) and reduced smollm (each MLP unit broadcast from the
    'model' rank that holds it, the rules reading its stack as an
    expert stack) on a (2, 2) mesh of four cards, one NCCL rank each:
    two float32 AdamW steps (remat on; TF32 off; smollm on the plain
    routes, mixtral and zamba2 on the kernel routes: zamba2's mixers on
    4 of the 8 heads a rank, through the SSD backward kernel and the
    split-row RMSNorm's backward pair, each rank launching `ssd_bwd` once
    a mixer a step and the split pair's backward once a mixer, its
    forward twice under remat) equal the steps on one card: the two chained steps' losses within 1e-5 relative and
    params within two steps; and each step's optimizer state (rank 0's,
    gathered whole) within 1e-3 of each leaf's largest of one card's
    step from the same state (step 1 from the seed's, step 2 from the
    mesh's step-1 state), since the float32 steps are ill-conditioned as
    the CPU test shows, and chained steps would compound: AdamW's first
    update moves a weight whose gradient is at rounding level by up to
    0.29 lr, so step 2 would start from other params (ROADMAP, Queue 3,
    item 4); and
    6 fed decode steps give the one card's tokens, logits within 1e-3
    (`tests/test_torch_unit_gather.py`'s bounds on the CPU).  MoE at
    capacity 8.0 with the aux loss off, against the dropless path.
    zamba2's float32 prefill on the kernel routes (each rank's mixers
    on 4 of the 8 heads: the SSD kernel on those heads, the RMSNorm
    kernel on the rank's columns of the gated output, the rows' squares
    summed over 'model') gives the one card's last-position logits within
    1e-3 and launches each kernel as often as the one card.  Then
    full-width float32 zamba2-2.7b's prefill of 2 x 1024 tokens (phase
    3c's) on a (1, 4) mesh on the kernel routes, 20 of its 80 heads a
    rank, gives the one card's last-position logits within
    FULL_ZAMBA2_ATOL, each rank launching SSD and RMSNorm as often as the
    one card, both more than 0.  In both prefills each rank's gated norms
    are the split-row pair, one a mixer (`rmsnorm.split_launches` equals
    the config's layers, 12 and 54; the one card's is 0).  Prints, as
    `readings:` lines, each arch's largest optimizer-state error of each
    step over its leaf's largest beside the 1e-3 bound, and each
    prefill's error.  Skips on fewer than four cards
    (run it with four)."""
    import json

    from _torch_dist import finish, start_ranks

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.optim.optimizers import (OptimizerConfig,
                                              build_optimizer)
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import named_leaves
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (one NCCL rank each)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(3)
    train, decode = {}, {}
    for name in ("mixtral-8x22b", "zamba2-2.7b", "smollm-360m"):
        cfg = reduced(ARCHS[name])
        moe = bool(cfg.n_experts)
        batches = [{k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))
            for k in ("tokens", "labels")} for _ in range(2)]
        train[name] = {"cfg": cfg, "opt": opt, "batches": batches,
                       "params": 0, "capacity": 8.0 if moe else 1.25,
                       "aux": 0.0 if moe else 0.01, "remat": True,
                       "impl": "naive" if name == "smollm-360m" else "auto",
                       "every_step": True}
        decode[name] = {"cfg": cfg, "params": 1, "max_len": 16,
                        "capacity": 8.0, "feed": torch.from_numpy(
                            rng.integers(0, cfg.vocab_size, (4, 6)).astype(
                                np.int32))}
    zcfg = reduced(ARCHS["zamba2-2.7b"])
    prefill = {"zamba2-2.7b": {"cfg": zcfg, "params": 2, "impl": "auto",
                               "tokens": torch.from_numpy(rng.integers(
                                   0, zcfg.vocab_size, (4, 64)).astype(
                                       np.int32))}}
    torch.save({"mesh": (2, 2), "train": train, "decode": decode,
                "prefill": prefill}, tmp_path / "tp_in.pt")
    got = finish(start_ranks("tp", 4, tmp_path, "cuda"), 600)
    from _torch_dist_worker import seeded_params
    for name, run in train.items():
        cfg = run["cfg"]
        ocfg = OptimizerConfig(**opt)
        step, _ = make_train_step(cfg, TrainConfig(
            optimizer=ocfg, remat=True, aux_loss_weight=run["aux"],
            attention_impl=run["impl"]), dev)
        params = seeded_params(cfg, 0, dev)
        state = {"params": params, "opt": build_optimizer(ocfg).init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        losses, chained = [], []
        for b in run["batches"]:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            chained.append({"/".join(p): t.cpu()
                            for p, t in named_leaves(state)})
        # each step from the state the mesh's step started from: step 1
        # from the seed's, step 2 from the mesh's step-1 state, gathered
        # whole (rank 0's), so that no step's difference compounds
        mesh_states = got[0]["train"][name]["states"]
        start = _tree({k: v.to(dev) for k, v in mesh_states[0].items()})
        state, _ = step(start, {k: v.to(dev) for k, v in
                                run["batches"][1].items()})
        want = [chained[0], {"/".join(p): t.cpu()
                             for p, t in named_leaves(state)}]
        del start
        for t, (g_state, w_state) in enumerate(zip(mesh_states, want), 1):
            worst = max((float((g_state[leaf] - w).abs().max())
                         / max(float(w.abs().max()), 1e-30), leaf)
                        for leaf, w in w_state.items()
                        if leaf.startswith("opt/"))
            print("readings:", json.dumps(dict(
                arch=name, mesh=[2, 2], step=t, worst_opt_leaf=worst[1],
                max_abs_err_over_leaf_max=worst[0], bound=1e-3)))
            for leaf, w in w_state.items():
                if leaf.startswith("opt/") or leaf == "step":
                    atol = 1e-3 * float(w.abs().max())
                    torch.testing.assert_close(g_state[leaf], w, rtol=0,
                                               atol=atol,
                                               msg=f"{name} step {t} {leaf}")
        for rank in got:
            np.testing.assert_allclose(rank["train"][name]["losses"], losses,
                                       rtol=1e-5)
            if name == "zamba2-2.7b":
                n = cfg.n_layers
                for per_step in rank["train"][name]["launches"]:
                    assert (per_step["ssd"], per_step["ssd_bwd"],
                            per_step["rmsnorm.split"]) == (2 * n, n, 2 * n), \
                        per_step
        for leaf, w in chained[-1].items():
            if leaf.startswith("params/"):
                assert float((mesh_states[-1][leaf] - w).abs().max()) \
                    <= 2.2e-3, leaf
        run = decode[name]
        _, dstep, init_cache = make_serve_fns(
            cfg, ServeConfig(max_len=run["max_len"]), dev)
        params = seeded_params(cfg, 1, dev)
        feed = run["feed"].to(dev)
        cache = init_cache(feed.shape[0])
        toks, logits = [], []
        for pos in range(feed.shape[1]):
            nxt, lg, cache = dstep(params, cache, feed[:, pos:pos + 1], pos)
            toks.append(nxt.cpu())
            logits.append(lg[:, -1:].cpu())
        for rank in got:
            res = rank["decode"][name]
            torch.testing.assert_close(res["logits"], torch.cat(logits, 1),
                                       rtol=0, atol=1e-3)
            assert torch.equal(res["tokens"], torch.cat(toks, 1)), name
        del params, cache, state
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    run = prefill["zamba2-2.7b"]
    fill, _, _ = make_serve_fns(zcfg, ServeConfig(
        max_len=run["tokens"].shape[1], attention_impl="auto"), dev)
    ssd.launches = rmsnorm.launches = rmsnorm.split_launches = 0
    want = fill(seeded_params(zcfg, 2, dev),
                {"tokens": run["tokens"].to(dev)}).cpu()
    launches = {"ssd": ssd.launches, "rmsnorm": rmsnorm.launches}
    assert rmsnorm.split_launches == 0
    for rank in got:
        res = rank["prefill"]["zamba2-2.7b"]
        print("readings:", json.dumps(dict(
            arch="zamba2-2.7b prefill", mesh=[2, 2],
            launches=res["launches"], one_card_launches=launches,
            split_launches=res["split_launches"],
            max_abs_err=float((res["logits"] - want).abs().max()))))
        torch.testing.assert_close(res["logits"], want, rtol=0, atol=1e-3)
        assert res["launches"] == launches and min(launches.values()) > 0
        assert res["split_launches"] == zcfg.n_layers
    del want
    torch.cuda.empty_cache()
    # 3c at full width in float32 on (1, 4): 20 of zamba2-2.7b's 80 heads a
    # rank, the split-row RMSNorm kernels on its 1280 columns
    fcfg = ARCHS["zamba2-2.7b"]
    tokens = torch.from_numpy(rng.integers(0, fcfg.vocab_size, (2, 1024))
                              .astype(np.int32))
    work = tmp_path / "1x4"
    work.mkdir()
    torch.save({"mesh": (1, 4), "prefill": {"zamba2-full": {
        "cfg": fcfg, "params": 3, "impl": "auto", "tokens": tokens}}},
        work / "tp_in.pt")
    full = finish(start_ranks("tp", 4, work, "cuda"), 600)
    fill, _, _ = make_serve_fns(fcfg, ServeConfig(
        max_len=tokens.shape[1], attention_impl="auto"), dev)
    ssd.launches = rmsnorm.launches = rmsnorm.split_launches = 0
    want = fill(seeded_params(fcfg, 3, dev),
                {"tokens": tokens.to(dev)}).cpu()
    launches = {"ssd": ssd.launches, "rmsnorm": rmsnorm.launches}
    assert rmsnorm.split_launches == 0
    for rank in full:
        res = rank["prefill"]["zamba2-full"]
        print("readings:", json.dumps(dict(
            arch="zamba2-2.7b full-width float32 prefill 2 x 1024",
            mesh=[1, 4], launches=res["launches"],
            one_card_launches=launches,
            split_launches=res["split_launches"], bound=FULL_ZAMBA2_ATOL,
            max_abs_logit=float(want.abs().max()),
            max_abs_err=float((res["logits"] - want).abs().max()))))
        torch.testing.assert_close(res["logits"], want, rtol=0,
                                   atol=FULL_ZAMBA2_ATOL)
        assert res["launches"] == launches and min(launches.values()) > 0
        assert res["split_launches"] == fcfg.n_layers


@pytest.fixture
def card():
    """The card, for tests that build no kernel (the analytic plane)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine; these tests run on the "
                    "H100 with -m gpu")
    return torch.device("cuda")


def test_paper_plane_sweep_all_and_a_scaling_point_on_card_match_cpu(card):
    """The paper's sweep and one point of the scale-out frontier (vgg on
    8x8, with its reuse plans) on the card against the port's CPU route
    of the same calls: rtol 1e-9 and the tie rule (`launch/paper_plane`):
    the card's scatter sums run in another order, so an exact tie on the
    CPU may break either way there."""
    from repro_torch.core import make_trace, scaling_sweep, summary, sweep_all
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.launch.paper_plane import (RTOL, compare_scaling,
                                                compare_sweeps)

    traces = {w: make_trace(w, device=card) for w in WORKLOADS}
    assert all(t.nbytes.is_cuda for t in traces.values())
    on_card = sweep_all(traces)
    on_cpu = sweep_all({w: t.to("cpu") for w, t in traces.items()})
    assert compare_sweeps(on_card, on_cpu, RTOL) == []
    (mean64, _), (mean96, max96) = summary(on_card)[64], summary(on_card)[96]
    assert 1.04 <= mean64 <= 1.12 and 1.055 <= mean96 <= 1.145
    assert max96 >= 1.15
    a = scaling_sweep(["vgg"], [(8, 8)], device=card)
    b = scaling_sweep(["vgg"], [(8, 8)], device="cpu")
    assert compare_scaling(a, b, RTOL, 96, "cpu") == []


def test_event_plane_packet_sim_on_card_matches_cpu(card):
    """`PacketSim` on the card against its CPU route (rtol 1e-9 and the
    tie rule of `launch/event_plane`): every link model and policy on
    zfnet, and the striped and xy models under faults that kill cut 0,
    where the wired-only run is infinite on both routes."""
    from repro_torch.core import NetworkConfig, make_trace
    from repro_torch.fault import FaultScenario, default_scenario
    from repro_torch.launch.event_plane import (compare_results, cut_killer,
                                                mask_check)
    from repro_torch.sim import PacketSim

    net = NetworkConfig(bandwidth=96e9 / 8)
    tr = make_trace("zfnet", device=card)
    cpu = tr.to("cpu")
    base = default_scenario(tr, k=1, fade_db=3.0)
    faults = FaultScenario(chip_failures=base.chip_failures,
                           snr_fades=base.snr_fades,
                           link_failures=cut_killer(tr).link_failures)
    cases = [(m, None) for m in ("striped", "adaptive", "xy")] + \
        [(m, faults) for m in ("striped", "xy")]
    for model, sc in cases:
        sim = PacketSim(tr, net, link_model=model, faults=sc)
        sim_cpu = PacketSim(cpu, net, link_model=model, faults=sc)
        assert sim.eligible.is_cuda and not sim_cpu.eligible.is_cuda
        what = f"{model} {'faulted' if sc else 'fault-free'}"
        wired = sim.run_wired()
        assert wired.layer_times.is_cuda
        assert compare_results(wired, sim_cpu.run_wired(), what) == []
        assert (wired.total_time == float("inf")) == (sc is not None)
        for p in ("static", "greedy", "adaptive", "oracle",
                  "online-reshard"):
            a, b = sim.run(p), sim_cpu.run(p)
            assert compare_results(a, b, f"{what} {p}") == []
            assert mask_check(a, b, sim_cpu, f"{what} {p}") == []


def test_event_plane_reshard_on_card_matches_cpu(card):
    """`reshard_run` on zfnet at k = 1 and 2 under a 9 dB fade, card
    against CPU (rtol 1e-9): the degraded projection, the rebuild on the
    derated accelerator, the migration, the eras and the events agree,
    and the rebuild runs."""
    from repro_torch.launch.event_plane import reshard_checks

    bad, out = reshard_checks(("zfnet",), (1, 2), 9.0, card)
    assert bad == []
    assert len(out) == 2


def test_obs_plane_recorded_run_and_codesign_on_card_match_cpu(card):
    """A recorded greedy and static `PacketSim` run of smollm_360m:prefill
    (2 channels x 4 reuse zones) and zfnet's `codesign` on the card
    against the CPU route (`launch/obs_plane`): the same events within
    rtol 1e-9, the busy invariant at 1e-12, the attribution rows, the
    exports read back, the critical path summing to the makespan; the
    co-design's states equal or tied, its makespans within rtol 1e-9."""
    from repro_torch.core import make_trace
    from repro_torch.launch.obs_plane import codesign_checks, recorded_checks

    tr = make_trace("smollm_360m:prefill", device=card)
    bad, out = recorded_checks(tr, tr.to("cpu"))
    assert bad == []
    assert out["greedy"]["events"] > 0 and out["static"]["events"] > 0
    bad, cells, _ = codesign_checks(card, (("zfnet", "big_little"),))
    assert bad == []
    assert cells["zfnet/big_little"]["evaluations"] > 0


def test_observatory_profile_half_on_card_matches_cpu(card, tmp_path):
    """`launch/observatory.run` on zfnet on the card against the CPU
    route (`chip_smoke.py` phase 14): the same profile phases and call
    counts, coverage at least 0.90 on each, `sweep_all` and the recorded
    greedy run within rtol 1e-9 (tie rule), each Chrome export with its
    "framework" process, and the same ledger findings and HTML."""
    from repro_torch.launch.observatory import compare, run

    on_card = run(card, ("zfnet",), str(tmp_path / "card"))
    on_cpu = run("cpu", ("zfnet",), str(tmp_path / "cpu"))
    assert on_card["sweeps"][0].grid.is_cuda
    assert compare(on_card, on_cpu) == []
    assert (tmp_path / "card" / "observatory.html").read_bytes() == \
        (tmp_path / "cpu" / "observatory.html").read_bytes()
