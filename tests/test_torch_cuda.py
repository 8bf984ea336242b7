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
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.ssd.ops import TC_CHUNK, ssd
from repro_torch.kernels.ssd.ref import ssd_plain, ssd_ref, ssd_tc_plain

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
                                   (4, 1536), (2, 2560), (2, 5120)])
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
    with pytest.raises(NotImplementedError, match="SSD backward"):
        ssd(x.clone().requires_grad_(), dt, A, B, C)
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
