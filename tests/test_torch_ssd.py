"""The SSD kernel's plain versions against the JAX package (the Pallas
kernel in interpret mode, and its sequential oracle), and the SSD
wrapper on CPU tensors.

Inputs are made with numpy from a seed, as `tests/test_kernels.py` draws
them, and handed to both frameworks; bf16 inputs are rounded from the
same float32 values on both sides.  Tolerances:
- `ssd_plain` vs the Pallas kernel: float32 1e-4 (the same chunked
  algorithm in fp32, sums in another order; outputs up to ~15);
  bfloat16 2e-2 plus one output ulp (2^-7 relative: both compute in
  fp32 and round the result once, and may land one ulp apart);
- `ssd_ref` vs the reference's `ssd_ref`: 1e-5 (the same fp32
  recurrence);
- `ssd_plain` vs `ssd_ref`: the reference's own 1e-3 / 1e-1.

`ssd_tc_plain` (the bf16 tensor-core kernel's arithmetic, at that
kernel's 128-row chunk) is held to the same Pallas kernel and oracle at
the same tolerances, and to `ssd_plain` at the card's `SSD_TOL` for bf16
(2e-2 plus 2^-7 relative, `chip_smoke.py`): the split keeps each fp32
operand to ~2^-16, so the two differ by about one output ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd.ops import TC_CHUNK, ssd
from repro_torch.kernels.ssd.ref import (split_bf16, ssd_plain,
                                         ssd_ref, ssd_tc_plain)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KERNEL_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
REF_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
SSD_TOL_BF16 = (2e-2, 2.0 ** -7)   # chip_smoke.py's SSD_TOL["bfloat16"]
SHAPES = [            # b, L, H, P, N, chunk: tests/test_kernels.py's
    (1, 64, 4, 16, 16, 16),
    (2, 256, 8, 32, 32, 128),
    (1, 100, 4, 16, 32, 32),       # L not a chunk multiple
    (1, 128, 1, 64, 128, 64),      # single head, wide state
]


def _inputs(b, L, H, P, N, seed=1):
    """float32 numpy (x, dt, A, B, C): dt post-softplus, A negative."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, L, H, P))
    dt = np.logaddexp(rng.standard_normal((b, L, H)), 0.0)
    A = -np.exp(0.3 * rng.standard_normal(H))
    B = 0.5 * rng.standard_normal((b, L, N))
    C = 0.5 * rng.standard_normal((b, L, N))
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C)]


def _torch(arrays, dtype):
    """x, B, C in `dtype`; dt and A stay float32."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def _jax(arrays, dtype):
    x, dt, A, B, C = (jnp.asarray(a) for a in arrays)
    return x.astype(dtype), dt, A, B.astype(dtype), C.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,P,N,chunk", SHAPES)
def test_plain_ssd_matches_jax_kernel(dtype, b, L, H, P, N, chunk):
    arrays = _inputs(b, L, H, P, N)
    want, none = jax_ssd(*_jax(arrays, JDT[dtype]), chunk=chunk)
    assert none is None
    got = ssd_plain(*_torch(arrays, TDT[dtype]), chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (b, L, H, P)
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,L,H,P,N,chunk", SHAPES)
def test_ssd_ref_matches_jax_ssd_ref(b, L, H, P, N, chunk):
    arrays = _inputs(b, L, H, P, N, seed=2)
    want_y, want_state = jax_ssd_ref(*_jax(arrays, jnp.float32))
    got_y, got_state = ssd_ref(*_torch(arrays, torch.float32))
    assert got_state.shape == (b, H, P, N)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,P,N,chunk", SHAPES)
def test_plain_ssd_matches_sequential_ref(dtype, b, L, H, P, N, chunk):
    arrays = _inputs(b, L, H, P, N, seed=3)
    x, dt, A, B, C = _torch(arrays, TDT[dtype])
    got = ssd_plain(x, dt, A, B, C, chunk=chunk)
    want, _ = ssd_ref(x.float(), dt, A, B.float(), C.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=REF_TOL[dtype])


@pytest.mark.parametrize("tile", [1, 7, 64, 1000])
def test_plain_ssd_does_not_depend_on_its_tile(tile):
    """The CUDA kernel runs 64-row tiles whatever `chunk` says; the result
    is the same function of the inputs, apart from rounding."""
    arrays = _inputs(2, 100, 4, 16, 32, seed=4)
    x, dt, A, B, C = _torch(arrays, torch.float32)
    want = ssd_plain(x, dt, A, B, C, chunk=32)
    got = ssd_plain(x, dt, A, B, C, chunk=tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,P,N,chunk", SHAPES)
def test_tc_plain_matches_jax_kernel(dtype, b, L, H, P, N, chunk):
    arrays = _inputs(b, L, H, P, N, seed=8)
    want, _ = jax_ssd(*_jax(arrays, JDT[dtype]), chunk=chunk)
    got = ssd_tc_plain(*_torch(arrays, TDT[dtype]), chunk=TC_CHUNK)
    assert got.dtype == TDT[dtype] and got.shape == (b, L, H, P)
    atol, rtol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,P,N,chunk", SHAPES)
def test_tc_plain_matches_sequential_ref(dtype, b, L, H, P, N, chunk):
    arrays = _inputs(b, L, H, P, N, seed=9)
    x, dt, A, B, C = _torch(arrays, TDT[dtype])
    got = ssd_tc_plain(x, dt, A, B, C, chunk=TC_CHUNK)
    want, _ = ssd_ref(x.float(), dt, A, B.float(), C.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=REF_TOL[dtype])


def test_tc_plain_matches_plain_at_the_cards_tolerance():
    """Ragged L = 1000 at mamba2's widths (P = 64, N = 128), bf16: the
    split arithmetic against the fp32 chunked function, at the tolerance
    the card holds the tensor-core kernel to."""
    x, dt, A, B, C = _torch(_inputs(1, 1000, 4, 64, 128, seed=10),
                            torch.bfloat16)
    got = ssd_tc_plain(x, dt, A, B, C, chunk=TC_CHUNK)
    want = ssd_plain(x, dt, A, B, C, chunk=256)
    atol, rtol = SSD_TOL_BF16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


def test_split_bf16_reproduces_fp32():
    """hi + lo keeps 16 significant bits: within 2^-16 of the value over
    the exponents the kernel's operands take."""
    rng = np.random.default_rng(11)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp2(rng.integers(-40, 40, 4096)))
                         .astype(np.float32))
    hi, lo = split_bf16(v)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    rel = ((hi + lo) - v).abs() / v.abs()
    assert float(rel.max()) <= 2.0 ** -16


def test_plain_ssd_steep_decay_is_finite():
    """A = -50, dt ~ 5: a 64-token chunk's decay reaches exp(-16000).
    Exponentiating the unmasked upper triangle would give exp(+16000) =
    inf, and inf * 0 = NaN in a fused product; the mask comes first."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 64, 2, 16),
                                             dtype=np.float32))
    dt = torch.from_numpy(5.0 + rng.random((1, 64, 2), dtype=np.float32))
    A = torch.tensor([-50.0, -50.0])
    B = torch.from_numpy(rng.standard_normal((1, 64, 16), dtype=np.float32))
    C = torch.from_numpy(rng.standard_normal((1, 64, 16), dtype=np.float32))
    got = ssd_plain(x, dt, A, B, C, chunk=64)
    want, _ = ssd_ref(x, dt, A, B, C)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    arrays = _inputs(1, 100, 4, 16, 32, seed=6)
    args = _torch(arrays, torch.float32)
    before = ssd.launches
    y, none = ssd(*args, chunk=32)
    assert none is None
    assert torch.equal(y, ssd_plain(*args, chunk=32))
    assert ssd.launches == before


def test_wrapper_raises_under_autograd():
    x, dt, A, B, C = _torch(_inputs(1, 16, 2, 8, 8, seed=7), torch.float32)
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        ssd(x, dt, A, B, C)
    with torch.no_grad():
        y, _ = ssd(x, dt, A, B, C)
    assert y.shape == x.shape
