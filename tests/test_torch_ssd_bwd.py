"""The SSD backward's plain version and the split-row RMSNorm backward's,
against autograd and against the JAX package, and the autograd wiring
the card runs (`_SSD`, `_RMSNormSplit`'s plain twin) on CPU tensors.

Inputs are made with numpy from a seed, as `tests/test_torch_ssd.py`
draws them, and handed to both frameworks.  Tolerances, each a share of
the gradient's largest magnitude (float32 throughout):
- `ssd_bwd_plain` vs autograd through `ssd_plain`: 1e-5 (the same fp32
  function, its derivative written out; sums in another order, and the
  gradient through the decay's cumsum sums rows of a chunk).  Here dA's
  share is of the sum of its terms' magnitudes, not of its largest: dA
  is a sum over every row of dt_t R_t (R_t the gradient through the
  decay's cumsum, summed from t to the chunk's end), whose terms cancel,
  so its rounding scales with that sum: fp32 autograd's own dA is 3.0e-5
  of its largest away from the float64 derivative at (2, 256, 8, 32, 32),
  the written-out one's 9.5e-6.  R_t = (ddt_t - x_t.dx_t / dt_t) / A is
  read back from the reference's gradients;
- vs `jax.vjp` of the reference's `ssd_ref` (its sequential oracle) and
  of its `ssd_scan` padded as `mamba_block` pads it: 1e-4 (another
  chunking or none, fp32);
- `ssd_bwd_plain` at another chunk: 1e-4 (another chunking, as above);
- the split-row backward vs autograd over simulated ranks: 1e-5, and vs
  `jax.vjp` of the reference's whole-row `rmsnorm` cut to the rank's
  columns: 1e-5;
- one float32 AdamW step of reduced mamba2 through `_SSD` on the plain
  launches against the reference's step: `tests/test_torch_train.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.ssm import ssd_scan as jax_ssd_scan
from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import build_optimizer as jax_build_optimizer
from repro.runtime.train import TrainConfig as JTrainConfig
from repro.runtime.train import make_loss_fn as jax_make_loss_fn
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_split_bwd_ref,
                                             rmsnorm_split_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (ssd_bwd_plain, ssd_bwd_tc_plain,
                                         ssd_plain)
from repro_torch.models import ssm as torch_ssm
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.train import TrainConfig, make_train_step

from _torch_parity import (both_params, configs, flat_jax, flat_torch,
                           numpy_params, train_batch)
from test_torch_ssd import SHAPES, _inputs

CASES = [s + (False,) for s in SHAPES] + [
    (2, 130, 3, 16, 16, 64, False),    # ragged: 2 chunks and 2 rows
    (1, 100, 3, 8, 8, 64, True),       # steep decay: exp(-250) a row
]
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _case(b, L, H, P, N, steep, seed=1):
    """float32 numpy (x, dt, A, B, C, dy); steep: dt + 5 and A = -50."""
    x, dt, A, B, C = _inputs(b, L, H, P, N, seed)
    if steep:
        dt, A = dt + 5.0, np.full((H,), -50.0, np.float32)
    dy = np.random.default_rng(seed + 7).standard_normal((b, L, H, P))
    return [x, dt, A, B, C, dy.astype(np.float32)]


def _autograd(arrays, chunk):
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    y = ssd_plain(*ins, chunk)
    return torch.autograd.grad(y, ins, torch.from_numpy(arrays[5]))


def _da_scale(arrays, want):
    """sum over (batch, row) of |dt_t R_t| per head, R_t = (ddt_t -
    x_t.dx_t / dt_t) / A, from the reference's gradients."""
    x, dt, A = (np.asarray(a, np.float64) for a in arrays[:3])
    dx, ddt = (np.asarray(w, np.float64) for w in want[:2])
    terms = dt * ddt - np.einsum("blhp,blhp->blh", x, dx)
    return np.abs(terms).sum((0, 1)) / np.abs(A)


def _close(got, want, tol, what, arrays=None):
    """Each gradient within tol of its largest magnitude; dA, where
    `arrays` are given, within tol of the sum of its terms' magnitudes."""
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        scale = (_da_scale(arrays, want) if name == "dA" and arrays
                 is not None else float(np.abs(w).max()))
        err = np.abs(g.astype(np.float64) - w)
        assert (err <= tol * scale).all(), (
            f"{what} {name}: max err {err.max():.3g}, tol {tol} of "
            f"{np.max(scale):.3g}")


@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", CASES)
def test_bwd_plain_matches_autograd(b, L, H, P, N, chunk, steep):
    arrays = _case(b, L, H, P, N, steep)
    got = ssd_bwd_plain(*(torch.from_numpy(a) for a in arrays), chunk)
    _close([t.numpy() for t in got],
           [t.numpy() for t in _autograd(arrays, chunk)], 1e-5, "autograd",
           arrays)


def _jax_scan_padded(chunk):
    """The reference's scan as `mamba_block` calls it: L padded to a
    multiple of min(chunk, max(16, L)) with dt = 0, y cut back to L."""
    def f(x, dt, A, B, C):
        L = x.shape[1]
        Q = min(chunk, max(16, L))
        pad = (-L) % Q
        if pad:
            x = jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
            dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
            B = jnp.pad(B, ((0, 0), (0, pad), (0, 0)))
            C = jnp.pad(C, ((0, 0), (0, pad), (0, 0)))
        return jax_ssd_scan(x, dt, A, B, C, Q)[0][:, :L]
    return f


@pytest.mark.parametrize("oracle", ["ssd_ref", "ssd_scan"])
@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", CASES)
def test_bwd_plain_matches_jax_vjp(oracle, b, L, H, P, N, chunk, steep):
    arrays = _case(b, L, H, P, N, steep)
    fn = ((lambda *a: jax_ssd_ref(*a)[0]) if oracle == "ssd_ref"
          else _jax_scan_padded(chunk))
    want = jax.jit(lambda args, g: jax.vjp(fn, *args)[1](g))(
        [jnp.asarray(a) for a in arrays[:5]], jnp.asarray(arrays[5]))
    got = ssd_bwd_plain(*(torch.from_numpy(a) for a in arrays), chunk)
    _close([t.numpy() for t in got], want, 1e-4, oracle)


@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", CASES)
def test_bwd_plain_does_not_depend_on_its_chunk(b, L, H, P, N, chunk,
                                                steep):
    arrays = _case(b, L, H, P, N, steep)
    tensors = [torch.from_numpy(a) for a in arrays]
    want = [t.numpy() for t in ssd_bwd_plain(*tensors, chunk)]
    for other in (16, 48, L):
        _close([t.numpy() for t in ssd_bwd_plain(*tensors, other)], want,
               1e-4, f"chunk {other}")


def _bf16_rounded(arrays):
    """x, B, C and dy rounded to bf16 (the tensor-core route's exact
    operands), as float32 numpy; dt and A as they are."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            if i in (0, 3, 4, 5) else a for i, a in enumerate(arrays)]


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", CASES)
def test_bwd_tc_plain_matches_bwd_plain(b, L, H, P, N, chunk, steep, group):
    """The bf16 route's arithmetic (`ssd_bwd_tc_plain`: chunks of 128, W
    summed over head groups of 1 to 16, the kernel's range, a group of at
    least H taking every head; hi + lo splits) against the written-out
    backward at the same chunk, on bf16-rounded inputs."""
    arrays = _bf16_rounded(_case(b, L, H, P, N, steep))
    tensors = [torch.from_numpy(a) for a in arrays]
    got = ssd_bwd_tc_plain(*tensors, group)
    want = ssd_bwd_plain(*tensors, 128)
    # the split keeps 16 bits of each fp32 operand, a relative 2^-17 each,
    # over sums of up to 128 products, and the fp32 sums are regrouped:
    # 8.6e-6 seen, bound 3e-5
    _close([t.numpy() for t in got], [t.numpy() for t in want], 3e-5,
           f"group {group}", arrays)
    if steep:
        assert (got[2] == 0).all()


@pytest.mark.parametrize("oracle", ["ssd_ref", "ssd_scan"])
@pytest.mark.parametrize("b,L,H,P,N,chunk,steep", CASES)
def test_bwd_tc_plain_matches_jax_vjp(oracle, b, L, H, P, N, chunk, steep):
    """`ssd_bwd_tc_plain` (2 heads a group) against `jax.vjp` of
    the reference's oracle and scan on the same bf16-rounded values: 1e-4,
    as `ssd_bwd_plain` (another chunking; the split's 2^-17 is far below
    it), dA of its terms' magnitudes (1.0e-5 seen).  Fed bf16 tensors it
    splits by itself and returns the inputs' dtypes."""
    arrays = _bf16_rounded(_case(b, L, H, P, N, steep))
    fn = ((lambda *a: jax_ssd_ref(*a)[0]) if oracle == "ssd_ref"
          else _jax_scan_padded(chunk))
    want = jax.jit(lambda args, g: jax.vjp(fn, *args)[1](g))(
        [jnp.asarray(a) for a in arrays[:5]], jnp.asarray(arrays[5]))
    ins = [torch.from_numpy(a) for a in arrays]
    got = ssd_bwd_tc_plain(*ins, 2)
    _close([t.numpy() for t in got], [np.asarray(w) for w in want], 1e-4,
           oracle, arrays)
    ins = [t.to(torch.bfloat16) if i in (0, 3, 4, 5) else t
           for i, t in enumerate(ins)]
    as_bf16 = ssd_bwd_tc_plain(*ins, 2)
    assert [g.dtype for g in as_bf16] == [t.dtype for t in ins[:5]]
    for g, w in zip(as_bf16, got):
        assert torch.equal(g, w.to(g.dtype))


def _plain_launches(monkeypatch, chunk):
    """`_SSD`'s kernel launches replaced by the plain versions (what the
    card runs, on the CPU), counted in the dict returned."""
    calls = {}

    def fwd(x, dt, A, B, C, keep=False):
        calls["fwd"] = calls.get("fwd", 0) + 1
        return ssd_plain(x, dt, A, B, C, chunk), None

    def bwd(x, dt, A, B, C, dy, states=None):
        calls["bwd"] = calls.get("bwd", 0) + 1
        return ssd_bwd_plain(x, dt, A, B, C, dy, chunk)

    monkeypatch.setattr(ssd_ops, "_launch", fwd)
    monkeypatch.setattr(ssd_ops, "_launch_bwd", bwd)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_wires_the_backward(monkeypatch, dtype):
    """`_SSD` on CPU tensors, its launches the plain versions: autograd's
    gradients, in the inputs' order and dtypes (dt and A float32)."""
    calls = _plain_launches(monkeypatch, 32)
    arrays = _case(2, 100, 3, 16, 16, False)
    ins = [torch.from_numpy(a) for a in arrays[:5]]
    ins = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(ins)]
    ins = [t.requires_grad_() for t in ins]
    dy = torch.from_numpy(arrays[5]).to(dtype)
    got = torch.autograd.grad(ssd_ops._SSD.apply(*ins, True), ins, dy)
    want = torch.autograd.grad(ssd_plain(*ins, 32), ins, dy)
    assert calls == {"fwd": 1, "bwd": 1}
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    _close([g.float().numpy() for g in got], [w.float().numpy() for w in want],
           tol, f"_SSD {dtype}",
           arrays if dtype == torch.float32 else None)


SPLIT_CASES = [(5, 24, 3), (7, 96, 4), (2, 64, 2)]    # rows, whole, ranks


@pytest.mark.parametrize("rows,whole,ranks", SPLIT_CASES)
def test_split_bwd_ref_matches_autograd_and_jax(rows, whole, ranks):
    """Each simulated rank's `rmsnorm_split_bwd_ref`, its `sum_rows`
    adding the other ranks' sums, against autograd through every rank's
    `rmsnorm_split_ref` (one loss over all ranks' outputs) and against
    `jax.vjp` of the reference's whole-row norm cut to the rank's
    columns."""
    rng = np.random.default_rng(3)
    xw = rng.standard_normal((rows, whole)).astype(np.float32)
    sw = np.linspace(0.5, 1.5, whole, dtype=np.float32)
    gw = rng.standard_normal((rows, whole)).astype(np.float32)
    d = whole // ranks
    cols = [slice(r * d, (r + 1) * d) for r in range(ranks)]

    xs = [torch.from_numpy(xw[:, c]).requires_grad_() for c in cols]
    ss = [torch.from_numpy(sw[c]).requires_grad_() for c in cols]

    def sum_rows_of(r):
        return lambda v: v + sum((xs[k] * xs[k]).sum(-1)
                                 for k in range(ranks) if k != r)

    loss = sum((rmsnorm_split_ref(xs[r], ss[r], whole, sum_rows_of(r))
                * torch.from_numpy(gw[:, c])).sum()
               for r, c in enumerate(cols))
    auto = torch.autograd.grad(loss, xs + ss)

    jdx, jds = (np.asarray(t) for t in jax.jit(lambda x, s, g: jax.vjp(
        lambda x, s: jax_rmsnorm({"scale": s}, x), x, s)[1](g))(
            jnp.asarray(xw), jnp.asarray(sw), jnp.asarray(gw)))

    sq = torch.from_numpy((xw * xw).sum(-1))
    dots = [torch.from_numpy((gw[:, c] * sw[c] * xw[:, c]).sum(-1))
            for c in cols]
    for r, c in enumerate(cols):
        def sum_dots(v, r=r):
            return v + sum(dots[k] for k in range(ranks) if k != r)
        dx, ds = rmsnorm_split_bwd_ref(
            torch.from_numpy(xw[:, c]), torch.from_numpy(gw[:, c]),
            torch.from_numpy(sw[c]), sq, whole, sum_dots)
        for got, want, name in ((dx, auto[r], "dx"),
                                (ds, auto[ranks + r], "dscale"),
                                (dx, jdx[:, c], "dx vs jax"),
                                (ds, jds[c], "dscale vs jax")):
            want = np.asarray(want.detach() if torch.is_tensor(want)
                              else want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()),
                err_msg=f"rank {r} {name}")


# tests/test_torch_train.py's step and tolerances
B, S = 2, 40
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL, GRAD_TOL, PARAM_ATOL, STATE_ATOL = 1e-5, 1e-4, 1e-4, 1e-6
STEP_BOUND = OPT["lr"] * 1.1


def test_mamba2_train_step_through_ssd_function_matches_jax(monkeypatch):
    """Reduced mamba2's float32 AdamW step with remat, its scans through
    `_SSD` (the card's autograd wiring: the forward twice a mixer, the
    backward once) on the plain launches, against the reference's step."""
    arch = "mamba2-130m"
    jcfg, tcfg = configs(arch)
    calls = _plain_launches(monkeypatch, tcfg.ssm_chunk)
    monkeypatch.setattr(torch_ssm, "ssd", lambda x, dt, A, B, C, chunk:
                        (ssd_ops._SSD.apply(x, dt, A, B, C, True), None))
    jparams, tparams = both_params(numpy_params(jcfg), "float32")
    jb, tb = train_batch(tcfg, S, B, "float32")

    jloss_fn = jax_make_loss_fn(jcfg, JTrainConfig(attention_impl="auto",
                                                   remat=False))
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True))(jparams, jb)
    jopt = jax_build_optimizer(JOptimizerConfig(**OPT))
    jnew, jstate = jax.jit(jopt.update)(jgrads, jopt.init(jparams), jparams,
                                        jnp.zeros((), jnp.int32))

    tc = TrainConfig(optimizer=OptimizerConfig(**OPT), attention_impl="auto",
                     remat=True)
    step_fn, _ = make_train_step(tcfg, tc, "cpu")
    state = {"params": tparams,
             "opt": build_optimizer(OptimizerConfig(**OPT)).init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}
    new_state, metrics = step_fn(state, tb)

    mixers = tcfg.n_layers
    assert calls == {"fwd": 2 * mixers, "bwd": mixers}
    assert float(metrics["loss"]) == pytest.approx(float(jloss),
                                                   rel=LOSS_RTOL)
    jg = flat_jax(jgrads)
    want, got = flat_jax(jnew), flat_torch(new_state["params"])
    old = flat_jax(jparams)
    assert got.keys() == want.keys()
    for name in want:
        settled = np.abs(jg[name]) > 2 * GRAD_TOL * np.abs(jg[name]).max()
        np.testing.assert_allclose(got[name][settled], want[name][settled],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert np.abs(got[name] - old[name]).max() <= STEP_BOUND, name
    want, got = flat_jax(jstate), flat_torch(new_state["opt"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=STATE_ATOL, err_msg=name)
