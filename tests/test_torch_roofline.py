"""The port's roofline (`repro_torch.launch.roofline`) against the JAX
package's.

- The terms' arithmetic, `dominant` and `step_time` equal the reference's
  with both modules' constants set equal (the port's are an H100's).
- The collective recorder names each kind of collective as the
  reference's HLO op and counts its result's bytes, for the functional
  ops (DTensor's redistributions), the in-place ones (the MoE paths'
  autograd collectives) and the port's own `runtime/parallel.py`
  wrappers, on a fake process group of 4 ranks.
- `aten._grouped_mm` is counted (torch counts it as 0) in all three of
  the forms autograd calls, and `moe.expert_counts` equals `bincount`
  and traces under fake tensors, as `route` and `moe_block` then do.
- FLOPs on one device equal the reference's: the sum of 2 |lhs| x (the
  rhs's free dims) over the `dot_general` and `ragged_dot_general`
  equations of its jaxpr, after dead-code elimination (XLA's view of the
  program), each `scan`'s body times its length; prefill (B=2, S=64) and
  the train step with no remat, on every arch of
  `_torch_parity.PARITY_ARCHS` and seamless, exactly.  The Mamba2 archs
  differ by exactly the formulation of the SSD scan (`_ssd_gap`: an
  outer product the reference counts as a product, an elementwise
  scaling in the port); the test counts that difference on the two scans
  alone.
- With remat on, the train step's count is the no-remat count plus one
  forward of every unit (torch's checkpoint replays it in the backward).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.extend import core as jcore
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.roofline as JRL
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.runtime.train import TrainConfig as JTrainConfig
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import roofline as RL
from repro_torch.launch.unit_programs import train_unit_programs
from repro_torch.models import build_model, moe
from repro_torch.runtime.train import TrainConfig, make_train_step

from _torch_parity import PARITY_ARCHS, configs

B, S = 2, 64
FLOP_ARCHS = PARITY_ARCHS + ("seamless-m4t-large-v2",)


# --------------------------------------------------------------------------
# the terms
# --------------------------------------------------------------------------

@pytest.fixture
def equal_constants(monkeypatch):
    for port, ref in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                      ("NVLINK_BW", "ICI_BW"),
                      ("NVLINK_LINKS", "ICI_LINKS")):
        monkeypatch.setattr(RL, port, getattr(JRL, ref))


@pytest.mark.parametrize("terms", [
    (197e12, 1.0, 1.0, {}), (1.0, 819e9 * 2, 1.0, {}),
    (1.0, 1.0, 4e12, {"all-reduce": 2e12}),
    (3e12, 5e9, 7e9, {"all-gather": 7e9, "all-to-all": 1.0})])
def test_terms_match_the_reference_under_equal_constants(terms,
                                                         equal_constants):
    port, ref = RL.Roofline(*terms), JRL.Roofline(*terms)
    assert port.as_dict() == ref.as_dict()
    assert port.step_time == ref.step_time
    assert RL.model_flops(100, 40, 8, "train") == JRL.model_flops(
        100, 40, 8, "train")
    assert RL.model_flops(100, 40, 8, "decode") == JRL.model_flops(
        100, 40, 8, "decode")


def test_constants_are_an_h100s():
    r = RL.Roofline(989e12, 3.35e12, 18 * 25e9, {})
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)
    assert set(RL._RING_FACTOR) == {"all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all",
                                    "collective-permute"}


# --------------------------------------------------------------------------
# the collective recorder
# --------------------------------------------------------------------------

def _collectives(mesh):
    """(name, fn, expected op, expected result bytes) on a fake group of
    4 ranks: x is (8, 16) float32, 512 B."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from repro_torch.runtime import parallel as par
    group = dist.group.WORLD

    def inplace_ar(x):
        dist.all_reduce(x)

    def inplace_ag(x):
        dist.all_gather_into_tensor(x.new_empty((32, 16)), x)

    def inplace_rs(x):
        dist.reduce_scatter_tensor(x.new_empty((2, 16)), x)

    def inplace_a2a(x):
        dist.all_to_all_single(torch.empty_like(x), x)

    def dtensor(src, dst):
        def run(x):
            if isinstance(src, Partial):
                t = DTensor.from_local(x, mesh.device_mesh, [src])
            else:
                t = distribute_tensor(x, mesh.device_mesh, [src],
                                      src_data_rank=None)
            t.redistribute(mesh.device_mesh, [dst]).to_local()
        return run

    return [
        ("functional all_gather", lambda x: fc.all_gather_tensor(
            x, 0, group), "all-gather", 4 * 512),
        ("functional reduce_scatter", lambda x: fc.reduce_scatter_tensor(
            x, "sum", 0, group), "reduce-scatter", 512 // 4),
        ("functional all_reduce", lambda x: fc.all_reduce(x, "sum", group),
         "all-reduce", 512),
        ("functional all_to_all", lambda x: fc.all_to_all_single(
            x, None, None, group), "all-to-all", 512),
        ("in-place all_reduce", inplace_ar, "all-reduce", 512),
        ("in-place all_gather", inplace_ag, "all-gather", 4 * 512),
        ("in-place reduce_scatter", inplace_rs, "reduce-scatter", 512 // 4),
        ("in-place all_to_all", inplace_a2a, "all-to-all", 512),
        ("parallel.psum", lambda x: par.psum(x, mesh, ("d",)),
         "all-reduce", 512),
        ("parallel.all_gather", lambda x: par.all_gather(x, mesh, ("d",)),
         "all-gather", 4 * 512),
        ("parallel.all_to_all", lambda x: par.all_to_all(
            x.reshape(4, 2, 16), mesh, "d"), "all-to-all", 512),
        ("DTensor Shard -> Replicate", dtensor(Shard(0), Replicate()),
         "all-gather", 512),
        ("DTensor Partial -> Shard", dtensor(Partial(), Shard(0)),
         "reduce-scatter", 512 // 4),
        ("DTensor Partial -> Replicate", dtensor(Partial(), Replicate()),
         "all-reduce", 512),
    ]


def test_recorder_names_and_bytes_of_each_collective():
    from repro_torch.launch.mesh import make_auto_mesh
    with RL.fake_group(4):
        mesh = make_auto_mesh((4,), ("d",), device="cpu")
        for name, fn, op, nbytes in _collectives(mesh):
            with FakeTensorMode():
                x = torch.zeros((8, 16))
            rl, ex = RL.count(fn, x)
            assert rl.coll_per_op == {op: nbytes}, name
            assert ex.coll_calls == {op: 1}, name
            assert rl.coll_link_bytes == nbytes * RL._RING_FACTOR[op], name
    assert not dist.is_initialized()


def test_fake_group_refuses_a_second_group():
    with RL.fake_group(2):
        with pytest.raises(RuntimeError, match="process group exists"):
            with RL.fake_group(2):
                pass
    assert not dist.is_initialized()


def test_bytes_are_local_and_count_needs_no_real_memory():
    """A (2^20, 2^20) float32 product (4 TiB an operand) counts without
    allocating; its unfused bytes read both operands and write the
    result; the floor is the arguments plus the output."""
    n = 1 << 20
    with FakeTensorMode():
        a = torch.empty((n, n))
    rl, ex = RL.count(lambda x: x @ x, a)
    assert rl.flops == 2 * n ** 3
    assert rl.hbm_bytes == 3 * 4 * n * n
    assert ex.argument_bytes == ex.output_bytes == 4 * n * n
    assert ex.floor_bytes == 8 * n * n
    assert ex.peak_bytes == 8 * n * n
    assert ex.flops_by_op == {"aten.mm": 2 * n ** 3}


# --------------------------------------------------------------------------
# the MoE block under fake tensors
# --------------------------------------------------------------------------

def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(0)
    for n, size in ((8, 0), (8, 5), (384, 4096), (3, 50)):
        ids = torch.from_numpy(rng.integers(0, n, size))
        got = moe.expert_counts(ids, n)
        assert got.dtype == torch.int64
        assert torch.equal(got, torch.bincount(ids, minlength=n))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_route_and_moe_block_trace_under_fake_tensors(arch):
    """And the three grouped products count 2 rows d f each: the rows are
    the T K expanded tokens, whichever experts they go to."""
    cfg = reduced(ARCHS[arch])
    T, K, d, f = B * S, cfg.experts_per_token, cfg.d_model, cfg.moe_d_ff
    with FakeTensorMode():
        params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
        x = torch.zeros((B, S, d), dtype=torch.bfloat16)
        w, idx, aux = moe.route(params, x.reshape(T, d), cfg)
    assert tuple(idx.shape) == (T, K) and aux.shape == ()
    rl, ex = RL.count(lambda p, x: moe.moe_block(p, x, cfg), params, x)
    assert ex.flops_by_op["aten._grouped_mm"] == 3 * 2 * T * K * d * f
    assert ex.flops_by_op["aten.mm"] == 2 * T * d * cfg.n_experts


def test_grouped_mm_formula_reads_each_form():
    G, M, K, N = 4, 32, 16, 8
    with FakeTensorMode():
        a2 = torch.zeros((M, K), dtype=torch.bfloat16)
        b3 = torch.zeros((G, K, N), dtype=torch.bfloat16)
        aT = torch.zeros((K, M), dtype=torch.bfloat16)
        g2 = torch.zeros((M, N), dtype=torch.bfloat16)
        a3 = torch.zeros((G, M, K), dtype=torch.bfloat16)
        offs = torch.full((G,), M // G, dtype=torch.int32).cumsum(
            0, dtype=torch.int32)
    forms = {
        "2-D x 3-D (the forward)": ((a2, b3, offs), 2 * M * K * N),
        "2-D x 2-D (the weight gradient)": ((aT, g2, offs), 2 * K * M * N),
        "3-D x 3-D (batched)": ((a3, b3, None), 2 * G * M * K * N),
    }
    for name, (args, want) in forms.items():
        rl, _ = RL.count(lambda a, b, o: torch._grouped_mm(a, b, offs=o),
                         *args)
        assert rl.flops == want, name


# --------------------------------------------------------------------------
# FLOPs against the reference's jaxpr
# --------------------------------------------------------------------------

def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _eqn_flops(e) -> int:
    name = e.primitive.name
    lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
    if name == "dot_general":
        (_, rc), (_, rb) = e.params["dimension_numbers"]
        skip = set(rc) | set(rb)
    else:       # ragged_dot_general: the rhs's group dims are not free
        rd = e.params["ragged_dot_dimension_numbers"]
        (_, rc), (_, rb) = rd.dot_dimension_numbers
        skip = set(rc) | set(rb) | set(rd.rhs_group_dimensions)
    return 2 * math.prod(lhs) * math.prod(
        d for i, d in enumerate(rhs) if i not in skip)


def _jaxpr_flops(jaxpr, mult: int = 1) -> int:
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name in ("dot_general", "ragged_dot_general"):
            total += mult * _eqn_flops(e)
            continue
        k = e.params["length"] if e.primitive.name == "scan" else 1
        assert e.primitive.name != "while", "a loop of unknown trip count"
        for sub in _sub_jaxprs(e.params):
            total += _jaxpr_flops(sub, mult * k)
    return total


def jax_flops(fn, *args) -> int:
    """FLOPs of fn's jaxpr after dead-code elimination."""
    from jax._src.interpreters import partial_eval as pe
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    jaxpr, _ = pe.dce_jaxpr(jaxpr, [True] * len(jaxpr.outvars))
    return _jaxpr_flops(jaxpr)


def _batches(jcfg, train, fake):
    """Abstract JAX inputs and port inputs of one batch, fake under
    `fake` (the port's params must come from the same mode)."""
    i32 = (jnp.int32, torch.int32)
    bf = (jnp.bfloat16, torch.bfloat16)
    shapes = {}
    if jcfg.is_encdec:
        shapes["src_embeds"] = ((B, S, jcfg.d_model), bf)
    key = "embeds" if jcfg.frontend == "embed" else "tokens"
    shapes[key] = ((B, S, jcfg.d_model), bf) if key == "embeds" else \
        ((B, S), i32)
    if train:
        shapes["labels"] = ((B, S), i32)
    jb = {k: jax.ShapeDtypeStruct(s, d[0]) for k, (s, d) in shapes.items()}
    with fake:
        tb = {k: torch.zeros(s, dtype=d[1]) for k, (s, d) in shapes.items()}
    return jb, tb


def _ssd_gap(tcfg, grad: bool) -> int:
    """Reference minus port FLOPs of the SSD scan of every Mamba layer.
    On the CPU the reference's "auto" runs `models/ssm.py: ssd_scan`, the
    port's the kernel's plain version, `kernels/ssd/ref.py: ssd_plain`:
    the same sums, formulated apart.  ssd_scan's two three-operand
    einsums contract B (or C) with the (decay x dt) factor first, an
    outer product that is a `dot_general`; ssd_plain scales by those
    factors elementwise, which FlopCounterMode does not count as products,
    and so do their gradients.  The gap is counted here on the two scans
    alone, at the layer's shapes."""
    from repro.models.ssm import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_plain
    if not tcfg.ssm_state:
        return 0
    H, P, N = tcfg.n_ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state
    shapes = [((B, S, H, P), "bf16"), ((B, S, H), "f32"), ((H,), "f32"),
              ((B, S, N), "bf16"), ((B, S, N), "bf16")]
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}

    def jfn(*a):
        return ssd_scan(*a, tcfg.ssm_chunk)[0].astype(jnp.float32).sum()

    jargs = [jax.ShapeDtypeStruct(s, jdt[d]) for s, d in shapes]
    ref = jax_flops(jax.grad(jfn, argnums=(0, 1, 2, 3, 4)) if grad else jfn,
                    *jargs)

    def tfn(*a):
        with torch.enable_grad():
            a = [t.requires_grad_(grad) for t in a]
            y = ssd_plain(*a, chunk=tcfg.ssm_chunk).float().sum()
            return torch.autograd.grad(y, a) if grad else y

    with FakeTensorMode():
        targs = [torch.zeros(s, dtype=tdt[d]) for s, d in shapes]
    return (ref - RL.count(tfn, *targs)[0].flops) * tcfg.n_layers


def _port_prefill(tcfg, tb, fake):
    model = build_model(tcfg, remat=False, device="cpu")
    with fake:
        params = model.init(torch.Generator().manual_seed(0))
    return RL.count(torch.no_grad()(lambda p, b: model.apply(p, b)[0]),
                    params, tb)[0].flops


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_prefill_flops_equal_the_reference(arch):
    jcfg, tcfg = configs(arch) if arch in PARITY_ARCHS else (
        jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch]))
    fake = FakeTensorMode()
    jb, tb = _batches(jcfg, False, fake)
    jm = jax_build_model(jcfg, remat=False)
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    want = jax_flops(lambda p, b: jm.apply(p, b)[0], jp, jb)
    got = _port_prefill(tcfg, tb, fake)
    assert got + _ssd_gap(tcfg, grad=False) == want


def _port_step_flops(tcfg, tb, remat, fake):
    step, init = make_train_step(tcfg, TrainConfig(remat=remat),
                                 device="cpu")
    with fake:
        state = init(torch.Generator().manual_seed(0))
    return RL.count(step, state, tb)[0].flops, state


#: reference minus port, over the reference's, of the SSD scans' own
#: products in a train step (see `test_train_step_flops_equal_the_reference`;
#: 1179648 of 10223616 on reduced mamba2-130m and 7077888 of 61341696 on
#: reduced zamba2-2.7b, 0.1154 both)
SSD_TRAIN_RTOL = 0.12


def _no_ssd_products(monkeypatch):
    """Swap both packages' SSD scans for a function of the same inputs
    that takes no products, so that the rest of the step is counted
    alone (every input still gets its gradient)."""
    import repro.models.ssm as jssm
    import repro_torch.models.ssm as tssm

    def jax_scan(x, dt, A, B, C, chunk, init_state=None):
        z = dt.sum() + A.sum() + B.sum() + C.sum()
        return x + (z * 0).astype(x.dtype), None

    def port_scan(x, dt, A, B, C, chunk=128):
        z = dt.sum() + A.sum() + B.float().sum() + C.float().sum()
        return x + (z * 0).to(x.dtype), None

    monkeypatch.setattr(jssm, "ssd_scan", jax_scan)
    monkeypatch.setattr(tssm, "ssd", port_scan)


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_train_step_flops_equal_the_reference(arch, monkeypatch):
    """The whole step, optimizer included (it takes no products).

    Mamba2 archs: every product outside the SSD scans is equal exactly
    (both scans swapped for product-free ones); the scans' own products
    differ, as they are formulated apart (the port's plain route,
    `ssd_plain`, loops over chunks and scales by the decays elementwise;
    the reference's `ssd_scan` batches the chunks, counts an outer
    product as a product, and runs its chunk recurrence as a `lax.scan`,
    whose differentiation inside the unit scan re-runs part of its
    forward).  The port's scans take fewer products, by at most
    SSD_TRAIN_RTOL of the reference's."""
    jcfg, tcfg = configs(arch) if arch in PARITY_ARCHS else (
        jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch]))

    def both():
        fake = FakeTensorMode()
        jb, tb = _batches(jcfg, True, fake)
        step, init = jax_make_train_step(jcfg, JTrainConfig(remat=False))
        state = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))
        return (jax_flops(step, state, jb),
                _port_step_flops(tcfg, tb, False, fake)[0])

    want, got = both()
    if not tcfg.ssm_state:
        assert got == want
        return
    with monkeypatch.context() as m:
        _no_ssd_products(m)
        want_rest, got_rest = both()
    assert got_rest == want_rest
    ref_ssd, port_ssd = want - want_rest, got - got_rest
    assert 0 <= ref_ssd - port_ssd <= SSD_TRAIN_RTOL * ref_ssd


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b",
                                  "mamba2-130m", "seamless-m4t-large-v2"])
def test_remat_adds_one_forward_of_every_unit(arch):
    """torch's checkpoint replays each unit's forward in the backward; the
    reference's jaxpr holds the rematerialised forward once, so parity is
    held with remat off and this pins what remat adds: one forward of
    every unit when the replay runs whole, less by default, where the
    replay stops once it has made every tensor the backward saved (a
    unit's last products are not replayed)."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    tcfg = reduced(ARCHS[arch])
    fake = FakeTensorMode()
    _, tb = _batches(tcfg, True, fake)
    plain, state = _port_step_flops(tcfg, tb, False, fake)
    remat, _ = _port_step_flops(tcfg, tb, True, fake)
    with set_checkpoint_early_stop(False):
        whole, _ = _port_step_flops(tcfg, tb, True, fake)
    with fake:
        units = train_unit_programs(tcfg, state, B, S, "auto", grad=False)
    forward = sum(k * RL.count(fn, *args)[0].flops
                  for _, fn, args, k in units)
    assert forward > 0 and whole == plain + forward
    assert plain < remat < whole
