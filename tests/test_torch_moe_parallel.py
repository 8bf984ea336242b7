"""The port's explicit MoE paths against the JAX package's.

- `_grouped_ffn` (capacity buckets, drops, padding rows) and
  `_expert_ffn` (grouped, an empty group) against the reference's, in
  float32 within 1e-5.
- The launcher's path on one rank: `moe_block` under the host mesh (1, 1)
  of a 1-rank gloo group and the default ParallelContext takes the
  expert-parallel path, with its drops, as the reference's does under its
  host mesh and context; float32 within 1e-5.
- The dispatcher picks the reference's path for each arch-like config,
  mesh shape and token count (stub meshes on both sides).
- On a (2, 4) ("data", "model") gloo mesh of 8 ranks, both parallel
  paths against the reference's `tests/test_moe_parallel.py` block, run
  by the reference in a subprocess with 8 host devices.  At capacity 8.0
  nothing drops and both also match the dropless path; at 1.25 rows drop
  and each matches the reference's own output.  Forward within 1e-5
  (TP-ff 1e-4, the reference's bound: its partial sums add in another
  order), gradients of sum(y * c) for the router, the expert stacks and
  x within 1e-5 of the largest (float32 sums of a few dozen terms); the
  dropless path with the mesh alone (rows gathered over 'data') too.
- Both parallel paths on inputs split on the sequence over 'data'
  (context parallelism; `_torch_dist_worker.CP_SHAPES`: one row of 64
  tokens, whose halves are the reference's blocks of tokens, and three
  rows of 32, whose blocks straddle the ranks' halves) at capacity 1.25,
  rows dropping, against the reference's paths on the whole input,
  under the bounds above; and on batches the data axes replicate
  (`_torch_dist_worker.REP_CASES`: rows and sequence each indivisible by
  'data', so every rank holds the whole batch and computes the
  reference's block of its tokens), TP-ff on (4, 2) at (2, 6) and both
  paths on (8, 1) at (2, 12), the same way.
- `spec_to_placements` on a (2, 2, 2) ("pod", "data", "model") mesh:
  every rank holds the block that the device at its mesh coordinates
  holds under the reference's NamedSharding (composite entries
  major-to-minor).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.mesh import use_mesh as jax_use_mesh
from repro.runtime.parallel import ParallelContext as JContext
from repro.runtime.parallel import parallel_context as jax_context
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.models import moe
from repro_torch.runtime.parallel import ParallelContext, parallel_context
from repro_torch.runtime.sharding import P, spec_to_placements

from _torch_dist import finish, local_group, moe_results, start_ranks
from _torch_dist_worker import (CP_SHAPES, PLACE_SPECS, REP_CASES,
                                moe_inputs)

REPO = os.path.join(os.path.dirname(__file__), "..")
FWD_ATOL = 1e-5
TP_ATOL = 1e-4
GRAD_RTOL = 1e-5
TIMEOUT_S = 240

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.models.moe import (moe_block_gspmd, moe_block_expert_parallel,
                              moe_block_tp_ff)
from repro.runtime.parallel import ParallelContext
from repro.launch.mesh import make_auto_mesh, use_mesh

out_path, in_path, specs = sys.argv[1], sys.argv[2], eval(sys.argv[3])
cp_shapes, rep_cases = eval(sys.argv[4]), eval(sys.argv[5])
d = np.load(in_path)
cfg = dataclasses.replace(reduced(ARCHS["kimi-k2-1t-a32b"]), n_experts=8,
                          experts_per_token=2, moe_d_ff=32, d_model=64,
                          unit=())
params = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
x, c = jnp.asarray(d["x"]), jnp.asarray(d["c"])
res = {}

def run(name, f, x=x, c=c, **jit):
    def loss(p, x):
        y, aux = f(p, x)
        return (y * c).sum(), (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), **jit)(params, x)
    res[name + "/y"], res[name + "/aux"] = y, aux
    for k, v in gp.items():
        res[name + "/grad/" + k] = v
    res[name + "/grad/x"] = gx

mesh = make_auto_mesh((2, 4), ("data", "model"))
with use_mesh(mesh):
    run("gspmd", lambda p, x: moe_block_gspmd(p, x, cfg))
    for cf in (8.0, 1.25):
        ctx = ParallelContext(capacity_factor=cf)
        run(f"ep_{cf}", lambda p, x: moe_block_expert_parallel(p, x, cfg, ctx))
        run(f"tp_{cf}", lambda p, x: moe_block_tp_ff(p, x, cfg, ctx))
    ctx = ParallelContext(capacity_factor=1.25)
    for key, (B, S) in cp_shapes.items():
        xs, cs = (jnp.asarray(d[f"{n}_{B}x{S}"]) for n in ("x", "c"))
        run(f"ep_{key}", lambda p, x: moe_block_expert_parallel(p, x, cfg,
                                                                ctx), xs, cs)
        run(f"tp_{key}", lambda p, x: moe_block_tp_ff(p, x, cfg, ctx), xs,
            cs)
        run(f"gspmd_{key}", lambda p, x: moe_block_gspmd(p, x, cfg), xs, cs)
paths = {"ep": moe_block_expert_parallel, "tp": moe_block_tp_ff}
for key, (shape, (B, S), names) in rep_cases.items():
    xs, cs = (jnp.asarray(d[f"{n}_{B}x{S}"]) for n in ("x", "c"))
    rmesh = make_auto_mesh(shape, ("data", "model"))
    with use_mesh(rmesh):
        # replicated results: x's gradient, whose rows are split over
        # 'data' (4) in blocks of 3 tokens, has no named sharding
        for name in names:
            run(f"{name}_{key}", lambda p, x: paths[name](p, x, cfg, ctx),
                xs, cs, out_shardings=NamedSharding(rmesh, P()))
    with use_mesh(mesh):    # the dropless block shards the rows on 'data'
        run(f"gspmd_{key}", lambda p, x: moe_block_gspmd(p, x, cfg), xs, cs)
cube = make_auto_mesh((2, 2, 2), ("pod", "data", "model"))
for i, spec in enumerate(specs):
    for dev, idx in NamedSharding(cube, P(*spec)).devices_indices_map(
            (16, 8)).items():
        coord = tuple(int(v) for v in np.argwhere(cube.devices == dev)[0])
        res[f"place/{i}/{coord}"] = np.array(
            [[s.start or 0, n if s.stop is None else s.stop]
             for s, n in zip(idx, (16, 8))])
np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
print("MOE_REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_parallel")
    np.savez(work / "moe_in.npz", **moe_inputs())
    started = start_ranks("moe", 8, work)
    try:
        ref = subprocess.run(
            [sys.executable, "-c", SCRIPT, str(work / "ref.npz"),
             str(work / "moe_in.npz"), repr(PLACE_SPECS),
             repr(CP_SHAPES), repr(REP_CASES)],
            env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
            text=True, timeout=TIMEOUT_S, cwd=REPO)
    finally:
        got = finish(started, TIMEOUT_S)
    assert "MOE_REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    return got, dict(np.load(work / "ref.npz"))


def _check(got, ref, name, ref_name, atol, dim=0):
    y, aux, grads = moe_results(got, name, dim)
    np.testing.assert_allclose(y, ref[ref_name + "/y"], rtol=0, atol=atol)
    np.testing.assert_allclose(aux, ref[ref_name + "/aux"], rtol=1e-6)
    for k, g in grads.items():
        want = ref[ref_name + "/grad/" + k]
        np.testing.assert_allclose(
            g, want, rtol=0, atol=GRAD_RTOL * float(np.abs(want).max()),
            err_msg=k)
    return y


@pytest.mark.parametrize("path", ["ep", "tp"])
def test_parallel_paths_without_drops_match_reference_and_dropless(
        mesh_runs, path):
    got, ref = mesh_runs
    atol = FWD_ATOL if path == "ep" else TP_ATOL
    y = _check(got, ref, f"{path}_8.0", f"{path}_8.0", atol)
    np.testing.assert_allclose(y, ref["gspmd/y"], rtol=0, atol=atol)


@pytest.mark.parametrize("path", ["ep", "tp"])
def test_parallel_paths_with_drops_match_reference(mesh_runs, path):
    got, ref = mesh_runs
    y = _check(got, ref, f"{path}_1.25", f"{path}_1.25",
               FWD_ATOL if path == "ep" else TP_ATOL)
    # capacity 1.25 drops rows: the output leaves the dropless one
    assert np.abs(y - ref["gspmd/y"]).max() > 1e-2


@pytest.mark.parametrize("shape", list(CP_SHAPES))
@pytest.mark.parametrize("path", ["ep", "tp"])
def test_parallel_paths_on_a_sequence_split_match_reference(mesh_runs, path,
                                                            shape):
    got, ref = mesh_runs
    name = f"{path}_{shape}"
    y = _check(got, ref, name, name, FWD_ATOL if path == "ep" else TP_ATOL,
               dim=1)
    # capacity 1.25 drops rows: the output leaves the dropless one
    assert y.shape[:2] == CP_SHAPES[shape]
    assert np.abs(y - ref[f"gspmd_{shape}/y"]).max() > 1e-2


@pytest.mark.parametrize("key, path", [
    (key, path) for key, (_, _, paths) in REP_CASES.items()
    for path in paths])
def test_parallel_paths_on_a_replicated_batch_match_reference(mesh_runs, key,
                                                              path):
    """Every rank holds the whole batch: its y is the whole output, the
    gradients sum over all the ranks."""
    got, ref = mesh_runs
    name = f"{path}_{key}"
    for r in got:
        assert torch.equal(r[name]["y"], got[0][name]["y"])
    y = got[0][name]["y"].numpy()
    np.testing.assert_allclose(y, ref[name + "/y"], rtol=0,
                               atol=FWD_ATOL if path == "ep" else TP_ATOL)
    np.testing.assert_allclose(float(got[0][name]["aux"]),
                               ref[name + "/aux"], rtol=1e-6)
    for k in ("router", "w_gate", "w_up", "w_down", "x"):
        want = ref[f"{name}/grad/{k}"]
        np.testing.assert_allclose(
            sum(r[name]["grads"][k] for r in got).numpy(), want, rtol=0,
            atol=GRAD_RTOL * float(np.abs(want).max()), err_msg=k)
    # capacity 1.25 drops rows: the output leaves the dropless one
    assert y.shape[:2] == REP_CASES[key][1]
    assert np.abs(y - ref[f"gspmd_{key}/y"]).max() > 1e-2


def test_dropless_path_on_the_mesh_gathers_the_data_shards(mesh_runs):
    got, ref = mesh_runs
    _check(got, ref, "gspmd", "gspmd", FWD_ATOL)


def test_spec_to_placements_shards_as_jax_does(mesh_runs):
    got, ref = mesh_runs
    full = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    coords = set()
    for r in got:
        coords.add(r["coords"])
        for i, shard in enumerate(r["shards"]):
            (r0, r1), (c0, c1) = ref[f"place/{i}/{r['coords']}"]
            assert torch.equal(shard, full[r0:r1, c0:c1]), (
                PLACE_SPECS[i], r["coords"])
    assert len(coords) == 8


class _Stub:
    def __init__(self, **shape):
        self.shape = shape


def test_spec_to_placements_refuses_minor_to_major_entries():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Stub(pod=2, data=2, model=2)
    assert spec_to_placements(mesh, P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert spec_to_placements(mesh, P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        spec_to_placements(mesh, P(("data", "pod")))
    with pytest.raises(ValueError, match="twice"):
        spec_to_placements(mesh, P("model", "model"))


def test_grouped_ffn_matches_reference_with_drops():
    rng = np.random.default_rng(1)
    N, d, ff, E, cap = 40, 16, 8, 4, 6
    rows = rng.standard_normal((N, d)).astype(np.float32)
    ids = rng.integers(0, E + 1, N)        # E marks padding rows
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    want = np.asarray(jmoe._grouped_ffn(
        jnp.asarray(rows), jnp.asarray(ids, jnp.int32), E, cap,
        *map(jnp.asarray, ws)))
    got = moe._grouped_ffn(torch.from_numpy(rows), torch.from_numpy(ids),
                           E, cap, *map(torch.from_numpy, ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    counts = np.bincount(ids[ids < E], minlength=E)
    assert counts.max() > cap                       # some rows drop
    dropped = (np.abs(want).max(-1) == 0)
    assert dropped.sum() == (ids == E).sum() + np.maximum(
        counts - cap, 0).sum()


def test_expert_ffn_matches_reference():
    rng = np.random.default_rng(4)
    d, ff, E = 16, 8, 4
    sizes = np.array([3, 0, 5, 2])
    xs = rng.standard_normal((sizes.sum(), d)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    want = np.asarray(jmoe._expert_ffn(
        jnp.asarray(xs), jnp.asarray(sizes, jnp.int32),
        *map(jnp.asarray, ws)))
    got = moe._expert_ffn(torch.from_numpy(xs), torch.from_numpy(sizes),
                          *map(torch.from_numpy, ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("batch,seq", [(2, 16), (4, 1)])
def test_launcher_path_on_one_rank_matches_reference(batch, seq):
    jcfg = jax_reduced(JAX_ARCHS["mixtral-8x22b"])
    tcfg = reduced(ARCHS["mixtral-8x22b"])
    p = moe_inputs(2)
    # mixtral's reduced block: 8 experts top 2 of d_ff 32, d 64
    params = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    x = np.random.default_rng(3).standard_normal(
        (batch, seq, 64)).astype(np.float32)
    with jax_use_mesh(jax_host_mesh()), jax_context(JContext()):
        want, want_aux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    dropless, _ = jmoe.moe_block_gspmd(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    calls = moe.moe_block_expert_parallel.calls
    with local_group():
        with use_mesh(make_host_mesh("cpu")), \
                parallel_context(ParallelContext()):
            got, aux = moe.moe_block(tparams, torch.from_numpy(x), tcfg)
    assert moe.moe_block_expert_parallel.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the capacity drops rows here, so the dropless path differs
    assert np.abs(np.asarray(dropless) - np.asarray(want)).max() > 1e-2


def _chosen(monkeypatch, mesh_shape, cfg, B, S, rows):
    """(the reference's path, the port's path: `moe_path`'s) for x of
    (B, S) tokens (the port's rank holding B / rows of them) on a stub
    mesh."""
    picks = []
    for name in ("moe_block_expert_parallel", "moe_block_tp_ff",
                 "moe_block_gspmd"):
        def mark(*args, _name=name):
            picks.append(_name)
            return args[1], 0.0
        monkeypatch.setattr(jmoe, name, mark)
        monkeypatch.setattr(moe, name, mark)
    monkeypatch.setattr(jmoe, "get_abstract_mesh",
                        lambda: _Stub(**mesh_shape))
    with jax_context(JContext()):
        jmoe.moe_block({}, np.zeros((B, S, 1)), cfg)
    with use_mesh(_Stub(**mesh_shape)), parallel_context(ParallelContext()):
        path = moe.moe_path(cfg, torch.zeros(B // rows, S, 1))
    picks.append({"expert": "moe_block_expert_parallel",
                  "tp_ff": "moe_block_tp_ff",
                  "dropless": "moe_block_gspmd"}[path])
    return picks


@pytest.mark.parametrize("mesh_shape", [
    dict(data=1, model=1), dict(data=2, model=4), dict(data=16, model=16),
    dict(pod=2, data=16, model=16)], ids=["1x1", "2x4", "16x16", "2x16x16"])
def test_dispatcher_picks_the_reference_path(monkeypatch, mesh_shape):
    import dataclasses
    rows = mesh_shape.get("pod", 1) * mesh_shape["data"]
    seen = set()
    for arch in ("mixtral-8x22b", "kimi-k2-1t-a32b"):
        for E, ff in ((8, 32), (8, 16384), (384, 2048), (16, 24)):
            cfg = dataclasses.replace(ARCHS[arch], n_experts=E, moe_d_ff=ff)
            for B in (rows, 2 * rows, 4 * rows):
                for S in (1, 3, 16):
                    ref, port = _chosen(monkeypatch, mesh_shape, cfg, B, S,
                                        rows)
                    assert ref == port, (arch, E, ff, B, S)
                    seen.add(ref)
    assert "moe_block_expert_parallel" in seen
