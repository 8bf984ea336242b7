"""The port's dry run (`repro_torch.launch.dryrun`), its unit programs and
its reports (`launch/lm_scale.py`).

- `run_cell` on a reduced arch, one cell per mode: the reference's JSON
  keys and `status: ok` (train and prefill on the pod mesh (16, 16),
  decode on the 4-rank host mesh, whose data axis holds one rank); on the
  pod mesh the decode cells run too, their slots sharded over 'data',
  and so does the single-slot long-context decode.
- Rank 0's `argument_size_in_bytes` of a train step on a (2, 4) mesh
  equals the reference's `compiled.memory_analysis()` on 8 host devices
  (run in a subprocess), exactly, for a dense, an MoE and an SSM arch;
  the output size too, less XLA's table of output pointers (8 bytes a
  leaf of the output tuple).
- The per-rank FLOPs on that mesh are an eighth of the meshless count:
  the data axis halves the rows and 'model' divides every product
  (tensor-parallel compute).
- A unit program's FLOPs are what one more unit adds to the program:
  the count at 4 units minus the count at 2 is twice the unit's, for the
  dense, MoE, SSM, hybrid and enc-dec families.
- `lm_scale` reads the cells the smoke wrote.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, lm_scale
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_auto_mesh, use_mesh
from repro_torch.launch.unit_programs import train_unit_programs
from repro_torch.runtime.train import TrainConfig, make_train_step
from repro_torch.tree import leaves

REPO = os.path.join(os.path.dirname(__file__), "..")
KEYS = {"arch", "shape", "mesh", "chips", "mode", "moe_parallel", "status",
        "seconds", "roofline", "memory", "counts"}
ROOFLINE_KEYS = {"flops", "hbm_bytes", "coll_link_bytes", "t_compute",
                 "t_memory", "t_collective", "dominant", "coll_per_op",
                 "units", "extrapolated", "model_flops_global",
                 "model_flops_per_chip", "useful_ratio"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "peak_bytes"}
#: small train cell of the memory parity (the reference compiles it)
SMALL = ShapeConfig("small", 64, 4, "train")
MEMORY_ARCHS = ("chatglm3-6b", "mixtral-8x22b", "mamba2-130m")

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_auto_mesh, use_mesh
from repro.optim.optimizers import OptimizerConfig
from repro.runtime.sharding import logical_batch_shardings, state_shardings
from repro.runtime.train import TrainConfig, make_train_step
B, S = int(sys.argv[1]), int(sys.argv[2])
mesh = make_auto_mesh((2, 4), ("data", "model"))
out = {}
for arch in sys.argv[3:]:
    cfg = reduced(ARCHS[arch])
    step, init = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig()))
    st = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    sh = state_shardings(mesh, st, "adamw")
    with use_mesh(mesh):
        c = jax.jit(step, in_shardings=(sh, logical_batch_shardings(mesh, batch)),
                    out_shardings=(sh, NamedSharding(mesh, P()))
                    ).lower(st, batch).compile()
    ma = c.memory_analysis()
    out[arch] = [ma.argument_size_in_bytes, ma.output_size_in_bytes]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells_dir(tmp_path_factory):
    """The smoke's cells: (mode, mesh kind, shape) on reduced smollm."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    cfg = reduced(ARCHS["smollm-360m"])
    results = {(shape, mesh): dryrun.run_cell(
        "smollm-360m", shape, mesh, out_dir=out, cfg=cfg)
        for shape, mesh in (("train_4k", "pod"), ("prefill_32k", "pod"),
                            ("decode_32k", "host"), ("decode_32k", "pod"))}
    return out, results


@pytest.mark.parametrize("shape, mesh", [("train_4k", "pod"),
                                         ("prefill_32k", "pod"),
                                         ("decode_32k", "host")])
def test_run_cell_writes_the_references_keys(cells_dir, shape, mesh):
    out, results = cells_dir
    r = results[(shape, mesh)]
    assert r["status"] == "ok", r.get("traceback")
    with open(os.path.join(out, f"smollm-360m__{shape}__{mesh}.json")) as f:
        assert json.load(f) == r
    assert set(r) == KEYS
    assert set(r["roofline"]) == ROOFLINE_KEYS
    assert set(r["memory"]) == MEMORY_KEYS
    rl = r["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rl["extrapolated"] is False
    assert [u["name"] for u in rl["units"]] == ["unit"]
    assert rl["units"][0]["k"] == 2
    assert r["chips"] == {"pod": 256, "host": 4}[mesh]
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_size_in_bytes"]
    if mesh == "pod":       # the weights are gathered over 'model'
        assert rl["coll_per_op"]["all-gather"] > 0
    assert not dist.is_initialized()


def test_decode_on_the_pod_mesh_stops_at_the_serving_gap(cells_dir):
    """The serving gap is closed: the pod mesh's decode cell runs, each
    rank on its 8 of the 128 slots, tensor-parallel over 'model', the
    cache's ring split over 'model' (2 kv heads do not divide 16)."""
    r = cells_dir[1][("decode_32k", "pod")]
    assert r["status"] == "ok", r.get("traceback")
    rl = r["roofline"]
    assert rl["coll_per_op"]["all-reduce"] > 0       # row-parallel sums
    assert rl["coll_per_op"]["all-gather"] > 0       # the ring's partials
    host = cells_dir[1][("decode_32k", "host")]["roofline"]
    # 16 data ranks and 16 model ranks against one and four
    assert rl["flops"] * 4 * 16 <= host["flops"] * 1.01


def test_long_context_decode_stops_at_context_parallelism(tmp_path):
    """The single long-context slot does not divide over 'data': every
    rank serves it (the serving half of context parallelism), each with
    its shard of the SSM state over 'model' gathered for the mixer."""
    cfg = reduced(ARCHS["mamba2-130m"])
    r = dryrun.run_cell("mamba2-130m", "long_500k", "pod",
                        out_dir=str(tmp_path), cfg=cfg)
    assert r["status"] == "ok", r.get("traceback")
    assert r["roofline"]["coll_per_op"]["all-gather"] > 0


def _on_mesh(fn):
    """fn(mesh) on a fake (2, 4) ("data", "model") mesh."""
    with RL.fake_group(8):
        return fn(make_auto_mesh((2, 4), ("data", "model"), device="cpu"))


def test_argument_bytes_equal_the_references_memory_analysis():
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(SMALL.global_batch),
         str(SMALL.seq_len), *MEMORY_ARCHS], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    for arch in MEMORY_ARCHS:
        cfg = reduced(ARCHS[arch])

        def cell(mesh):
            with use_mesh(mesh):
                return dryrun.count_train_cell(cfg, SMALL, mesh)[2]

        memory = _on_mesh(cell)
        _, init = make_train_step(cfg, TrainConfig(), device="cpu")
        with FakeTensorMode():
            outputs = len(leaves(init(torch.Generator()))) + 3  # + metrics
        got = [memory["argument_size_in_bytes"],
               memory["output_size_in_bytes"] + 8 * outputs]
        assert got == want[arch], arch
    assert want["chatglm3-6b"][0] == 180868


def test_per_rank_flops_are_half_the_meshless_count():
    """On (2, 4) each rank runs its half of the batch (the data axis) and
    its quarter of every layer's width (tensor-parallel compute over
    'model': column- and row-parallel products, the vocab-parallel
    unembedding, the attention on its heads): an eighth of the meshless
    count.  The reference's per-device count on the same mesh falls by
    6.12 (XLA also counts elementwise work, which 'model' divides less)."""
    cfg = reduced(ARCHS["smollm-360m"])
    tcfg = TrainConfig(remat=False)
    batch_shape = (SMALL.global_batch, SMALL.seq_len)

    def meshed(mesh):
        step, init = make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        with FakeTensorMode():
            state = init(torch.Generator().manual_seed(0))
            from repro_torch.runtime.sharding import place, state_shardings
            placed = place(state, state_shardings(mesh, state, "adamw"))
            batch = {k: torch.zeros(batch_shape, dtype=torch.int32)
                     for k in ("tokens", "labels")}
        with use_mesh(mesh):
            return RL.count(step, placed, batch)[0].flops

    step, init = make_train_step(cfg, tcfg, device="cpu")
    with FakeTensorMode():
        state = init(torch.Generator().manual_seed(0))
        batch = {k: torch.zeros(batch_shape, dtype=torch.int32)
                 for k in ("tokens", "labels")}
    whole = RL.count(step, state, batch)[0].flops
    assert _on_mesh(meshed) * 8 == whole


def _step_flops(cfg, remat):
    step, init = make_train_step(cfg, TrainConfig(remat=remat), device="cpu")
    fake = FakeTensorMode()
    with fake:
        state = init(torch.Generator().manual_seed(0))
        batch = dryrun.input_specs(cfg, SMALL)
        units = train_unit_programs(cfg, state, SMALL.global_batch,
                                    SMALL.seq_len, "auto", remat=remat)
    total = RL.count(step, state, batch)[0].flops
    return total, {name: RL.count(fn, *args)[0].flops
                   for name, fn, args, _ in units}


@pytest.mark.parametrize("arch, depth", [
    ("smollm-360m", {"n_layers": 4}), ("mixtral-8x22b", {"n_layers": 4}),
    ("mamba2-130m", {"n_layers": 4}), ("zamba2-2.7b", {"n_layers": 8,
                                                      "shared_attn_every": 2}),
    ("seamless-m4t-large-v2", {"n_layers": 4, "n_encoder_layers": 4})])
def test_two_more_units_add_twice_the_units_count(arch, depth):
    """Train steps; each family's units at 4 and at 2.  With remat, but
    the hybrid's: its checkpoint spans a super unit (2 Mamba blocks and
    the shared block), whose replay stops at another point than its
    pieces' would (the replay ends once the backward's saved tensors are
    made again)."""
    deep = reduced(ARCHS[arch], **depth)
    half = dataclasses.replace(deep, unit=(), **{
        k: v // 2 for k, v in depth.items() if k != "shared_attn_every"})
    remat = not deep.shared_attn_every
    (big, units), (small, _) = (_step_flops(deep, remat),
                                _step_flops(half, remat))
    if deep.shared_attn_every:      # a super unit: 2 Mamba + the shared
        per = 2 * units["mamba_unit"] + units["shared_unit"]
    else:
        per = sum(units.values())
    assert per > 0 and big - small == 2 * per


def test_lm_scale_reads_the_cells(cells_dir):
    out, _ = cells_dir
    summary = lm_scale.dryrun_summary(out)
    assert summary == {"total": 4, "ok": 4, "failed": []}
    table = lm_scale.roofline_table("pod", out)
    assert sorted(r["shape"] for r in table) == ["decode_32k", "prefill_32k",
                                                 "train_4k"]
    for r in table:
        assert r["step_time"] == max(r["t_compute"], r["t_memory"],
                                     r["t_collective"])
    report = lm_scale.hybrid_plane_report("pod", out)
    assert sorted(r["shape"] for r in report) == ["decode_32k", "prefill_32k",
                                                  "train_4k"]
    for r in report:
        assert r["balancer_step_speedup"] >= r["swept_step_speedup"] - 1e-9
        assert r["swept_step_speedup"] >= 1.0 - 1e-12
