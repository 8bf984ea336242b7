"""Multi-pod dry run: count every (arch x shape x mesh) cell of the port.

The JAX package's `launch/dryrun.py` lowers and compiles each cell on
512 placeholder host devices.  Here each cell runs once on rank 0 of a
fake process group of the mesh's size (256 or 512 ranks, one process;
its collectives return at once), under `FakeTensorMode`, so nothing is
allocated at any width.  For each cell this:

  1. draws the state from a torch.Generator under fake tensors,
  2. places it by the sharding rules (`state_shardings`,
     `params_shardings`) on the production mesh, (16, 16) or
     (2, 16, 16), as DTensors,
  3. runs the port's step once through `launch/roofline.py: count`:
     the sharded train step (`make_train_step(..., mesh=)`), the
     sharded prefill or one sharded serving decode step
     (`make_serve_fns(..., mesh=)`: the weights gathered over the data
     axes one unit at a time, each rank computing tensor-parallel on its
     'model' shards,
     the decode cache placed by `cache_shardings` and this rank's rows
     of the slots),
  4. records the FLOPs, bytes, collectives by op and memory of rank 0,
     and each single-unit program's terms (`launch/unit_programs.py`;
     nothing is extrapolated, see there),
and writes one JSON per cell under build/repro_torch/dryrun/.

As in the reference, the cell runs inside `use_mesh` and
`parallel_context(ParallelContext())`.  A cell that raises is recorded
with `status: error`, the error and the end of its traceback.  Every
cell's batch divides over the data axes.  The step's count of one that
did not would take the rank's part of the sequence, or the whole batch
(`sharding.leaf_shard`), as the train step runs it; its unit programs
would not: they are built at the rank's rows of the whole sequence,
with no k and v gathers, which is a row split's unit.

`memory` holds rank 0's `argument_size_in_bytes` (its shards of the
state and its rows of the inputs), `output_size_in_bytes` (its shards
of what the step returns) and `peak_bytes` (MemTracker's peak of live
tensors).  XLA's `temp_size_in_bytes` and
`generated_code_size_in_bytes` have no counterpart and are left out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, cells, get_arch
from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model
from ..optim.optimizers import OptimizerConfig
from ..runtime.parallel import ParallelContext, parallel_context
from ..runtime.serve import (ServeConfig, cache_views, make_serve_fns,
                             slot_rows)
from ..runtime.sharding import (leaf_shard, params_shardings, place,
                                state_shardings)
from ..runtime.train import TrainConfig, make_train_step
from . import roofline as RL
from .mesh import make_auto_mesh, use_mesh
from .unit_programs import decode_unit_programs, train_unit_programs

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "repro_torch", "dryrun")

#: mesh kind -> (shape, axes); "host" is a small mesh whose data axis
#: holds one rank
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 4), ("data", "model"))}

log = logging.getLogger("repro_torch.launch.dryrun")


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    """Adafactor for >=100B params (kimi/mixtral would not fit AdamW state
    on the assigned meshes), AdamW otherwise."""
    big = cfg.param_count() > 100e9
    return OptimizerConfig(name="adafactor" if big else "adamw")


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Zero tensors for every model input of a train or prefill cell (fake
    under a FakeTensorMode): the global batch.  A decode cell's inputs
    (one new token a slot, the cache, the position) are made on the mesh
    by `count_decode_cell`."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    batch = {}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.zeros((B, S, cfg.d_model),
                                          dtype=torch.bfloat16)
        batch["tokens"] = torch.zeros((B, S), dtype=i32)
    elif cfg.frontend == "embed":
        batch["embeds"] = torch.zeros((B, S, cfg.d_model),
                                      dtype=torch.bfloat16)
    else:
        batch["tokens"] = torch.zeros((B, S), dtype=i32)
    if shape.mode == "train":
        batch["labels"] = torch.zeros((B, S), dtype=i32)
    return batch


def _gen():
    return torch.Generator().manual_seed(0)


def _rows_bytes(mesh, batch) -> int:
    """Bytes of this rank's shard of a global batch (as the step takes
    it)."""
    return RL.local_bytes({k: leaf_shard(mesh, v)[0]
                           for k, v in batch.items()})


def count_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     attention_impl: str = "auto"):
    """The sharded train step: (roofline, extras, memory, unit programs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tcfg = TrainConfig(optimizer=optimizer_for(cfg),
                       attention_impl=attention_impl)
    step_fn, init_fn = make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    with FakeTensorMode():
        state = init_fn(_gen())
        placed = place(state, state_shardings(mesh, state,
                                              tcfg.optimizer.name))
        batch = input_specs(cfg, shape)
        rows = _rows_bytes(mesh, batch)
        n_rows = leaf_shard(mesh, batch["labels"])[0].shape[0]
        units = train_unit_programs(
            cfg, {"params": placed["params"]}, n_rows, shape.seq_len,
            attention_impl, remat=tcfg.remat)
    rl, ex = RL.count(step_fn, placed, batch)
    memory = {"argument_size_in_bytes": RL.local_bytes(placed) + rows,
              "output_size_in_bytes": ex.output_bytes,
              "peak_bytes": ex.peak_bytes}
    return rl, ex, memory, units


def count_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       attention_impl: str = "auto"):
    """The sharded serving prefill of the global batch (last-position
    logits) on the weights placed by `params_shardings`, this rank's
    rows: (roofline, extras, memory, units)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    prefill, _, _ = make_serve_fns(
        cfg, ServeConfig(attention_impl=attention_impl), device="cpu",
        mesh=mesh)
    model = build_model(cfg, impl=attention_impl, device="cpu")
    with FakeTensorMode():
        params = model.init(_gen())
        placed = place(params, params_shardings(mesh, params))
        batch = input_specs(cfg, shape)
        rows = _rows_bytes(mesh, batch)
        n_rows = leaf_shard(mesh, next(iter(batch.values())))[0].shape[0]
        units = train_unit_programs(cfg, {"params": placed}, n_rows,
                                    shape.seq_len, attention_impl,
                                    grad=False)
    rl, ex = RL.count(prefill, placed, batch)
    memory = {"argument_size_in_bytes": RL.local_bytes(placed) + rows,
              "output_size_in_bytes": ex.output_bytes,
              "peak_bytes": ex.peak_bytes}
    return rl, ex, memory, units


def count_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      attention_impl: str = "auto"):
    """One sharded serving decode step of global_batch slots against a
    seq_len cache (`make_serve_fns(..., mesh=)`: the weights placed by
    `params_shardings`, the cache by `cache_shardings`, this rank's rows
    of the slots): (roofline, extras, memory, units)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, decode_step, init_cache = make_serve_fns(
        cfg, ServeConfig(max_len=shape.seq_len,
                         attention_impl=attention_impl), device="cpu",
        mesh=mesh)
    model = build_model(cfg, impl=attention_impl, remat=False, device="cpu")
    with FakeTensorMode():
        params = model.init(_gen())
        placed = place(params, params_shardings(mesh, params))
        cache = init_cache(shape.global_batch, shape.seq_len, 1024)
        token = slot_rows(mesh, torch.zeros((shape.global_batch, 1),
                                            dtype=torch.int32))
        with use_mesh(mesh):
            views, _ = cache_views(mesh, cache)
            units = decode_unit_programs(cfg, placed, views,
                                         token.shape[0], attention_impl)
    args = (placed, cache, token, shape.seq_len - 1)
    rl, ex = RL.count(decode_step, *args)
    memory = {"argument_size_in_bytes": RL.local_bytes(args),
              "output_size_in_bytes": ex.output_bytes,
              "peak_bytes": ex.peak_bytes}
    return rl, ex, memory, units


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             attention_impl: str = "auto", with_roofline: bool = True,
             out_dir: str = OUT_DIR, cfg: ModelConfig = None) -> dict:
    """Count one cell and write its JSON; `cfg` replaces the registered
    arch's config (a reduced one in tests).  The cell runs under the
    default ParallelContext (`moe_parallel` in the JSON), as the
    launchers run."""
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape_name]
    dims, axes = MESHES[mesh_kind]
    n_chips = math.prod(dims)
    t0 = time.perf_counter()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "chips": n_chips, "mode": shape.mode,
              "moe_parallel": True}
    try:
        with RL.fake_group(n_chips):
            mesh = make_auto_mesh(dims, axes, device="cpu")
            with use_mesh(mesh), parallel_context(ParallelContext()):
                if shape.mode == "decode":
                    rl, ex, memory, progs = count_decode_cell(
                        cfg, shape, mesh, attention_impl)
                elif shape.mode == "prefill":
                    rl, ex, memory, progs = count_prefill_cell(
                        cfg, shape, mesh, attention_impl)
                else:
                    rl, ex, memory, progs = count_train_cell(
                        cfg, shape, mesh, attention_impl)
                result["memory"] = memory
                result["counts"] = {"flops_by_op": ex.flops_by_op,
                                    "coll_calls": ex.coll_calls,
                                    "floor_bytes": ex.floor_bytes}
                if with_roofline:
                    per_unit = []
                    for name, fn, args, k in progs:
                        u, _ = RL.count(fn, *args)
                        per_unit.append({"name": name, "k": k,
                                         **u.as_dict()})
                    tokens = shape.global_batch * (
                        shape.seq_len if shape.mode != "decode" else 1)
                    mf = RL.model_flops(cfg.param_count(),
                                        cfg.active_param_count(), tokens,
                                        shape.mode)
                    result["roofline"] = rl.as_dict()
                    result["roofline"].update(
                        units=per_unit, extrapolated=False,
                        model_flops_global=mf,
                        model_flops_per_chip=mf / n_chips,
                        useful_ratio=mf / n_chips / rl.flops
                        if rl.flops else 0.0)
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    result["seconds"] = round(time.perf_counter() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attention-impl", default="auto")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume: skip cells whose JSON already exists ok")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    targets = []
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        for s in cells(a):
            if args.shape and s.name != args.shape:
                continue
            targets.append((a, s.name))
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for a, s in targets:
        for mk in meshes:
            fn = os.path.join(args.out, f"{a}__{s}__{mk}.json")
            if args.skip_existing and os.path.exists(fn):
                with open(fn) as f:
                    if json.load(f).get("status") == "ok":
                        log.info(f"{a:22s} {s:12s} {mk:8s} skip (exists)")
                        continue
            r = run_cell(a, s, mk, args.attention_impl,
                         not args.no_roofline, args.out)
            dom = r.get("roofline", {}).get("dominant", "-")
            mem = r.get("memory", {}).get("argument_size_in_bytes", 0)
            log.info(f"{a:22s} {s:12s} {mk:8s} {r['status']:5s} "
                     f"args/dev={mem / 2**30:7.2f}GiB dominant={dom:10s} "
                     f"{r['seconds']:6.1f}s")
            if r["status"] != "ok":
                failures += 1
                log.error(r["error"])
    log.info(f"done: {len(targets) * len(meshes) - failures} ok, "
             f"{failures} failed")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
