"""One rank of a multi-rank run of the port (started by
`_torch_dist.start_ranks`): joins a group over a FileStore in WORKDIR
(gloo on the CPU; NCCL, card `RANK`, when REPRO_DIST_DEVICE=cuda), runs
CASE and saves what the test compares to WORKDIR/out_<rank>.pt.

    python _torch_dist_worker.py CASE RANK WORLD WORKDIR

Cases:
- moe (8 ranks, or 4 on cards): on a (2, WORLD / 2) ("data", "model")
  mesh, the expert-parallel and TP-ff blocks at capacity factors 8.0 and
  1.25, and the dispatcher's dropless path with the mesh alone, on
  WORKDIR/moe_in.npz (`moe_inputs`); both explicit paths at 1.25 on
  inputs split on the sequence over 'data' (`CP_SHAPES`); each with its
  gradients; then, with 8 ranks, the explicit paths at 1.25 on batches
  the data axes replicate (`REP_CASES`, each on its own mesh), and
  `spec_to_placements` on a (2, 2, 2) ("pod", "data", "model") mesh:
  each rank's shard of an arange tensor.
- train (4 ranks): on a (2, 2) mesh, the checkpoint in WORKDIR/ckpt
  restored with the mesh's state shardings, then two AdamW steps from
  it, whose state is saved from the mesh and restored again; and two
  Adafactor steps with 2 microbatches from a fresh state.
- tp (WORLD ranks): WORKDIR/tp_in.pt names the ("data", "model") mesh
  and the runs, each with its params or the seed to draw them from
  (`seeded_params`): train steps (two steps of each config from its
  params, by the optimizer its "opt" names, AdamW unless it says
  otherwise, the state placed for it; a run may name its "remat", its
  attention "impl", its MoE "capacity" and its "microbatches"; on
  cards each rank's kernel launches of each step and its largest
  `max_memory_allocated` of a step, the state's gathers for the
  comparison left out), decode steps (a fed token a
  slot a step: the next tokens and the whole logits; at the run's MoE
  "capacity"), `serve_loop` runs and prefills (the run's "tokens" and
  attention "impl": the whole last-position logits and each kernel
  wrapper's launches on this rank, the split-row RMSNorm's apart).
"""

import dataclasses
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.mesh import make_auto_mesh, use_mesh
from repro_torch.runtime.parallel import ParallelContext, parallel_context

#: the specs of the placement check, on a (16, 8) tensor
PLACE_SPECS = ((("pod", "data"), "model"), (None, ("pod", "data")),
               ("model", ("pod", "data")), (("pod", "data", "model"), None),
               ("data", None), (None, "pod"))


#: the `moe` case's inputs split on the sequence over 'data' (context
#: parallelism): one row, and three rows (the reference's blocks of
#: tokens then straddle the ranks' parts)
CP_SHAPES = {"cp1": (1, 64), "cp3": (3, 32)}

#: the `moe` case's replicated inputs on 8 ranks: (mesh ("data",
#: "model"), (rows, sequence), paths), rows and sequence each indivisible
#: by 'data', their token count divisible by what the path splits it
#: over.  On (4, 2) no such batch reaches the expert-parallel path (its
#: tokens would need a factor 8 from two factors short of 4), so it runs
#: on (8, 1).
REP_CASES = {"rep4": ((4, 2), (2, 6), ("tp",)),
             "rep8": ((8, 1), (2, 12), ("ep", "tp"))}


def moe_inputs(seed=0):
    """The block's weights, x and a cotangent c for sum(y * c), float32."""
    rng = np.random.default_rng(seed)
    d, E, ff = 64, 8, 32
    out = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
           "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
           "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
           "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff),
           "x": rng.standard_normal((2, 16, d)),
           "c": rng.standard_normal((2, 16, d))}
    shapes = [*CP_SHAPES.values(), *(s for _, s, _ in REP_CASES.values())]
    for B, S in shapes:
        out[f"x_{B}x{S}"] = rng.standard_normal((B, S, d))
        out[f"c_{B}x{S}"] = rng.standard_normal((B, S, d))
    return {k: v.astype(np.float32) for k, v in out.items()}


def moe_cfg():
    """The reference's `tests/test_moe_parallel.py` block."""
    return dataclasses.replace(reduced(ARCHS["kimi-k2-1t-a32b"]),
                               n_experts=8, experts_per_token=2,
                               moe_d_ff=32, d_model=64, unit=())


def case_moe(workdir, device):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.runtime.parallel import seq_split
    from repro_torch.runtime.sharding import P, SeqSplit, spec_to_placements

    from _torch_dist import tp_local

    cfg = moe_cfg()
    data = np.load(workdir / "moe_in.npz")
    world = dist.get_world_size()
    mesh = make_auto_mesh((2, world // 2), ("data", "model"), device)
    n_model = world // 2
    i = mesh.index("data")

    def tensors():
        params = {k: torch.from_numpy(data[k]).to(device).requires_grad_()
                  for k in ("router", "w_gate", "w_up", "w_down")}
        x = torch.from_numpy(data["x"][i:i + 1]).to(device).requires_grad_()
        return params, x

    cot = torch.from_numpy(data["c"][i:i + 1]).to(device)

    def record(y, aux, params, x, c=cot, holders=n_model):
        # this data shard's y is on each of its model ranks (on every
        # rank, where the batch is replicated)
        grads = torch.autograd.grad((y * c).sum() / holders,
                                    [*params.values(), x])
        return {"y": y.detach().cpu(), "aux": aux.detach().cpu(),
                "grads": {k: g.cpu() for k, g in
                          zip([*params, "x"], grads)}}

    out = {"data_index": i, "model_index": mesh.index("model")}
    def shards(params, path, mesh=mesh):
        # each path takes this rank's shard of the stacks (a view of the
        # whole leaf, whose gradient is zero off the shard)
        return dict(params, **tp_local(mesh, {"moe": {
            k: params[k] for k in ("w_gate", "w_up", "w_down")}},
            path)["moe"])

    runs = {"ep": (moe.moe_block_expert_parallel, "expert"),
            "tp": (moe.moe_block_tp_ff, "tp_ff")}
    for cf in (8.0, 1.25):
        ctx = ParallelContext(capacity_factor=cf)
        for name, (fn, path) in runs.items():
            params, x = tensors()
            with use_mesh(mesh), parallel_context(ctx):
                y, aux = fn(shards(params, path), x, cfg, ctx)
            out[f"{name}_{cf}"] = record(y, aux, params, x)
    params, x = tensors()
    with use_mesh(mesh):
        y, aux = moe.moe_block(shards(params, "dropless"), x, cfg)
    out["gspmd"] = record(y, aux, params, x)

    # each data rank's half of every row's sequence, under its split
    ctx = ParallelContext(capacity_factor=1.25)
    for key, (B, S) in CP_SHAPES.items():
        part = slice(i * S // 2, (i + 1) * S // 2)
        split = SeqSplit(("data",), part.start, S)
        c = torch.from_numpy(data[f"c_{B}x{S}"][:, part]).to(device)
        for name, (fn, path) in runs.items():
            params, _ = tensors()
            x = torch.from_numpy(data[f"x_{B}x{S}"][:, part]).to(
                device).requires_grad_()
            with use_mesh(mesh), parallel_context(ctx), seq_split(split):
                y, aux = fn(shards(params, path), x, cfg, ctx)
            out[f"{name}_{key}"] = record(y, aux, params, x, c)

    if world == 8:
        # every rank the whole batch
        for key, (shape, (B, S), names) in REP_CASES.items():
            rmesh = make_auto_mesh(shape, ("data", "model"), device)
            c = torch.from_numpy(data[f"c_{B}x{S}"]).to(device)
            for name in names:
                fn, path = runs[name]
                params, _ = tensors()
                x = torch.from_numpy(data[f"x_{B}x{S}"]).to(
                    device).requires_grad_()
                with use_mesh(rmesh), parallel_context(ctx), \
                        seq_split(SeqSplit((), 0, S)):
                    y, aux = fn(shards(params, path, rmesh), x, cfg, ctx)
                out[f"{name}_{key}"] = record(y, aux, params, x, c, world)
        cube = make_auto_mesh((2, 2, 2), ("pod", "data", "model"), device)
        full = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
        out["coords"] = tuple(cube.index(a) for a in cube.shape)
        out["shards"] = [distribute_tensor(
            full, cube.device_mesh, spec_to_placements(cube, P(*spec)),
            src_data_rank=None).to_local() for spec in PLACE_SPECS]
    return out


def train_setup(device="cpu", mesh=None, opt="adamw", microbatches=1):
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import TrainConfig, make_train_step
    cfg = reduced(ARCHS["smollm-360m"])
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        name=opt, lr=1e-3, warmup_steps=1, total_steps=50),
        microbatches=microbatches, remat=False)
    return cfg, make_train_step(cfg, tcfg, device, mesh=mesh)


def train_batches(cfg, n=2):
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    dcfg = DataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size)
    return [{k: torch.from_numpy(v)
             for k, v in batch_for_model(cfg, dcfg, s).items()}
            for s in range(n)]


def fp32_state(init_fn, seed=0):
    """A fresh state from `seed` with float32 params."""
    from repro_torch.tree import tree_map
    state = init_fn(torch.Generator().manual_seed(seed))
    return dict(state, params=tree_map(lambda t: t.float(), state["params"]))


def full(tree):
    from repro_torch.tree import named_leaves
    return {"/".join(p): t.full_tensor() for p, t in named_leaves(tree)}


def case_train(workdir, device):
    from repro_torch.checkpoint.checkpointer import restore, save
    from repro_torch.runtime.sharding import place, state_shardings
    from repro_torch.tree import leaves, named_leaves

    mesh = make_auto_mesh((2, 2), ("data", "model"), device)
    out = {}
    with use_mesh(mesh), parallel_context(ParallelContext()):
        cfg, (step_fn, init_fn) = train_setup(mesh=mesh)
        like = fp32_state(init_fn, seed=1)
        sh = state_shardings(mesh, like, "adamw")
        state = restore(str(workdir / "ckpt"), like, shardings=sh)
        out["restored"] = full(state)
        out["placements"] = {
            "/".join(p): (str(tuple(t.placements)),
                          str(tuple(s.placements)))
            for (p, t), (_, s) in zip(named_leaves(state),
                                      named_leaves(sh))}
        losses = []
        for batch in train_batches(cfg):
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
        out["adamw"] = {"losses": losses, "state": full(state)}
        # saved from the mesh (rank 0 writes) and read back by every rank
        save(str(workdir / "ckpt_mesh"), state, 2)
        back = restore(str(workdir / "ckpt_mesh"), like, shardings=sh)
        out["resaved_exact"] = all(
            torch.equal(a.full_tensor(), b.full_tensor())
            and tuple(a.placements) == tuple(b.placements)
            for a, b in zip(leaves(back), leaves(state)))

        cfg, (step_fn, init_fn) = train_setup(mesh=mesh, opt="adafactor",
                                              microbatches=2)
        state = fp32_state(init_fn)
        state = place(state, state_shardings(mesh, state, "adafactor"))
        losses = []
        for batch in train_batches(cfg):
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
        out["adafactor"] = {"losses": losses, "state": full(state)}
    return out


def seeded_params(cfg, seed, device):
    """The model's params drawn from a generator on `device` seeded
    `seed`, in float32."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    params = build_model(cfg, remat=False, device=device).init(
        torch.Generator(device).manual_seed(seed))
    return tree_map(lambda t: t.float(), params)


def case_tp(workdir, device):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.serve import serve_loop
    from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
    from repro_torch.runtime.parallel import all_gather
    from repro_torch.runtime.serve import (ServeConfig, gather_slots,
                                           make_serve_fns, slot_rows)
    from repro_torch.runtime.sharding import (params_shardings, place,
                                              state_shardings)
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import tree_map

    spec = torch.load(workdir / "tp_in.pt", weights_only=False)
    mesh = make_auto_mesh(spec["mesh"], ("data", "model"), device)

    def dev(tree):
        return tree_map(lambda t: t.to(device), tree)

    def weights(run):
        """The run's params, or float32 ones drawn on this device from
        the seed it names."""
        if not isinstance(run["params"], int):
            return dev(run["params"])
        return seeded_params(run["cfg"], run["params"], device)

    out = {"train": {}, "decode": {}, "prefill": {}, "serve": {}}
    for name, run in spec.get("train", {}).items():
        ctx = ParallelContext(capacity_factor=run.get("capacity", 1.25))
        with use_mesh(mesh), parallel_context(ctx):
            opt = OptimizerConfig(**run["opt"])
            step_fn, _ = make_train_step(run["cfg"], TrainConfig(
                optimizer=opt, remat=run.get("remat", False),
                attention_impl=run.get("impl", "auto"),
                aux_loss_weight=run.get("aux", 0.01),
                loss_impl=run.get("loss_impl", "onehot"),
                microbatches=run.get("microbatches", 1)), device, mesh=mesh)
            params = weights(run)
            state = {"params": params,
                     "opt": build_optimizer(opt).init(params),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            state = place(state, state_shardings(mesh, state, opt.name))
            # every_step: rank 0's whole state after each step, in
            # "states", and no other rank's (their whole states are the
            # same gathers); else each rank's after the last, in "state"
            every = run.get("every_step", False)
            losses, states, peak, launches = [], [], 0, []
            for batch in run["batches"]:
                if device == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                    flash_attention.launches = rmsnorm.launches = 0
                    rmsnorm.bwd_launches = rmsnorm.split_launches = 0
                    ssd.launches = ssd.bwd_launches = 0
                state, m = step_fn(state, dev(batch))
                if device == "cuda":
                    peak = max(peak, torch.cuda.max_memory_allocated())
                    launches.append({
                        "flash_attention": flash_attention.launches,
                        "rmsnorm": rmsnorm.launches,
                        "rmsnorm.bwd": rmsnorm.bwd_launches,
                        "rmsnorm.split": rmsnorm.split_launches,
                        "ssd": ssd.launches, "ssd_bwd": ssd.bwd_launches})
                losses.append(float(m["loss"]))
                if every:
                    whole = full(state)
                    if dist.get_rank() == 0:
                        states.append(tree_map(lambda t: t.cpu(), whole))
                    del whole
            res = {"losses": losses}
            if device == "cuda":
                res["max_memory_allocated"] = peak
                res["launches"] = launches
            if every:
                res["states"] = states
            else:
                res["state"] = tree_map(lambda t: t.cpu(), full(state))
            out["train"][name] = res
    for name, run in spec.get("decode", {}).items():
        cfg, feed = run["cfg"], run["feed"].to(device)
        ctx = ParallelContext(capacity_factor=run.get("capacity", 1.25))
        with use_mesh(mesh), parallel_context(ctx):
            _, step, init_cache = make_serve_fns(
                cfg, ServeConfig(max_len=run["max_len"]), device, mesh)
            params = weights(run)
            placed = place(params, params_shardings(mesh, params))
            cache = init_cache(feed.shape[0])
            toks, logits = [], []
            for pos in range(feed.shape[1]):
                nxt, lg, cache = step(placed, cache,
                                      slot_rows(mesh, feed[:, pos:pos + 1]),
                                      pos)
                if lg.shape[-1] != cfg.vocab_size:
                    lg = all_gather(lg, mesh, ("model",), -1)
                toks.append(gather_slots(mesh, nxt, feed.shape[0]).cpu())
                logits.append(gather_slots(mesh, lg, feed.shape[0]).cpu())
        out["decode"][name] = {"tokens": torch.cat(toks, 1),
                               "logits": torch.cat(logits, 1)}
    for name, run in spec.get("prefill", {}).items():
        cfg, tokens = run["cfg"], run["tokens"].to(device)
        with use_mesh(mesh), parallel_context(ParallelContext()):
            prefill, _, _ = make_serve_fns(cfg, ServeConfig(
                max_len=tokens.shape[1], attention_impl=run["impl"]),
                device, mesh)
            params = weights(run)
            placed = place(params, params_shardings(mesh, params))
            ssd.launches = rmsnorm.launches = rmsnorm.split_launches = 0
            lg = prefill(placed, {"tokens": tokens})
            launches = {"ssd": ssd.launches, "rmsnorm": rmsnorm.launches}
            split = rmsnorm.split_launches
            if lg.shape[-1] != cfg.vocab_size:
                lg = all_gather(lg, mesh, ("model",), -1)
            lg = gather_slots(mesh, lg, tokens.shape[0])
        out["prefill"][name] = {"logits": lg.cpu(), "launches": launches,
                                "split_launches": split}
    for name, run in spec.get("serve", {}).items():
        res, _ = serve_loop(weights(run), run["cfg"],
                            ServeConfig(max_len=run["max_len"]),
                            [list(r) for r in run["queue"]], run["slots"],
                            run["max_new"], device, mesh)
        out["serve"][name] = res
    return out


def main():
    case, rank, world, workdir = sys.argv[1:]
    rank, world, workdir = int(rank), int(world), pathlib.Path(workdir)
    device = os.environ.get("REPRO_DIST_DEVICE", "cpu")
    torch.set_num_threads(1)
    kwargs = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        store=dist.FileStore(str(workdir / "store"), world),
        rank=rank, world_size=world, **kwargs)
    try:
        out = {"moe": case_moe, "train": case_train,
               "tp": case_tp}[case](workdir, device)
        torch.save(out, workdir / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
