"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 200 --batch 16 --seq 128 [--full] [--resume] \
        [--mesh host|pod|multipod] [--compress] [--microbatches 4] \
        [--device cuda]

The reference launcher (`repro/launch/train.py`): the mesh (`--mesh
host`, the default, is (1, world) of the process group, which `main`
starts with one rank when there is none and ends on return; `pod` and
`multipod` need a group of 256 or 512 ranks) and the ParallelContext
around everything; the train state placed by `state_shardings` and
`make_train_step` on the mesh (`runtime/train.py` says what a sharded
step computes); the step-indexed data pipeline, async checkpoints every
`--ckpt-every` steps, `--resume` from the latest checkpoint (restored
with the mesh's shardings), straggler tracking, and crash recovery.
A `--batch`, or a microbatch of it (`--microbatches`), whose rows the
mesh's data axes do not divide trains on each rank's part of its
sequence, or replicated where the sequence does not divide either
(`runtime/train.py: mesh_apply`), as the reference's compiled step
does.  `--reduced` is the default (the reference keeps it so); `--full`
trains the published widths, with remat on.  AdamW unless the model has
more than 100e9 parameters (then Adafactor).  Every arch trains on the
card, the SSM models' scans differentiated by the SSD backward kernel
(`--arch mamba2-130m --full --device cuda`).

`train_loop` is the loop itself.  A step that raises a RuntimeError (a
CUDA fault, an out-of-memory error) restores the latest checkpoint and
carries on from the step stored in it, so the replayed steps see the
same batches (the reference launcher restores and moves on to the next
step); before the first checkpoint the launcher makes its initial state
again from the seed.  The loop counts these recoveries, stops after
`max_restarts`, and lets NotImplementedError (a path the port does not
run) through.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from ..checkpoint.checkpointer import (AsyncCheckpointer, latest_steps,
                                       restore)
from ..configs import ARCHS, reduced
from ..data.pipeline import DataConfig, batch_for_model
from ..optim.optimizers import OptimizerConfig
from ..runtime.compression import CompressionConfig
from ..runtime.fault_tolerance import StragglerMitigator
from ..runtime.parallel import ParallelContext, parallel_context
from ..runtime.sharding import place, state_shardings
from ..runtime.train import TrainConfig, make_train_step
from ..tree import tree_map
from .mesh import (init_process_group, make_host_mesh, make_production_mesh,
                   use_mesh)

log = logging.getLogger("repro_torch.launch.train")
_MEGA = 1e6


def device_batch(cfg, dcfg: DataConfig, step: int, device) -> Dict:
    """The pipeline's batch for `step`, as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in batch_for_model(cfg, dcfg, step).items()}


def train_loop(step_fn: Callable, state: Dict, batch_fn: Callable[[int], Dict],
               n_steps: int, ckpt: AsyncCheckpointer, ckpt_every: int = 50,
               log_every: int = 10,
               restart_fn: Optional[Callable[[], Dict]] = None,
               failure_injector: Optional[Callable[[int], bool]] = None,
               max_restarts: int = 25, shardings=None):
    """Run steps int(state["step"]) .. n_steps - 1; returns (state, stats).

    After step s (s > 0, s % ckpt_every == 0) the state is checkpointed
    asynchronously, as the reference launcher does.  A failed step
    restores the latest checkpoint in `ckpt.path` or, before there is
    one, takes `restart_fn()` (the run's initial state made again; with
    none, the failure is raised).  `failure_injector(s)` returning True
    makes step s fail (tests use it).  On a mesh, `shardings` (the
    state's `state_shardings`) places the restored checkpoint.  stats:
    "steps_run" (replays included), "recoveries", "wall_s", and by step
    index the last run's "step_s", "ce" and "loss"."""
    straggler = StragglerMitigator()
    s = int(state["step"])
    recoveries, steps_run = 0, 0
    step_s: Dict[int, float] = {}
    ce: Dict[int, float] = {}
    loss: Dict[int, float] = {}
    t_run = time.perf_counter()
    while s < n_steps:
        t0 = time.perf_counter()
        try:
            if failure_injector is not None and failure_injector(s):
                raise RuntimeError(f"injected failure at step {s}")
            batch = batch_fn(s)
            state, metrics = step_fn(state, batch)
            loss[s] = float(metrics["loss"])     # waits for the step
            ce[s] = float(metrics["ce"])
        except NotImplementedError:
            raise
        except RuntimeError as e:
            recoveries += 1
            if recoveries > max_restarts:
                raise RuntimeError(f"train_loop: over max_restarts="
                                   f"{max_restarts} at step {s}") from e
            ckpt.wait()
            if latest_steps(ckpt.path):
                log.error(f"step {s} failed ({e}); restoring the latest "
                          f"checkpoint")
                state = restore(ckpt.path, state, shardings=shardings)
            elif restart_fn is not None:
                log.error(f"step {s} failed ({e}); no checkpoint yet, "
                          f"restarting from the initial state")
                state = restart_fn()
            else:
                raise
            s = int(state["step"])
            continue
        step_s[s] = time.perf_counter() - t0
        steps_run += 1
        straggler.record(0, step_s[s])
        if s % log_every == 0 or s == n_steps - 1:
            tokens = batch["labels"].numel()
            log.info(f"step {s:5d} ce={ce[s]:.4f} loss={loss[s]:.4f} "
                     f"tok/s={tokens / max(1e-9, step_s[s]):,.0f}")
        if s and s % ckpt_every == 0:
            ckpt.save_async(state, s)
        if straggler.stragglers():
            log.warning(f"stragglers detected: {straggler.stragglers()}")
        s += 1
    stats = {"steps_run": steps_run, "recoveries": recoveries,
             "wall_s": time.perf_counter() - t_run,
             "step_s": step_s, "ce": ce, "loss": loss}
    return state, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--optimizer", default=None,
                    choices=[None, "adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression (quantise+dequantise)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg, vocab_size=min(cfg.vocab_size, 8192))
    opt_name = args.optimizer or (
        "adafactor" if cfg.param_count() > 100e9 else "adamw")
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(name=opt_name, lr=args.lr,
                                  warmup_steps=max(1, args.steps // 20),
                                  total_steps=args.steps),
        microbatches=args.microbatches,
        compression=CompressionConfig() if args.compress else None,
        remat=not args.reduced)
    started = init_process_group(args.device)
    try:
        return _run(args, cfg, tcfg, opt_name)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run(args, cfg, tcfg, opt_name):
    """main's body, once the process group is up; the state is returned
    as whole tensors (gathered before the group ends)."""
    mesh = (make_host_mesh(args.device) if args.mesh == "host"
            else make_production_mesh(multi_pod=args.mesh == "multipod",
                                      device=args.device))
    step_fn, init_fn = make_train_step(cfg, tcfg, args.device, mesh=mesh)
    log.info(f"arch={cfg.name} reduced={args.reduced} "
             f"params~{cfg.param_count() / _MEGA:.1f}M opt={opt_name} "
             f"device={args.device} mesh={mesh.shape}")

    with use_mesh(mesh), parallel_context(ParallelContext()):
        def initial_state():
            return init_fn(torch.Generator(device=args.device).manual_seed(0))

        state = initial_state()
        st_sh = state_shardings(mesh, state, opt_name)
        state = place(state, st_sh)
        ck = AsyncCheckpointer(args.ckpt_dir, keep=3)
        start = 0
        if args.resume and latest_steps(args.ckpt_dir):
            state = restore(args.ckpt_dir, state, shardings=st_sh)
            start = int(state["step"])
            log.info(f"resumed at step {start}")

        dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                          vocab_size=cfg.vocab_size)
        state, stats = train_loop(
            step_fn, state, lambda s: device_batch(cfg, dcfg, s, args.device),
            args.steps, ck, args.ckpt_every, args.log_every,
            restart_fn=lambda: place(initial_state(), st_sh),
            shardings=st_sh)
        ck.save_async(state, args.steps)
        ck.wait()
        state = tree_map(lambda t: t.full_tensor(), state)
    log.info(f"finished {args.steps - start} steps in {stats['wall_s']:.1f}s "
             f"({stats['steps_run']} run, {stats['recoveries']} recoveries); "
             f"checkpoints: {latest_steps(args.ckpt_dir)}")
    return state, stats


if __name__ == "__main__":
    main()
