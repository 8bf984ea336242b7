"""Serving launcher: batched decode with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 16 --slots 4 --max-new 16

`serve_loop` is the scheduler of the reference launcher
(`repro/launch/serve.py`) as a function: every slot decodes at one shared
position counter, and a slot whose request finished takes the next
request from the queue.  As in the reference, a new request continues at
the shared position of its slot, so it also sees the keys the slot's
previous request left in the cache; on an SSM (mamba2, zamba2) it also
inherits that request's recurrent state and conv window.  An
encoder-decoder (seamless) decodes against the cross cache that
`init_cache` leaves (zeros of 1024 source positions), as the reference's
loop does: no source is encoded.  `--arch` takes every registered arch
(`configs.ARCHS`).

Given a mesh, `serve_loop` runs under `use_mesh(mesh)` and the default
`ParallelContext`, as the reference launcher's body does (`main` always
gives it one: `--mesh host`, the default, is (1, world) of the process
group, which `main` starts with one rank when there is none and ends on
return).  An MoE
model then takes the reference's expert-parallel path, whose capacity
buckets drop rows: at decode with 4 slots on mixtral each expert's
bucket holds one row.  The loop places the params by the sharding rules
and gives each rank its slots under `batch_spec`: its share of them over
the data axes, or every slot when they do not divide (the cache's
sequence is then split, `runtime/serve.py`).  It gathers the next tokens
back, so that the scheduler, the same on every rank, is the reference's.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..configs.base import ModelConfig
from ..models import build_model
from ..runtime.parallel import ParallelContext, parallel_context
from ..runtime.serve import (ServeConfig, gather_slots, make_serve_fns,
                             slot_rows)
from ..runtime.sharding import params_shardings, place
from .mesh import (init_process_group, make_host_mesh, make_production_mesh,
                   use_mesh)

log = logging.getLogger("repro_torch.launch.serve")


def make_requests(n: int, vocab_size: int) -> List[List[int]]:
    """n prompts of 2-5 tokens, drawn as the reference launcher draws."""
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, vocab_size, size=int(rng.integers(2, 6))))
            for _ in range(n)]


def serve_loop(params, cfg: ModelConfig, scfg: ServeConfig,
               queue: List[List[int]], slots: int, max_new: int,
               device="cuda", mesh=None) -> Tuple[Dict[int, List[int]], Dict]:
    """Serve the queued prompts; returns ({request id: new tokens}, stats).

    Stops when the queue and the slots are empty, or at position
    scfg.max_len - 1.  `queue` is consumed.  With a mesh, under the
    launcher's context (module docstring)."""
    if mesh is None:
        return _serve(params, cfg, scfg, queue, slots, max_new, device)
    with use_mesh(mesh), parallel_context(ParallelContext()):
        return _serve(params, cfg, scfg, queue, slots, max_new, device,
                      mesh)


def _serve(params, cfg, scfg, queue, slots, max_new, device, mesh=None):
    _, decode_step, init_cache = make_serve_fns(cfg, scfg, device, mesh)
    if mesh is not None:
        params = place(params, params_shardings(mesh, params))
    queue = [list(map(int, p)) for p in queue]
    n_requests = len(queue)
    cache = init_cache(slots, scfg.max_len)
    active = [None] * slots
    results: Dict[int, List[int]] = {}
    served = steps = pos = 0
    t0 = time.perf_counter()
    while (queue or any(active)) and pos < scfg.max_len - 1:
        for s in range(slots):
            if active[s] is None and queue:
                active[s] = [served, queue.pop(0), []]
                served += 1
        feed = np.zeros((slots, 1), np.int32)
        for s, a in enumerate(active):
            if a is None:
                continue
            _, prompt, out = a
            feed[s, 0] = prompt.pop(0) if prompt else out[-1]
        tok = torch.from_numpy(feed).to(device)
        if mesh is None:
            nxt, _, cache = decode_step(params, cache, tok, pos)
        else:
            nxt, _, cache = decode_step(params, cache, slot_rows(mesh, tok),
                                        pos)
            nxt = gather_slots(mesh, nxt, slots)
        nxt = nxt.cpu().numpy()
        steps += 1
        for s, a in enumerate(active):
            if a is None:
                continue
            rid, prompt, out = a
            if not prompt:
                out.append(int(nxt[s, 0]))
                if len(out) >= max_new:
                    results[rid] = out
                    active[s] = None
        pos += 1
    wall_s = time.perf_counter() - t0
    stats = {"requests": n_requests, "served": len(results), "steps": steps,
             "slots": slots, "wall_s": wall_s,
             "tok_per_s": steps * slots / wall_s if wall_s > 0 else 0.0}
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    # The reference declares --reduced as store_true with default True,
    # so it cannot be turned off; here --no-reduced serves full width.
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg, vocab_size=min(cfg.vocab_size, 4096))
    scfg = ServeConfig(max_len=args.max_len)
    started = init_process_group(args.device)
    try:
        mesh = (make_host_mesh(args.device) if args.mesh == "host"
                else make_production_mesh(multi_pod=args.mesh == "multipod",
                                          device=args.device))
        model = build_model(cfg, remat=False, device=args.device)
        params = model.init(torch.Generator(device=args.device).manual_seed(0))
        queue = make_requests(args.requests, cfg.vocab_size)
        results, st = serve_loop(params, cfg, scfg, queue, args.slots,
                                 args.max_new, args.device, mesh)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    log.info(f"served {st['served']}/{st['requests']} requests, "
             f"{st['steps']} decode steps x {st['slots']} slots in "
             f"{st['wall_s']:.1f}s ({st['tok_per_s']:.1f} tok/s)")
    return results, st


if __name__ == "__main__":
    main()
