"""Time the bf16 SSD backward at the SSM models' train shapes for several
head-group sizes: the choice `kernels.ssd.ops.bwd_heads_per_group` makes
(about one wave of blocks, at most 16 heads) beside smaller groups.

    PYTHONPATH=src python -m repro_torch.launch.ssd_groups
    PYTHONPATH=src python -m repro_torch.launch.ssd_groups --groups 4 6 12

Each line: the shape, the heads a group, the blocks of a chunk pass
(head groups x chunks x batch rows) against the card's SMs, and the
device ms a call (CUDA events over `--iters` calls after 3 warm-up
calls; the inputs are random, from seed 0, and the forward's states are
made once, as `_SSD` keeps them).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import logging

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.ssd import ops

log = logging.getLogger("repro_torch.launch.ssd_groups")
SHAPES = {"mamba2-130m": (8, 1024, 24, 64, 128),
          "zamba2-2.7b": (2, 1024, 80, 64, 64)}


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="*", default=[4, 5, 6, 8],
                    help="heads a group to time beside the chosen one")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if not torch.cuda.is_available():
        raise SystemExit("ssd_groups: needs a CUDA card")
    _build.build_all(["ssd"])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    chosen_rule = ops.bwd_heads_per_group
    for name, (b, L, H, P, N) in SHAPES.items():
        def randn(shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = (0.5 * randn((b, L, H, P))).bfloat16()
        dt = F.softplus(randn((b, L, H)))
        A = -torch.exp(0.3 * randn((H,)))
        B, C = ((0.5 * randn((b, L, N))).bfloat16() for _ in range(2))
        dy = randn((b, L, H, P)).bfloat16()
        states = ops._launch(x, dt, A, B, C, keep=True)[1]
        chosen = chosen_rule(b, L, H, dev)
        chunks = -(-L // ops.TC_CHUNK)
        for hg in sorted(set(args.groups) | {chosen}):
            ops.bwd_heads_per_group = lambda *_a, _hg=hg, **_k: _hg
            try:
                t = _ms(lambda: ops._launch_bwd(x, dt, A, B, C, dy, states),
                        args.iters)
            finally:
                ops.bwd_heads_per_group = chosen_rule
            blocks = -(-H // hg) * chunks * b
            log.info(f"{name} (b={b} L={L} H={H} P={P} N={N}): {hg} heads a "
                     f"group{' (chosen)' if hg == chosen else ''}, {blocks} "
                     f"blocks on {sms} SMs: {t:.4f} ms")


if __name__ == "__main__":
    main()
