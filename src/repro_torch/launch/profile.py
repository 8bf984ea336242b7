"""Device profile of a serving prefill or a train step: where the
card's time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch smollm-360m \
        --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.profile --train \
        --arch smollm-360m --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch mixtral-8x22b --layers 4

Full width unless `--reduced`, random bf16 weights from seed 0, as
`chip_smoke.py` runs them (train steps: AdamW, remat on); `--layers`
cuts the depth (mixtral-8x22b and kimi-k2 fit one card only so).
`torch.profiler` traces `--calls` warm prefills or steps and reports the
device time of each kernel (summed over the calls, largest first), the
device's busy time against the wall time of the traced window (its idle
share), the host's wall time per call and, in training, the device time
of the plain attention backward (the flash-attention wrapper's named
backward range) and its share of the busy time.  On the CPU it reports
the CPU's operators and no device numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS, reduced
from ..data.pipeline import DataConfig, batch_for_model
from ..kernels.flash_attention.ops import PLAIN_BACKWARD
from ..models import build_model
from ..runtime.serve import ServeConfig, make_serve_fns
from ..runtime.train import TrainConfig, make_train_step

log = logging.getLogger("repro_torch.launch.profile")
_MS_PER_S = 1e3
_US_PER_MS = 1e3


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _trace(run, calls: int, on_card: bool, per: str) -> Dict:
    """Trace `calls` runs of `run` (already warm); the kernels' device
    times (us, summed over the calls, largest first), the device's busy
    time and idle share of the traced window, the host's ms per call, and
    the device time inside the flash-attention backward's named range
    (the plain attention VJP).  `per` names a call in the keys
    ("host_ms_per_prefill", "device_busy_ms_per_step", ...)."""
    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        sync()
        wall_s = time.perf_counter() - t0

    kind = torch.autograd.DeviceType.CUDA if on_card else \
        torch.autograd.DeviceType.CPU
    spans, per_name, plain_bwd_us = [], {}, 0.0
    cpu = torch.autograd.DeviceType.CPU
    for evt in prof.events():
        if evt.name == PLAIN_BACKWARD and evt.device_type == cpu:
            plain_bwd_us += evt.device_time_total   # its ops' kernels
        if evt.is_user_annotation:    # a named range, not a kernel
            continue
        if evt.device_type != kind or (not on_card and evt.cpu_parent):
            continue                  # on the CPU: top-level operators only
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        per_name[evt.name] = per_name.get(evt.name, 0.0) + end - start
    out = {"calls": calls, f"host_ms_per_{per}": wall_s / calls * _MS_PER_S,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "kernels_us": dict(sorted(per_name.items(),
                                     key=lambda kv: -kv[1]))}
    if on_card and spans:
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _busy_us(spans)
        out.update({
            f"device_busy_ms_per_{per}": busy / calls / _US_PER_MS,
            f"device_window_ms_per_{per}": window / calls / _US_PER_MS,
            "device_idle_share": 1.0 - busy / window if window else 0.0,
            f"plain_attention_bwd_ms_per_{per}":
                plain_bwd_us / calls / _US_PER_MS,
            "plain_attention_bwd_share_of_busy":
                plain_bwd_us / busy if busy else 0.0})
    return out


def profile_prefill(arch: str, batch: int, seq: int, calls: int = 3,
                    device: str = "cuda", use_reduced: bool = False,
                    layers: Optional[int] = None) -> Dict:
    """Trace `calls` warm prefills of token ids (see `_trace`), at
    `layers` layers where given."""
    cfg = ARCHS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, unit=())
    params = build_model(cfg, remat=False, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    prefill, _, _ = make_serve_fns(cfg, ServeConfig(max_len=96), device)
    prefill(params, {"tokens": tokens})
    out = _trace(lambda: prefill(params, {"tokens": tokens}), calls,
                 torch.device(device).type == "cuda", "prefill")
    return dict(out, what="prefill", arch=arch, batch=batch, seq=seq,
                layers=cfg.n_layers)


def profile_train(arch: str, batch: int, seq: int, calls: int = 3,
                  device: str = "cuda", use_reduced: bool = False) -> Dict:
    """Trace `calls` warm train steps (bf16 weights from seed 0, AdamW,
    remat on, the data pipeline's batch; see `_trace`).  The state is
    not carried from step to step, so every traced step is the same."""
    cfg = ARCHS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    step_fn, init_fn = make_train_step(cfg, TrainConfig(remat=True), device)
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    dcfg = DataConfig(seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in batch_for_model(cfg, dcfg, 0).items()}
    for _ in range(2):
        step_fn(state, data)
    out = _trace(lambda: step_fn(state, data), calls,
                 torch.device(device).type == "cuda", "step")
    return dict(out, what="step", arch=arch, batch=batch, seq=seq)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (prefill)")
    ap.add_argument("--train", action="store_true",
                    help="trace train steps instead of prefills")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.train:
        res = profile_train(args.arch, args.batch, args.seq, args.calls,
                            args.device, args.reduced)
    else:
        res = profile_prefill(args.arch, args.batch, args.seq, args.calls,
                              args.device, args.reduced, args.layers)
    what = res["what"]
    log.info(f"{res['arch']} {what} {res['batch']} x {res['seq']} on "
             f"{res['device']}: host {res[f'host_ms_per_{what}']:.3f} ms a "
             f"{what}")
    if "device_idle_share" in res:
        log.info(f"  device busy {res[f'device_busy_ms_per_{what}']:.3f} ms "
                 f"of a {res[f'device_window_ms_per_{what}']:.3f} ms window "
                 f"a {what} (idle share {res['device_idle_share']:.3f}); "
                 f"plain attention backward "
                 f"{res[f'plain_attention_bwd_ms_per_{what}']:.3f} ms "
                 f"({res['plain_attention_bwd_share_of_busy']:.3f} of busy)")
    for name, us in list(res["kernels_us"].items())[:args.top]:
        log.info(f"  {us / res['calls'] / _US_PER_MS:9.4f} ms a {what}  "
                 f"{name[:110]}")
    return res


if __name__ == "__main__":
    main()
