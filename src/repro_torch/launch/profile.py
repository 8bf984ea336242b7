"""Device profile of one serving prefill: where the card's time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch smollm-360m \
        --batch 4 --seq 1024

Full width unless `--reduced`, random bf16 weights from seed 0, as
`chip_smoke.py` serves them.  `torch.profiler` traces `--calls` warm
prefills and reports the device time of each kernel (summed over the
calls, largest first), the device's busy time against the wall time of
the traced window (its idle share), and the host's wall time per
prefill.  On the CPU it reports the CPU's operators and no device
numbers.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS, reduced
from ..models import build_model
from ..runtime.serve import ServeConfig, make_serve_fns

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


def profile_prefill(arch: str, batch: int, seq: int, calls: int = 3,
                    device: str = "cuda", use_reduced: bool = False) -> Dict:
    """Trace `calls` warm prefills; returns the kernels' device times (us,
    summed over the calls), the device's busy and idle share of the traced
    window, and the host's ms per prefill."""
    cfg = ARCHS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    params = build_model(cfg, remat=False, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    prefill, _, _ = make_serve_fns(cfg, ServeConfig(max_len=96), device)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    prefill(params, {"tokens": tokens})
    sync()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            prefill(params, {"tokens": tokens})
        sync()
        wall_s = time.perf_counter() - t0

    kind = torch.autograd.DeviceType.CUDA if on_card else \
        torch.autograd.DeviceType.CPU
    spans, per_name = [], {}
    for evt in prof.events():
        if evt.device_type != kind or (not on_card and evt.cpu_parent):
            continue                  # on the CPU: top-level operators only
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        per_name[evt.name] = per_name.get(evt.name, 0.0) + end - start
    out = {"arch": arch, "batch": batch, "seq": seq, "calls": calls,
           "host_ms_per_prefill": wall_s / calls * _MS_PER_S,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "kernels_us": dict(sorted(per_name.items(),
                                     key=lambda kv: -kv[1]))}
    if on_card and spans:
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _busy_us(spans)
        out.update(device_busy_ms_per_prefill=busy / calls / _US_PER_MS,
                   device_window_ms_per_prefill=window / calls / _US_PER_MS,
                   device_idle_share=1.0 - busy / window if window else 0.0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    res = profile_prefill(args.arch, args.batch, args.seq, args.calls,
                          args.device, args.reduced)
    log.info(f"{res['arch']} prefill {res['batch']} x {res['seq']} on "
             f"{res['device']}: host {res['host_ms_per_prefill']:.3f} ms a "
             f"prefill")
    if "device_busy_ms_per_prefill" in res:
        log.info(f"  device busy {res['device_busy_ms_per_prefill']:.3f} ms "
                 f"of a {res['device_window_ms_per_prefill']:.3f} ms window "
                 f"a prefill (idle share {res['device_idle_share']:.3f})")
    for name, us in list(res["kernels_us"].items())[:args.top]:
        log.info(f"  {us / res['calls'] / _US_PER_MS:9.4f} ms a prefill  "
                 f"{name[:110]}")
    return res


if __name__ == "__main__":
    main()
