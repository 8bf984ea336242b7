#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which fails the run (exit code 1, no result line):
1. device: require CUDA; print the card's name and power limit; build
   every kernel of the port from `src/repro_torch/kernels/csrc/`, one
   nvcc per source started together, and print the ptxas lines;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the serving shapes and at ragged, windowed, softcapped and
   non-causal ones, with the tolerance stated; then kernel, plain
   version and one PyTorch library call timed with CUDA events;
3. main path: full-width smollm-360m (bf16, random weights from a seed)
   through `make_serve_fns(...).prefill` on 4 x 1024 tokens, then the
   continuous-batching loop (8 requests, 4 slots, 16 new tokens), with
   the launch counters reset just before and read just after; the
   prefill logits are held against the same prefill with the plain
   attention and norms;
4. reference checks on small inputs: the kernel path on the card against
   the plain path on the CPU (float32), and token-by-token decode against
   the full forward (the repository's decode-vs-forward invariant).

The line before the last is a JSON object of the kernels' numbers; the
last is {"ok": true, "device": {...}}.
"""

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FA_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
RN_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
# Full-width prefill, kernels vs plain attention and norms, both bf16:
# the plain path rounds scores and probabilities to bf16 where the kernel
# keeps fp32, a difference of about one bf16 ulp per layer that 32 layers
# carry to logits of order 1-4; bound 0.25 (the reference's 2-layer bf16
# tolerance of 0.15 plus headroom for 16 times the depth).
PREFILL_TOL = 0.25
DECODE_TOL = 0.15       # tests/test_models.py, decode vs forward in bf16
PARITY_TOL = 1e-4       # float32 card vs CPU, as tests/test_torch_model.py
SLEEP_CYCLES = 100_000_000   # ~50 ms at the H100's clocks


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Device ms per call: `iters` calls between two CUDA events, queued
    while the card sleeps, so the host's launch cost stays out of the
    device time; also returns the host's microseconds per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def close(torch, got, want, atol, rtol):
    return bool(torch.allclose(got.float(), want.float(), atol=atol,
                               rtol=rtol))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) + shift).to(
            dtype)

    def plain_fa(q, k, v, qp, kp, window, softcap, causal):
        D = q.shape[-1]
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), qp, kp, scale=D ** -0.5,
                             causal=causal, window=window,
                             softcap=softcap).transpose(1, 2)

    print("phase 2: kernels against their plain versions", flush=True)
    fa_cases = [  # B, S, T, H, K, D, causal, window, softcap
        (4, 1024, 1024, 15, 5, 64, True, None, None),   # smollm prefill
        (1, 128, 128, 4, 2, 64, True, None, None),
        (2, 256, 256, 8, 4, 64, True, None, 50.0),
        (1, 200, 200, 4, 4, 48, True, 128, None),
        (1, 128, 384, 4, 2, 64, True, None, None),
        (1, 128, 128, 4, 1, 64, False, None, None),
        (1, 130, 130, 2, 2, 32, True, None, None),
        (1, 100, 100, 2, 2, 32, False, None, None),     # ragged non-causal
        (2, 70, 70, 4, 2, 16, True, 32, None),
        (1, 96, 96, 8, 4, 256, True, 64, 50.0),
    ]
    fa_err = None
    for dname, dtype in dts.items():
        atol, rtol = FA_TOL[dname]
        for B, S, T, H, K, D, causal, window, softcap in fa_cases:
            q = randn((B, S, H, D), dtype)
            k = randn((B, T, K, D), dtype)
            v = randn((B, T, K, D), dtype, 3.0)
            qp = torch.arange(T - S, T, dtype=torch.int32, device=dev)
            kp = torch.arange(T, dtype=torch.int32, device=dev)
            out = flash_attention(q, k, v, qp, kp, window=window,
                                  softcap=softcap, causal=causal)
            ref = plain_fa(q, k, v, qp, kp, window, softcap, causal)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(close(torch, out, ref, atol, rtol),
                  f"flash_attention {dname} B={B} S={S} T={T} H={H} K={K} "
                  f"D={D} causal={causal} window={window} "
                  f"softcap={softcap}: max err {err:.3g} "
                  f"(atol {atol}, rtol {rtol})")
            if fa_err is None:
                fa_err = err          # the prefill shape in fp32 ...
            if dname == "bfloat16" and (B, S) == (4, 1024):
                fa_err = err          # ... replaced by the working dtype

    rn_cases = [(4096, 960), (4, 960), (257, 384), (33, 100), (2, 64, 128),
                (1, 1, 256)]
    rn_err = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for shape in rn_cases:
            x = randn(shape, dtype)
            s = (torch.linspace(0.5, 1.5, shape[-1], device=dev)).to(dtype)
            out = rmsnorm(x, s)
            ref = rmsnorm_ref(x, s)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(close(torch, out, ref, atol, rtol),
                  f"rmsnorm {dname} {shape}: max err {err:.3g} "
                  f"(atol {atol}, rtol {rtol})")
            if dname == "bfloat16" and shape == (4096, 960):
                rn_err = err

    print("phase 2b: timing at the main path's shapes (CUDA events, warm "
          "L2, after 3 warm-up calls; host us = launch cost per call)",
          flush=True)
    B, S, H, K, D = 4, 1024, 15, 5, 64
    q = randn((B, S, H, D), torch.bfloat16)
    k = randn((B, S, K, D), torch.bfloat16)
    v = randn((B, S, K, D), torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fa_ms, fa_host_us = cuda_ms(
        torch, lambda: flash_attention(q, k, v, pos, pos), 20)
    fa_plain_ms, _ = cuda_ms(torch, lambda: plain_fa(q, k, v, pos, pos, None,
                                                     None, True), 10)
    fa_lib_ms, _ = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    pairs = S * (S + 1) // 2                  # causal (query, key) pairs
    fa_flops = 4 * B * H * D * pairs          # QK^T and PV, 2 flops a MAC
    fa_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * 4 * S
    fa_bound = max(fa_flops / PEAK_BF16_FLOPS,
                   fa_bytes / PEAK_BYTES_PER_S) * 1e3
    fa_by = ("operations" if fa_flops / PEAK_BF16_FLOPS
             >= fa_bytes / PEAK_BYTES_PER_S else "bytes")

    x = randn((4096, 960), torch.bfloat16)
    s = torch.linspace(0.5, 1.5, 960, device=dev).to(torch.bfloat16)
    rn_ms, rn_host_us = cuda_ms(torch, lambda: rmsnorm(x, s), 200)
    rn_plain_ms, _ = cuda_ms(torch, lambda: rmsnorm_ref(x, s), 200)
    rn_lib_ms, _ = cuda_ms(torch, lambda: F.rms_norm(x, (960,), s, 1e-6),
                           200)
    x4 = randn((4, 960), torch.bfloat16)
    rn_decode_ms, _ = cuda_ms(torch, lambda: rmsnorm(x4, s), 500)
    rn_bytes = 2 * (2 * x.numel() + s.numel())
    rn_flops = 4 * x.numel()
    rn_bound = max(rn_flops / PEAK_FP32_FLOPS,
                   rn_bytes / PEAK_BYTES_PER_S) * 1e3
    rn_by = ("operations" if rn_flops / PEAK_FP32_FLOPS
             >= rn_bytes / PEAK_BYTES_PER_S else "bytes")
    print(f"  flash_attention {fa_ms:.4f} ms (plain {fa_plain_ms:.4f}, sdpa "
          f"{fa_lib_ms:.4f}, bound {fa_bound:.4f} by {fa_by}); rmsnorm "
          f"{rn_ms:.4f} ms (plain {rn_plain_ms:.4f}, F.rms_norm "
          f"{rn_lib_ms:.4f}, bound {rn_bound:.4f} by {rn_by}); rmsnorm at "
          f"4 rows {rn_decode_ms:.4f} ms; host us per call: flash "
          f"{fa_host_us:.1f}, rmsnorm {rn_host_us:.1f}", flush=True)
    return {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces":
                "src/repro/kernels/flash_attention/flash_attention.py:97",
            "shape": "q (4,1024,15,64) k/v (4,1024,5,64) bf16 causal",
            "max_abs_err": fa_err, "tolerance": FA_TOL["bfloat16"],
            "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound,
            "bound_by": fa_by, "library_ms": fa_lib_ms,
            "host_us": fa_host_us, "flops": fa_flops, "bytes": fa_bytes},
        "rmsnorm": {
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:32",
            "shape": "x (4096,960) bf16", "max_abs_err": rn_err,
            "tolerance": RN_TOL["bfloat16"], "ms": rn_ms,
            "plain_ms": rn_plain_ms, "bound_ms": rn_bound,
            "bound_by": rn_by, "library_ms": rn_lib_ms,
            "decode_rows_ms": rn_decode_ms, "host_us": rn_host_us,
            "flops": rn_flops, "bytes": rn_bytes},
    }


def phase_main_path(torch, dev):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.models import build_model, param_count
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns

    print("phase 3: main path, full-width smollm-360m", flush=True)
    cfg = ARCHS["smollm-360m"]
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, remat=False, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(params)
    print(f"  {n_params} parameters", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    scfg = ServeConfig(max_len=96)
    prefill, _, _ = make_serve_fns(cfg, scfg, dev)

    flash_attention.launches = 0
    rmsnorm.launches = 0
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    prefill_counts = (flash_attention.launches, rmsnorm.launches)
    queue = make_requests(8, cfg.vocab_size)
    results, stats = serve_loop(params, cfg, scfg, queue, slots=4,
                                max_new=16, device=dev)
    torch.cuda.synchronize()
    counts = {"flash_attention": flash_attention.launches,
              "rmsnorm": rmsnorm.launches}

    check(prefill_counts == (32, 65),
          f"prefill launched flash_attention {prefill_counts[0]} times "
          f"(32 layers) and rmsnorm {prefill_counts[1]} times (2 x 32 + 1)")
    check(logits.shape == (4, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} finite")
    steps = stats["steps"]
    check(counts["rmsnorm"] - 65 == 65 * steps
          and counts["flash_attention"] == 32,
          f"decode loop: {steps} steps launched rmsnorm "
          f"{counts['rmsnorm'] - 65} times (65 a step) and no attention "
          f"kernel (decode attention is the plain path)")
    check(stats["served"] == 8 and len(results) == 8
          and all(len(r) == 16 for r in results.values()),
          "all 8 requests served with 16 new tokens each")
    check(all(0 <= t < cfg.vocab_size for r in results.values() for t in r),
          "every token in the vocabulary")
    peak_bytes = torch.cuda.max_memory_allocated()

    naive_prefill, _, _ = make_serve_fns(
        cfg, ServeConfig(max_len=96, attention_impl="naive"), dev)
    plain = naive_prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    err = max_err(logits, plain)
    check(err <= PREFILL_TOL,
          f"prefill logits, kernels vs plain path: max diff {err:.4g} "
          f"(tol {PREFILL_TOL}; logits max |x| "
          f"{float(plain.abs().max()):.3g}); argmax agrees on "
          f"{int((logits.argmax(-1) == plain.argmax(-1)).sum())}/4")

    prefill_ms, _ = cuda_ms(
        torch, lambda: prefill(params, {"tokens": tokens}), 5)
    plain_prefill_ms, _ = cuda_ms(
        torch, lambda: naive_prefill(params, {"tokens": tokens}), 5)
    return {"prefill_ms": prefill_ms, "prefill_first_s": prefill_first_s,
            "plain_prefill_ms": plain_prefill_ms,
            "prefill_max_diff_vs_plain": err,
            "decode_tok_per_s": stats["tok_per_s"],
            "decode_steps": steps, "decode_wall_s": stats["wall_s"],
            "peak_memory_bytes": peak_bytes, "params": n_params}, counts


def phase_reference_checks(torch, dev):
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model

    print("phase 4: reference checks on small inputs", flush=True)
    for arch in ("smollm-360m", "gemma2-2b"):
        cfg = reduced(ARCHS[arch])
        cpu_params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(2))
        cpu_params = tree_map(lambda t: t.float(), cpu_params)
        card_params = tree_map(lambda t: t.to(dev), cpu_params)
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want, _ = build_model(cfg, impl="naive", remat=False,
                                  device="cpu").apply(cpu_params,
                                                      {"tokens": toks})
            got, _ = build_model(cfg, impl="auto", remat=False,
                                 device=dev).apply(card_params,
                                                   {"tokens": toks.to(dev)})
        err = max_err(got.cpu(), want)
        check(err <= PARITY_TOL,
              f"reduced {arch} float32: kernel path on the card vs plain "
              f"path on the CPU, max diff {err:.3g} (tol {PARITY_TOL})")

    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]),
                              sliding_window=8, unit=())
    model = build_model(cfg, impl="auto", remat=False, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(4))
    toks = torch.randint(0, cfg.vocab_size, (1, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.init_cache(1, 21)
        errs = []
        for t in range(20):
            lg, cache = model.decode(params, cache, toks[:, t:t + 1], t)
            errs.append(max_err(lg[:, 0], full[:, t]))
    check(max(errs) <= DECODE_TOL,
          f"reduced smollm (window 8, ring wraps): decode vs forward on the "
          f"card, max diff {max(errs):.3g} (tol {DECODE_TOL})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import KERNELS, _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not next to this "
              f"script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 1: device {kind} ({card}), "
          f"{torch.cuda.device_count()} visible", flush=True)
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    print(f"  built {', '.join(KERNELS)} in {build_s:.1f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                print(f"  [{name}] {line.strip()}")

    kernels = phase_kernels(torch, dev)
    metrics, counts = phase_main_path(torch, dev)
    phase_reference_checks(torch, dev)

    for name, n in counts.items():
        kernels[name]["launches"] = n
    metrics.update(card=card, build_s=build_s)
    print(json.dumps({"metrics": metrics}))
    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
