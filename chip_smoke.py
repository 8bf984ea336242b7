#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which fails the run (exit code 1, no result line):
1. device: require CUDA; print the card's name and power limit; build
   every kernel of the port from `src/repro_torch/kernels/csrc/`, one
   nvcc per source started together, and print the ptxas lines;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the serving shapes (flash attention also at D = 112 and 128 and as
   seamless's non-causal encoder and S != T cross-attention) and at
   ragged, windowed, softcapped, non-causal and steep-decay ones, and SSD
   in the models' strided layout, with the tolerance stated (every bf16
   SSD call must take the tensor-core kernel); then kernel, plain version
   and, where one exists, one PyTorch library call timed with CUDA events
   (SSD also in the strided layout, RMSNorm at every model's prefill
   width, flash attention at every model's prefill shape); and flash
   attention at a context-parallel rank's shape (smollm's heads, a rank's
   256 queries at each quarter of 1024 positions against all 1024 keys,
   causal and with an 8-token window, float32 and bf16) against its
   plain version, timed beside `scaled_dot_product_attention` given the
   same mask (the four-card `gpu` test in `tests/test_torch_cuda.py`
   runs the context-parallel train step itself); the SSD backward kernel
   (`ssd_bwd`) against autograd through `ssd_plain` on the same dy, and
   in bf16 (the tensor-core route, fed the states its forward kept) also
   against its rounding model `ssd_bwd_tc_plain`, at mamba2-130m's and
   zamba2-2.7b's train shapes, the small, ragged and steep cases and the
   models' strided layout, float32 and bf16, then timed at both train
   shapes, whole and pass by pass (torch.profiler), beside that autograd
   backward, its bound (`ssd_bwd_cost`) and the forward's passes that a
   backward recomputing the states would repeat; and the split-row
   RMSNorm's backward pair
   against autograd through `rmsnorm_split_ref` over simulated ranks;
   2c. the MoE grouped GEMM, a library call (`torch._grouped_mm`), against
   its per-expert loop at mixtral's and kimi's prefill shapes, timed
   beside its bound;
3. main paths, each with the launch counters reset just before and read
   just after (every flash-attention and SSD launch must be one of the
   bf16 tensor-core kernels), through `make_serve_fns(...).prefill` and then the
   continuous-batching loop, random bf16 weights from a seed, the
   prefill logits held against the same prefill with the plain routes:
   3.  full-width smollm-360m: prefill 4 x 1024, 8 requests on 4 slots;
   3b. full-width mamba2-130m: prefill 4 x 1024, 8 requests on 4 slots;
   3c. full-width zamba2-2.7b: prefill 2 x 1024, 4 requests on 2 slots;
   3d. mixtral-8x22b at published widths, depth 56 -> 4: prefill 4 x
       1024, 8 requests on 4 slots; then a profile of its prefill;
   3e. kimi-k2 at published widths, depth 61 -> 1: prefill 2 x 1024
       (flash attention at D = 112), 4 requests on 2 slots;
   3f. full-width pixtral-12b: prefill of 2 x 1024 bf16 embeddings from a
       seed, 4 requests on 2 slots (on tokens);
   3g. full-width seamless-m4t-large-v2: prefill 4 x (1000 source frames
       + 1024 tokens), `prefill_cross` and 16 greedy decode steps, then 8
       requests on 4 slots;
   the MoE phases hold the rows whose experts agree in both routes, and
   count the tokens whose experts differ;
4. reference checks on small inputs: the kernel path on the card against
   the plain path on the CPU (float32; seamless in bf16), and
   token-by-token decode against the full forward (the repository's
   decode-vs-forward invariant); then the process group starts (one
   rank: NCCL for CUDA tensors, gloo for CPU ones; an all-reduce on the
   card proves NCCL up) and the expert-parallel MoE block at capacity
   1.25 on the card's host mesh is held to the same block on the CPU's:
   the same rows dropped, values within 1e-4 (float32);
5. training, full-width smollm-360m (bf16, AdamW, remat, 8 x 1024 tokens
   from the data pipeline), through `make_train_step`, the launcher's
   `train_loop` and the checkpointer: exact launch counts of one step
   (remat's recompute included), one step with the kernels against the
   plain path in bf16 and in float32, 20 steps with the CE falling and no
   recovery, a checkpoint restored into a fresh state whose next step
   matches the uninterrupted run bit for bit, and a profile of 3 steps
   (`launch/profile.py`: the plain attention backward's share).
   Phase 2 also holds the RMSNorm backward kernel to `rmsnorm_bwd_ref`,
   and phase 2b times it; and the split-row RMSNorm entry
   (`rmsnorm_split`, the split-heads Mamba2 mixer's gated norm on a
   'model' of several ranks) to its plain version and to the whole-row
   norm, one rank's columns fed with the rows' other squares summed on
   the card, and times it at zamba2's pod-rank (2048 x 320 of 5120) and
   four-card (2048 x 1280) shapes beside its bound and F.rms_norm over
   the whole row; its launches on the main paths (0: on one card no
   path splits heads) are on the kernels line.  The gated norm (the
   Mamba2 mixer's y * silu(z) folded into the RMSNorm kernels:
   `rmsnorm_gated`, `rmsnorm_split(..., gate=z)`, their backward
   kernels) is held to its plain versions, whole and split, forward and
   backward, float32 and bf16, vector and scalar kernels, z a strided
   column view, dscale's bits equal twice (`phase_gated_norm`), and
   timed at mamba2-130m's and zamba2-2.7b's train rows and the two split
   shapes beside its bound, its plain version and the unfused sequence
   it replaces; its launches (one a mixer a prefill and a decode step,
   two a train step, one backward) are checked on phases 3b, 3c and 10
   and printed on the kernels line as `rmsnorm_gated`;
6. distribution, on the 1-rank group's host mesh (1, 1), as the
   launchers run it (`--mesh host`, under the default ParallelContext):
   6a. mixtral-8x22b at published widths, depth 56 -> 4, launch counters
       set to 0 just before and read just after: prefill 4 x 1024
       through `moe_block_expert_parallel` (4 calls), then 8 requests on
       4 slots through `serve_loop` (and again, warm); the rows each
       layer's capacity buckets drop in prefill and at each decode step;
       the prefill at capacity factor 8 (nothing drops) against the
       dropless path; the bucketed expert products timed at the
       prefill's shape;
   6b. smollm-360m at full width trained 3 steps through `train_loop` on
       the mesh, the state placed by `state_shardings`, against the
       meshless step (and whether they are bit-equal); 4 more steps of
       each timed in turns; a checkpoint of the sharded state restored
       with `shardings=` bit for bit;
7. the roofline of the paths this script times: the port's count
   (`launch/roofline.py: count`, under fake tensors on the CPU, plain
   routes) of phase 3's smollm-360m prefill, phase 5's train step and
   phase 3d's mixtral prefill, each printed with its FLOPs, its unfused
   and floor bytes, the terms, which binds, the measured median and the
   roofline share; the count of the train step held to FlopCounterMode
   around one real plain-route step on the card (equal FLOPs) and to the
   real state's and batch's bytes (equal), and MemTracker's peak printed
   beside phase 5's `max_memory_allocated`.  Phase 5 prints its MFU from
   the count beside the hand formula;
8. the mesh's sharded paths, on the 1-rank group's host mesh (1, 1),
   where every 'model' shard is the whole weight, so the tensor-parallel
   products do not run here (the four-card `gpu` test in
   `tests/test_torch_cuda.py` runs them): full-width smollm-360m (bf16,
   AdamW, remat, 8 x 1024 tokens) trained one step through the mesh's
   train step (`mesh_apply`'s data-axis gathers, the cross entropy's
   shard-local form) and 8 requests on 4 slots served
   through the sharded serving functions (`make_serve_fns(..., mesh=)`:
   the cache placed by `cache_shardings`, the slots' rows, the next
   token compared across 'model'), each with the launch counters set to
   0 just before and read just after, each held bit-equal to the
   meshless path and timed beside it; FlopCounterMode around one real
   plain-route step on the mesh equal to phase 7's fake-tensor count;
   the sequence-split decode attention (`decode_partial` on 4 slices of
   a full-width 4 x 1024 cache, `combine_partials`) held to the
   whole-cache decode attention in float32 and bf16 and timed beside
   it, and `decode_attention`'s split branch on the mesh (its partials
   gathered over 'model' by NCCL) held to its whole-cache branch; each
   path's `torch.cuda.max_memory_allocated` over what it found allocated
   printed beside the meshless path's (the train step and the serve
   loop run through the per-unit
   gather: each unit's weights gathered inside the remat boundary);
9. the per-unit gather through the mesh on the host mesh, each unit's
   shard the whole unit: mixtral-8x22b at published widths, depth 56 ->
   4, under the launcher's context (the expert stacks at the
   expert-parallel path's shard): prefill 4 x 1024 and 8 greedy decode
   steps; zamba2-2.7b's prefill 2 x 1024 (super-units gathered one at a
   time, the mixers' projections at their 'model' shard): each through
   `make_serve_fns(..., mesh=)` on the placed weights against the
   meshless functions on the same weights under the same mesh and
   context, logits and tokens bit-equal, the kernels' launches equal
   (zamba2's SSD launched, mixtral's expert-parallel block a layer),
   and `max_memory_allocated` of each beside the other;
10. training the SSM models on the card (bf16 weights from seed 0,
   AdamW, remat, tokens from the data pipeline, through
   `make_train_step` and the launcher's `train_loop`), the SSD scan
   differentiated by its backward kernel: full-width mamba2-130m (8 x
   1024) and zamba2-2.7b (2 x 1024), each with the exact launch counts of
   one step (the SSD forward twice and `ssd_bwd` once a mixer, every
   bf16 forward and SSD backward on a tensor-core kernel, the norms'
   forward and backward,
   zamba2's shared attention), one step against the plain routes in bf16
   (phase 5b's checks; the kernels' new weights held on the host) and in
   float32 (the loss and every leaf's gradient; mamba2's also against
   the plain routes in float64, and phase 5b's whole AdamW steps, as two
   float32 AdamW states of zamba2's 2.7e9 parameters do not fit one
   card), then steps through `train_loop`
   (mamba2 20, its CE falling; zamba2 5), each printed with its step
   time, tokens/s, peak `max_memory_allocated` and MFU (mamba2's from
   the count of the step, as phase 5);
11. the paper's analytic plane on the card (`repro_torch.launch
   .paper_plane.run`, no kernel of its own: tensor code on the trace's
   device): the 15 Table-1 traces and the 12 LLM traces built, then
   `sweep_all` (batched engine), the per-point loop engine on zfnet
   against the batched one, `network_sweep_all` (3 MACs x 4 channel
   plans) on the 15, `scaling_sweep` over the five `SCALING_GRIDS` (up
   to 16x16) at 96 Gb/s on the 15 and `balance` at 96 Gb/s with the
   ideal MAC on the 15, each held to the port's own CPU route of the
   same call within rtol 1e-9 (times also within 1e-12 of the wired base
   time) under the tie rule (a differing choice passes only where the
   CPU route's own value at the card's choice is within the tolerance
   of its best), and `sweep_all`'s summary to the paper's band (1.04 <=
   mean64 <= 1.12, 1.055 <= mean96 <= 1.145, max96 >= 1.15); printed:
   each call's wall times beside the card's name and power limit (trace
   building on the host apart from evaluation, first calls apart; the
   four sweeps 3 runs a route, card and CPU alternating, with the ratio
   of their medians), the device operations, busy time and idle share
   of one batched `evaluate` (the paper grid and the network grid on
   the largest paper trace, torch.profiler), the host syncs of one such
   `evaluate` and of a `sweep_all` of that trace (torch's sync debug
   mode), and whether the card's runs are bit-equal;
12. the event engine and the fault plane on the card (`repro_torch
   .launch.event_plane.run`, no kernel of its own: tensor code on the
   trace's device, per-packet online runs on the host): the 15 Table-1
   traces on the paper's 3x3 package, nothing cut; `policy_sweep_all`
   at 96 Gb/s with all four policies (each policy's injected mask too;
   adaptive and oracle at least the static grid's best less 1e-9,
   greedy at least 1), `fidelity_report` over the three link models
   (striped's worst error at most 1e-9), a faulted `PacketSim` on vgg
   under `default_scenario(k=1, fade_db=3.0)` plus link failures that
   kill cut 0 (striped and xy run every policy, the adaptive model
   refuses the faults, the wired-only run is infinite), and
   `resilience_sweep_all` on zfnet and smollm_360m:decode over
   `fig_resilience`'s grid (online-reshard never slower), each held to
   the port's own CPU route at rtol 1e-9 under the tie rule (a
   differing mask passes only where the CPU route's time under the
   card's mask is within the tolerance of its own); printed: each
   policy's mean speedup, the retained-speedup means, the wall times of
   `policy_sweep_all` and `fidelity_report` (3 runs a route, card and
   CPU alternating, with the ratio of their medians) beside the card's
   name and power limit, the device operations, busy time, idle share
   and host syncs of one planned `PacketSim.run("static")` on vgg, the
   host ms of one greedy online run, and the phase's wall time;
13. the observability and co-design planes on the card (`repro_torch
   .launch.obs_plane.run`, no kernel of its own: host Python around the
   analytic and event engines): a recorded greedy and a recorded static
   `PacketSim` run on smollm_360m:prefill at 96 Gb/s, 2 channels x 4
   reuse zones, held to the CPU route event by event (rtol 1e-9), the
   busy invariant at 1e-12 on each route, the attribution rows, the
   Chrome and npz exports read back, the critical path summing to the
   makespan at 1e-12; `validate` on zfnet at 0.75 and 1.25 x the
   wireless band within 10%; `whatif_guided` on zfnet, resnet50 and
   gnmt picking `sweep_all`'s best point with fewer points (tie rule);
   a profiled `sweep_all` of the 15 (coverage at least 0.90) and the
   host syncs of an unprofiled one of vgg, equal to phase 11's;
   `codesign` at
   `hetero_sweep`'s defaults on zfnet / big_little, lstm / compute_mem,
   gnmt / aimc_edge and googlenet / big_little, held to the CPU route
   (states equal or tied; the count of differing states printed);
   printed: the calls' wall times, each co-design cell's wall time on
   both routes, and the device operations, busy time, idle share, host
   ms and host syncs of one `PlacementProblem.evaluate`, beside the
   card's name and power limit.
14. the linter and the bench observatory on the card (`repro_torch
   .launch.observatory.run`, no kernel of its own: the profiled paper
   sweep and event run on the trace's device, the observatory and the
   linter stdlib on the host): the walkthrough run once on the card and
   once on the CPU, each into a temporary directory: `sweep_all` of
   zfnet, resnet50 and vgg and a recorded greedy `PacketSim` run of zfnet
   at 96 Gb/s under the phase profiler, held to the CPU route (the same
   phase names and call counts, coverage at least 0.90 on each route,
   `sweep_all`'s results and the run's events within rtol 1e-9 under the
   tie rule, each merged Chrome export read back with its "framework"
   process); the repository's committed bench ledger, read only, through
   the MAD drift detector and into the HTML report on both routes, the
   two documents byte-equal; then `python -m repro_torch.lint src` in a
   subprocess, which must exit 0 with 0 findings; printed: the ledger's
   entry and finding counts, the linter's files scanned and seconds, the
   wall times of both routes' halves beside the card's name and power
   limit, and the phase's own seconds.

The line before the last is a JSON object of the kernels' numbers; the
last is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import pathlib
import re
import statistics
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
# SSD kernel vs ssd_plain: float32 sums of up to 1024 terms in 64-row tiles
# against the plain version's chunks, outputs up to ~40; bfloat16, both
# round an fp32 result once, so one output ulp (2^-7 relative) apart
SSD_TOL = {"float32": (5e-4, 1e-5), "bfloat16": (2e-2, 2.0 ** -7)}
# SSD backward kernel vs autograd through ssd_plain, the same dy: float32
# as a share of each gradient's largest (fp32 sums in another order, dA
# and ddt over whole chunks: 8.3e-6 seen on an H100 80GB HBM3 at
# mamba2-130m's train shape); bfloat16 absolute plus relative, both round
# an fp32 result once (tests/test_torch_ssd.py's KERNEL_TOL); the bf16
# tensor-core route is held to its model ssd_bwd_tc_plain at the same
# bound for dx, dB and dC, as they differ before that rounding only by
# the order of fp32 sums and exp approximations; its fp32 outputs ddt
# and dA, which no bf16 rounding blurs, at SSD_BWD_TC_FP32_TOL of each
# one's largest (3.0e-5 seen on an H100 80GB HBM3 at zamba2-2.7b's
# strided layout)
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": (2e-2, 2.0 ** -7)}
SSD_BWD_TC_FP32_TOL = 1e-4
# Full-width prefill, kernels vs plain attention and norms, both bf16:
# the plain path rounds scores and probabilities to bf16 where the kernel
# keeps fp32, a difference of about one bf16 ulp per layer that 32 layers
# carry to logits of order 1-4; bound 0.25 (the reference's 2-layer bf16
# tolerance of 0.15 plus headroom for 16 times the depth).  The same bound
# holds the MoE models (on the rows whose experts agree in both routes),
# pixtral and seamless: 0.078-0.117 on an H100 80GB HBM3.
PREFILL_TOL = 0.25
# mamba2-130m and zamba2-2.7b in bf16, kernel routes vs plain routes: the
# plain route rounds the gate, x*dt and the chunk states to bf16 (as the
# reference's ssd_scan does), the kernel keeps fp32, and 24-54 random-init
# layers amplify the difference.  Measured on an H100: the same weights in
# float32 put each bf16 route 0.62 (mamba2) and 1.1-1.7 (zamba2) away from
# the fp32 logits, and the two bf16 routes 0.54 and 1.62 apart; bounds at
# about twice that.  The float32 check below is the tight one.
MAMBA_PREFILL_TOL = 1.0
ZAMBA_PREFILL_TOL = 3.0
# The same prefill with the weights cast to float32, kernel routes vs plain
# routes: the same arithmetic in fp32, sums in another order, carried
# through 24-54 layers (at most 1.5e-3 on an H100)
FULL_FP32_TOL = 1e-2
DECODE_TOL = 0.15       # tests/test_models.py, decode vs forward in bf16
# One full-width train step (smollm-360m, 8 x 1024, bf16), kernels vs plain
# path: the two round attention at different points (online softmax in the
# kernel, the full bf16 row in the plain path), and their backward passes
# differ (the fp32 VJP of attention_ref against autograd of the bf16 plain
# attention), through 32 layers; the mean CE over 8192 tokens differs by
# 3e-4 on an H100 80GB HBM3.
TRAIN_LOSS_TOL = 0.02
# The same step with float32 weights: the same arithmetic in fp32, sums in
# another order, 32 layers: 8.4e-8 relative on the same card (2 layers
# agree to 1.5e-7 on the CPU, JAX vs port)
TRAIN_FP32_LOSS_RTOL = 1e-5
# float32 first moments (0.1 x the clipped gradient), per leaf, as a share of
# the leaf's largest: 1.7e-6 on the same card (2 reduced layers: 1.5e-5 on
# the CPU, JAX vs port)
TRAIN_FP32_GRAD_TOL = 1e-4
# The same for the SSM models (phase 10): their float32 gradient at full
# width is ill-conditioned, so that fp32 arithmetic in another order moves
# it by parts in a thousand.  Held against the plain routes in float64
# (`float64_loss_and_grad`), full-width mamba2-130m's float32 gradient
# reads 2.57e-3 of a leaf's largest on the kernel routes and 2.92e-3 on
# the plain routes, the loss 5.5e-8 and 2.9e-8 (on an H100 80GB HBM3 at
# 700 W); two plain routes that differ only in the scan's chunk (64, 256)
# are 3.56e-3 apart, the kernel and plain routes 4.24e-3 (zamba2-2.7b:
# 2.47e-3 and 2.95e-3).  The bound is about 1.4 times the larger reading;
# two float32 routes are held to twice it.
SSM_TRAIN_FP32_GRAD_TOL = 4e-3
# float32 updated weights where the first moment's sign is settled: AdamW's
# first step moves each by about lr0 * sign(g) (5e-4 here), so gradients
# 1e-6 apart move the weights by ~1e-10 apart, plus fp32 rounding (~1e-7)
TRAIN_FP32_PARAM_TOL = 1e-6
TRAIN_STEPS = 20
# zamba2-2.7b's steps through the launcher's loop (phase 10): enough for a
# median step time; its CE is only held finite
ZAMBA_TRAIN_STEPS = 5
# the CE of random-init smollm-360m on the pipeline's Zipf-bigram tokens
# starts near log(49152) = 10.8, is 9.6 after one step and about 6.5 after
# 20 on an H100 80GB HBM3
TRAIN_CE_DROP = 1.0
PARITY_TOL = 1e-4       # float32 card vs CPU, as tests/test_torch_model.py
SLEEP_CYCLES = 100_000_000   # ~50 ms at the H100's clocks
# Flash attention at the prefill shapes of phases 3d-3g: (name, B, S, T, H,
# K, D, causal); seamless's 1000 source frames leave a partial key tile
FA_MODEL_CASES = [
    ("mixtral-8x22b", 4, 1024, 1024, 48, 8, 128, True),
    ("kimi-k2-1t-a32b", 2, 1024, 1024, 64, 8, 112, True),
    ("pixtral-12b", 2, 1024, 1024, 32, 8, 128, True),
    ("seamless encoder", 4, 1000, 1000, 16, 16, 64, False),
    ("seamless cross", 4, 1024, 1000, 16, 16, 64, False),
]
# The MoE block's grouped GEMM (torch._grouped_mm, a library call) against
# its per-expert loop: (name, rows, experts, d, f, skewed); the gate/up
# product of a prefill, mixtral 4 x 1024 tokens top 2, kimi 2 x 1024 top 8
# with a skewed draw of experts (uneven and empty groups).  Tolerances as
# the kernels': both round an fp32 sum to the output dtype.
GMM_CASES = [("mixtral-8x22b", 8192, 8, 6144, 16384, False),
             ("kimi-k2-1t-a32b", 16384, 384, 7168, 2048, True)]
GMM_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}


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


def ssd_cost(b, L, H, P, N, chunk=256):
    """(flops, bytes, bound ms, what bounds it) of the SSD scan in bf16.
    Bytes: each input read once (x, B, C bf16; dt, A fp32), y written
    once.  Operations as the TPU kernel counts them, full Q x Q blocks at
    its chunk Q, per (batch row, chunk): C.B^T, the gated product, the
    carried state's term and the state update."""
    flops = (b * (L // chunk) * 2
             * (chunk * chunk * N + chunk * chunk * H * P
                + 2 * chunk * H * P * N))
    nbytes = 2 * 2 * b * L * H * P + 4 * b * L * H + 4 * H + 2 * 2 * b * L * N
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ssd_bwd_cost(b, L, H, P, N, chunk=128):
    """(flops, bytes, bound ms, what bounds it) of the SSD backward on bf16
    x, B, C and dy, the VJP's own work.  Bytes: each input read once (x,
    dy, B, C bf16; dt, A fp32), each output written once (dx, dB, dC bf16;
    ddt, dA fp32); the forward's states, which the bf16 kernel reads
    instead of recomputing them, are this design's and not counted.
    Operations by the backward's formulas, full Q x Q blocks at the bf16
    kernel's chunk Q, 128: per (batch row, chunk) C.B^T, and W B and W^T C
    (W enters them linearly, so summed over the heads first); per head
    dy.x^T, G^T dy and the four state products (dy's own state gradient,
    B dS^T, dy S and x dS)."""
    nc = -(-L // chunk)
    per_head = 2 * (2 * chunk * chunk * P + 4 * chunk * P * N)
    flops = b * nc * (3 * 2 * chunk * chunk * N + H * per_head)
    nbytes = (2 * 3 * b * L * H * P + 4 * 2 * b * L * H + 4 * 2 * H
              + 2 * 4 * b * L * N)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_ms(torch, fn, iters):
    """Device ms per call of each kernel `fn` launches, by name
    (torch.profiler over `iters` calls after a warm-up call); {} where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = re.sub(r"^void ", "", ev.key.split("(")[0])
            out[name] = out.get(name, 0.0) + ev.device_time_total / iters / 1e3
    return out


def rn_cost(rows, d):
    """(flops, bytes, bound ms, what bounds it) of bf16 RMSNorm: x read
    once, the output written once, the scale read once; 4 flops an
    element (square, sum, normalise, scale) at the fp32 rate."""
    flops = 4 * rows * d
    nbytes = 2 * (2 * rows * d + d)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rn_bwd_cost(rows, d):
    """(flops, bytes, bound ms, what bounds it) of the bf16 RMSNorm
    backward: x and g read once, dx written once, the scale read and
    dscale written once; ~10 flops an element (the two row sums, dx, the
    dscale term) at the fp32 rate."""
    flops = 10 * rows * d
    nbytes = 2 * (3 * rows * d + 2 * d)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def dscale_ok(torch, got, want, x, g, dtype):
    """dscale within float32 sums in another order (1e-5 of the sum of
    the terms' magnitudes |g x r|) plus, in bf16, one ulp of the result."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    mag = (gf * xf * r).abs().reshape(-1, x.shape[-1]).sum(0)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    return bool((err <= 1e-5 * mag + rtol * want.float().abs()).all())


def gated_cost(rows, d, bwd=False, split=False):
    """(flops, bytes, bound ms, what bounds it) of the bf16 gated norm
    (the norm of v = y * silu(z)): y and z read once and the output
    written once (backward: g read too, dy and dz written), the scale
    read (and dscale written) once; split, 4 bytes a row each way (the
    rows' local sums out, the summed ones back); ~10 fp32 operations an
    element forward (the gate's exp, division and products, the square,
    the scaling), ~25 backward (the gate's again, its derivative, dv, dy,
    dz, the dscale term)."""
    flops = (25 if bwd else 10) * rows * d
    nbytes = 2 * ((5 if bwd else 3) * rows * d + (2 if bwd else 1) * d) \
        + (8 * rows if split else 0)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


#: the gated norm's timed shapes: whole rows at mamba2-130m's and
#: zamba2-2.7b's train rows, z a column view of `in_proj`'s output
#: (rows, d, that output's width); split, a pod rank's 5 heads and a
#: four-card rank's 20 of zamba2's 80, z as the all-to-all delivers it
#: (the rank's [z, x, B, C, dt] columns, rows of 2 Hl P + 2 N + Hl)
GATED_WHOLE = ((8192, 1536, 3352), (2048, 5120, 10448))
GATED_SPLIT = ((2048, 320, 773), (2048, 1280, 2708))


def phase_gated_norm(torch, dev, randn):
    """Phases 2 and 2b for the gated norm (the Mamba2 mixer's
    y * silu(z) folded into the RMSNorm kernels): each entry, whole row
    and split over simulated ranks, forward and backward, float32 and
    bf16, against its plain version (`rmsnorm_gated_ref`,
    `rmsnorm_gated_bwd_ref`, `rmsnorm_split_ref(..., gate=z)`,
    `rmsnorm_split_gated_bwd_ref`) at RN_TOL, dscale within `dscale_ok`'s
    bound and the same bits twice; then each timed at the train shapes
    beside its bound, its plain version and the unfused sequence it
    replaces (the gate's four ops, then the ungated entry; backward,
    autograd through them).  No PyTorch call computes the gated norm, so
    no library time.  Returns the kernels line's entry."""
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_gated,
                                                 rmsnorm_gated_bwd,
                                                 rmsnorm_split,
                                                 rmsnorm_split_gated_bwd)
    from repro_torch.kernels.rmsnorm.ref import (gate_ref,
                                                 rmsnorm_gated_bwd_ref,
                                                 rmsnorm_gated_ref,
                                                 rmsnorm_split_gated_bwd_ref,
                                                 rmsnorm_split_ref)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(shape, dtype, width=None, offset=0):
        """y, g and z, z a column view at `offset` of rows `width` wide
        (contiguous where width is None)."""
        y, g = randn(shape, dtype), randn(shape, dtype)
        if width is None:
            return y, (2.0 * randn(shape, torch.float32)).to(dtype), g
        wide = (2.0 * randn(shape[:-1] + (width,), torch.float32)).to(dtype)
        return y, wide[..., offset:offset + shape[-1]], g

    print("phase 2: the gated norm against its plain versions", flush=True)
    # mamba2's and zamba2's train rows and decode rows (z a column view of
    # in_proj's output), small, ragged, d not a multiple of 8 (bf16's
    # scalar kernels), z not 16-byte aligned (read by elements), rows
    # wider than the vector kernels take: (shape, z's width, its offset)
    cases = [((8192, 1536), 3352, 0), ((2048, 5120), 10448, 0),
             ((4, 1, 1536), 3352, 0), ((2, 1, 5120), 10448, 0),
             ((2, 64, 128), None, 0), ((33, 100), None, 0),
             ((257, 384), 800, 3), ((5, 20000), None, 0)]
    err_fwd = err_bwd = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for shape, width, offset in cases:
            y, z, g = inputs(shape, dtype, width, offset)
            s = (torch.linspace(0.5, 1.5, shape[-1], device=dev)).to(dtype)
            out = rmsnorm_gated(y, z, s)
            ref = rmsnorm_gated_ref(y, z, s)
            dy, dz, ds = rmsnorm_gated_bwd(y, z, g, s)
            rdy, rdz, rds = rmsnorm_gated_bwd_ref(y, z, g, s)
            again = rmsnorm_gated_bwd(y, z, g, s)
            torch.cuda.synchronize()
            errs = [max_err(out, ref), max_err(dy, rdy), max_err(dz, rdz)]
            check(close(torch, out, ref, atol, rtol)
                  and close(torch, dy, rdy, atol, rtol)
                  and close(torch, dz, rdz, atol, rtol)
                  and dscale_ok(torch, ds, rds, gate_ref(y, z), g, dtype)
                  and all(torch.equal(a, b) for a, b in zip(again,
                                                            (dy, dz, ds))),
                  f"rmsnorm_gated {dname} {shape} (z {'contiguous' if width is None else f'columns {offset}: of rows {width} wide'}): "
                  f"max err out {errs[0]:.3g}, dy {errs[1]:.3g}, dz "
                  f"{errs[2]:.3g} (atol {atol}, rtol {rtol}), dscale "
                  f"{max_err(ds, rds):.3g} (1e-5 of the terms' magnitudes "
                  f"+ one ulp); the same bits when repeated")
            if dname == "bfloat16" and shape == (8192, 1536):
                err_fwd, err_bwd = errs[0], max(errs[1:])

    # the split pair: one simulated rank's columns (z a column view of rows
    # twice as wide), `sum_rows` adding the other columns' squares of v and
    # dots; (rows, columns, whole width, first column)
    split_cases = [(2048, 320, 5120, 1600), (2048, 1280, 5120, 0),
                   (2, 320, 5120, 4800), (33, 100, 300, 100),
                   (257, 384, 1536, 384)]
    err_split = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for rows, d, whole, c0 in split_cases:
            yw, zw, gw = inputs((rows, whole), dtype, 2 * whole + 40, 0)
            sw = torch.linspace(0.5, 1.5, whole, device=dev).to(dtype)
            c = slice(c0, c0 + d)
            vw = gate_ref(yw, zw).float()
            sq = (vw * vw).sum(-1)
            other_sq = sq - (vw[:, c] * vw[:, c]).sum(-1)
            dots = (gw.float() * sw.float() * vw)
            other_dot = dots.sum(-1) - dots[:, c].sum(-1)

            def sum_rows(v, other=other_sq):
                return v + other

            def sum_dots(v, other=other_dot):
                return v + other

            y, z, g, s = yw[:, c], zw[:, c], gw[:, c].contiguous(), \
                sw[c].contiguous()
            out = rmsnorm_split(y, s, whole, sum_rows, gate=z)
            ref = rmsnorm_split_ref(y, s, whole, sum_rows, gate=z)
            whole_ref = rmsnorm_gated_ref(yw, zw, sw)[:, c]
            dy, dz, ds = rmsnorm_split_gated_bwd(y, z, g, s, sq, whole,
                                                 sum_dots)
            rdy, rdz, rds = rmsnorm_split_gated_bwd_ref(y, z, g, s, sq, whole,
                                                        sum_dots)
            again = rmsnorm_split_gated_bwd(y, z, g, s, sq, whole, sum_dots)
            torch.cuda.synchronize()
            mag = (g.float() * vw[:, c] * torch.rsqrt(
                sq / whole + 1e-6)[:, None]).abs().sum(0)
            ds_ok = bool(((ds.float() - rds.float()).abs()
                          <= 1e-5 * mag + rtol * rds.float().abs()).all())
            errs = [max_err(out, ref), max_err(out, whole_ref),
                    max_err(dy, rdy), max_err(dz, rdz)]
            check(close(torch, out, ref, atol, rtol)
                  and close(torch, out, whole_ref, atol, rtol)
                  and close(torch, dy, rdy, atol, rtol)
                  and close(torch, dz, rdz, atol, rtol) and ds_ok
                  and all(torch.equal(a, b) for a, b in zip(again,
                                                            (dy, dz, ds))),
                  f"rmsnorm_split gated {dname} columns {c0}:{c0 + d} of "
                  f"{rows} rows x {whole}: max err out {errs[0]:.3g} "
                  f"against its plain version, {errs[1]:.3g} against the "
                  f"whole row's gated norm, dy {errs[2]:.3g}, dz "
                  f"{errs[3]:.3g} (atol {atol}, rtol {rtol}), dscale "
                  f"{max_err(ds, rds):.3g} (1e-5 of the terms' magnitudes "
                  f"+ {rtol} relative); the same bits when repeated")
            if dname == "bfloat16" and (rows, d) == (2048, 320):
                err_split = max(errs)

    print("phase 2b: the gated norm timed (CUDA events, warm L2, bf16; "
          "unfused: the gate's ops, then the ungated entry)", flush=True)
    bf = torch.bfloat16

    def timed(fwd, fwd_plain, fwd_unfused, bwd, bwd_two, bwd_plain, leaves,
              loss):
        """Device ms of the kernels, the plain versions and the unfused
        sequences (backward: autograd through them, the graph kept), and
        of the backward with dscale's sum in a launch of its own
        (`bwd_two`: the same blocks and bits, the fold's yardstick)."""
        with torch.enable_grad():
            out = loss(*leaves)
        g = torch.randn(out.shape, device=dev).to(out.dtype)
        row = {"ms": cuda_ms(torch, fwd, 200)[0],
               "plain_ms": cuda_ms(torch, fwd_plain, 50)[0],
               "unfused_ms": cuda_ms(torch, fwd_unfused, 200)[0]}
        row["bwd_ms"], row["bwd_host_us"] = cuda_ms(torch, lambda: bwd(g),
                                                    200)
        row["bwd_two_launch_ms"] = cuda_ms(torch, lambda: bwd_two(g), 200)[0]
        row["bwd_plain_ms"] = cuda_ms(torch, lambda: bwd_plain(g), 50)[0]
        row["bwd_unfused_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), 50)[0]
        return row

    rows_out = []
    for rows, d, width in GATED_WHOLE:
        y, z, _ = inputs((rows, d), bf, width, 0)
        s = torch.linspace(0.5, 1.5, d, device=dev).to(bf)
        leaves = [t.detach().clone().requires_grad_() for t in (y, z, s)]
        row = timed(lambda: rmsnorm_gated(y, z, s),
                    lambda: rmsnorm_gated_ref(y, z, s),
                    lambda: rmsnorm(gate_ref(y, z), s),
                    lambda g: rmsnorm_gated_bwd(y, z, g, s),
                    lambda g: rmsnorm_ops._bwd(y, z, g, s, 1e-6, fold=False),
                    lambda g: rmsnorm_gated_bwd_ref(y, z, g, s),
                    leaves, lambda a, b, c: rmsnorm(gate_ref(a, b), c))
        for key, bwd in (("", False), ("bwd_", True)):
            flops, nbytes, bnd, by = gated_cost(rows, d, bwd)
            row.update({f"{key}bound_ms": bnd, f"{key}bound_by": by,
                        f"{key}flops": flops, f"{key}bytes": nbytes})
        row.update(shape=[rows, d], z_row_width=width, split=False)
        rows_out.append(row)
    for rows, d, width in GATED_SPLIT:
        y, z, _ = inputs((rows, d), bf, width, 0)
        s = torch.linspace(0.5, 1.5, d, device=dev).to(bf)
        v = gate_ref(y, z).float()
        sq = (v * v).sum(-1) * (5120 / d)

        def ident(t):
            return t

        leaves = [t.detach().clone().requires_grad_() for t in (y, z, s)]
        row = timed(lambda: rmsnorm_split(y, s, 5120, ident, gate=z),
                    lambda: rmsnorm_split_ref(y, s, 5120, ident, gate=z),
                    lambda: rmsnorm_split(gate_ref(y, z), s, 5120, ident),
                    lambda g: rmsnorm_split_gated_bwd(y, z, g, s, sq, 5120,
                                                      ident),
                    lambda g: rmsnorm_ops._split_bwd(y, z, g, s, sq, 5120,
                                                     ident, 1e-6, fold=False),
                    lambda g: rmsnorm_split_gated_bwd_ref(y, z, g, s, sq,
                                                          5120, ident),
                    leaves, lambda a, b, c: rmsnorm_split(
                        gate_ref(a, b), c, 5120, ident))
        for key, bwd in (("", False), ("bwd_", True)):
            flops, nbytes, bnd, by = gated_cost(rows, d, bwd, split=True)
            row.update({f"{key}bound_ms": bnd, f"{key}bound_by": by,
                        f"{key}flops": flops, f"{key}bytes": nbytes})
        row.update(shape=[rows, d], whole=5120, z_row_width=width,
                   split=True)
        rows_out.append(row)
    for r in rows_out:
        what = (f"split {r['shape'][0]} x {r['shape'][1]} of 5120"
                if r["split"] else f"{r['shape'][0]} x {r['shape'][1]}")
        print(f"  rmsnorm_gated {what} (z in rows {r['z_row_width']} wide): "
              f"forward {r['ms']:.5f} ms (plain {r['plain_ms']:.5f}, "
              f"unfused {r['unfused_ms']:.5f}, bound {r['bound_ms']:.5f} by "
              f"{r['bound_by']}); backward {r['bwd_ms']:.5f} ms (dscale's "
              f"sum in a launch of its own {r['bwd_two_launch_ms']:.5f}, plain "
              f"{r['bwd_plain_ms']:.5f}, unfused {r['bwd_unfused_ms']:.5f}, "
              f"bound {r['bwd_bound_ms']:.5f} by {r['bwd_bound_by']}; host "
              f"us {r['bwd_host_us']:.1f})", flush=True)
    first = rows_out[0]
    return {
        "name": "rmsnorm_gated", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:32",
        "shape": "y, z (8192,1536) bf16, z columns of rows 3352 wide "
                 "(mamba2-130m's train rows)",
        "max_abs_err": err_fwd, "tolerance": RN_TOL["bfloat16"],
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes the gated norm",
        "unfused_ms": first["unfused_ms"],
        "bwd_max_abs_err": err_bwd, "bwd_ms": first["bwd_ms"],
        "bwd_plain_ms": first["bwd_plain_ms"],
        "bwd_unfused_ms": first["bwd_unfused_ms"],
        "bwd_two_launch_ms": first["bwd_two_launch_ms"],
        "bwd_bound_ms": first["bwd_bound_ms"],
        "bwd_bound_by": first["bwd_bound_by"],
        "split_max_abs_err": err_split, "model_shapes": rows_out}


def fa_cost(B, S, H, K, D, T=None, causal=True, pairs=None, kv_rows=None,
            fp32=False):
    """(flops, bytes, bound ms, what bounds it) of bf16 attention, S
    queries against T keys (T = S unless given): QK^T and PV over the
    visible (query, key) pairs (causal with S = T: S(S+1)/2; else S T;
    or `pairs`, counted from the positions' mask), 2 flops a MAC; q, the
    k and v rows some query sees (all T, or `kv_rows`, counted from the
    mask) read once, the output written once, positions int32.  `fp32`:
    float32 tensors at the card's float32 peak (the scalar kernel)."""
    T = S if T is None else T
    if pairs is None:
        pairs = S * (S + 1) // 2 if causal else S * T
    kv_rows = T if kv_rows is None else kv_rows
    flops = 4 * B * H * D * pairs
    size = 4 if fp32 else 2
    nbytes = size * (2 * B * S * H * D + 2 * B * kv_rows * K * D) \
        + 4 * (S + T)
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gmm_cost(rows, d, f, experts_used):
    """(flops, bytes, bound ms, what bounds it) of a bf16 grouped GEMM:
    2 flops a MAC over the rows; the rows read once, the weights of the
    experts that have rows read once, the output written once."""
    flops = 2 * rows * d * f
    nbytes = 2 * (rows * d + experts_used * d * f + rows * f)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (flops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def float64_mode(torch):
    """A TorchFunctionMode under which the plain routes compute in
    float64 throughout, the gradient's reference: every cast to float32
    (`.float()`, `.to(torch.float32)`) and every float32 dtype asked of a
    call gives float64 instead.  `kept` counts those casts and dtypes;
    `leaks` names each call that still returned another floating dtype
    (there must be none)."""
    from torch.overrides import TorchFunctionMode
    f32, f64 = torch.float32, torch.float64

    class Float64(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.kept, self.leaks = 0, set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = dict(kwargs or {})
            if kwargs.get("dtype") is f32:
                kwargs["dtype"] = f64
                self.kept += 1
            if func is torch.Tensor.float:
                func, args = torch.Tensor.to, (args[0], f64)
                self.kept += 1
            elif func is torch.Tensor.to and f32 in args[1:]:
                args = tuple(f64 if a is f32 else a for a in args)
                self.kept += 1
            out = func(*args, **kwargs)
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.dtype != f64:
                    self.leaks.add(getattr(func, "__name__", repr(func)))
            return out

    return Float64()


def float64_loss_and_grad(torch, cfg, params, batch, dev):
    """(loss, gradient) of the plain routes at `params` in float64, under
    `float64_mode`: a row of the batch at a time, averaged (the loss is a
    mean over tokens, every row as long), without remat, whose recompute
    runs outside the mode."""
    from repro_torch.runtime.train import (TrainConfig, make_loss_fn,
                                           value_and_grad)
    from repro_torch.tree import tree_map
    loss_fn = make_loss_fn(cfg, TrainConfig(attention_impl="naive",
                                            remat=False), dev)
    p64 = tree_map(lambda t: t.double(), params)
    rows = batch["labels"].shape[0]
    mode = float64_mode(torch)
    loss, grads = 0.0, None
    with mode:
        for r in range(rows):
            (l, _), g = value_and_grad(
                loss_fn, p64, {k: v[r:r + 1] for k, v in batch.items()})
            loss += float(l) / rows
            grads = g if grads is None else tree_map(torch.add, grads, g)
            del g
    check(mode.kept > 0 and not mode.leaks,
          f"float64 reference: {mode.kept} float32 casts and dtypes kept "
          f"in float64; calls that gave another floating dtype: "
          f"{sorted(mode.leaks) or 'none'}")
    return loss, tree_map(lambda t: t / rows, grads)


def close(torch, got, want, atol, rtol):
    return bool(torch.allclose(got.float(), want.float(), atol=atol,
                               rtol=rtol))


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_attention.ops import _ref_call
    from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_bwd,
                                                 rmsnorm_split,
                                                 rmsnorm_split_bwd)
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref,
                                                 rmsnorm_ref,
                                                 rmsnorm_split_bwd_ref,
                                                 rmsnorm_split_ref)
    from repro_torch.kernels.ssd.ops import (TC_CHUNK, _launch, _launch_bwd,
                                             bwd_heads_per_group, ssd)
    from repro_torch.kernels.ssd.ref import (ssd_bwd_tc_plain, ssd_plain,
                                             ssd_ref)

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
        (2, 1024, 1024, 32, 32, 80, True, None, None),  # zamba2 prefill
        (1, 128, 128, 4, 2, 64, True, None, None),
        (2, 256, 256, 8, 4, 64, True, None, 50.0),
        (1, 200, 200, 4, 4, 48, True, 128, None),
        (1, 128, 384, 4, 2, 64, True, None, None),
        (1, 128, 128, 4, 1, 64, False, None, None),
        (1, 130, 130, 2, 2, 32, True, None, None),
        (1, 100, 100, 2, 2, 32, False, None, None),     # ragged non-causal
        (2, 70, 70, 4, 2, 16, True, 32, None),
        (1, 96, 96, 8, 4, 256, True, 64, 50.0),
        (1, 1000, 1000, 4, 4, 80, True, None, None),    # D = 80, ragged T
        (1, 300, 300, 6, 2, 64, True, None, None),      # G = 3, as smollm
        (1, 512, 512, 4, 4, 80, True, 128, None),       # window at D = 80
        (1, 64, 1000, 4, 2, 64, True, None, None),      # 64 queries, offsets
    ] + [case[1:] + (None, None) for case in FA_MODEL_CASES]
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
            if dname == "bfloat16" and (B, S, H) == (4, 1024, 15):
                fa_err = err          # ... replaced by the working dtype
        # queries at 0, 4, ..., 508 against 512 keys: the two halves of the
        # query tile see different key tiles
        for D in (64, 80):
            q = randn((1, 128, 2, D), dtype)
            k = randn((1, 512, 2, D), dtype)
            v = randn((1, 512, 2, D), dtype, 3.0)
            qp = 4 * torch.arange(128, dtype=torch.int32, device=dev)
            kp = torch.arange(512, dtype=torch.int32, device=dev)
            out = flash_attention(q, k, v, qp, kp)
            ref = plain_fa(q, k, v, qp, kp, None, None, True)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(close(torch, out, ref, atol, rtol),
                  f"flash_attention {dname} D={D} sparse query positions: "
                  f"max err {err:.3g} (atol {atol}, rtol {rtol})")

    rn_cases = [(4096, 960), (4, 960), (257, 384), (33, 100), (2, 64, 128),
                (1, 1, 256),
                (4096, 768), (4096, 1536), (4, 768), (4, 1536),  # mamba2
                (2048, 2560), (2048, 5120), (2, 2560), (2, 5120),  # zamba2
                (4096, 6144), (4, 6144), (2048, 7168), (2, 7168),  # MoE
                (4096, 1024), (4, 1024)]                  # pixtral, seamless
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

    # the backward kernel: smollm-360m's training rows (8 x 1024), odd row
    # counts, d not a multiple of 8, wider rows, both scale dtypes
    rn_bwd_cases = [(8192, 960), (8, 1024, 960), (257, 384), (33, 100),
                    (1, 1, 256), (3, 12), (1001, 1536), (2049, 5120),
                    (5, 20000)]
    rn_bwd_err = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for sdtype in dts.values():
            for shape in rn_bwd_cases:
                x, g = randn(shape, dtype), randn(shape, dtype)
                s = (torch.linspace(0.5, 1.5, shape[-1], device=dev)).to(
                    sdtype)
                dx, ds = rmsnorm_bwd(x, g, s)
                rdx, rds = rmsnorm_bwd_ref(x, g, s)
                torch.cuda.synchronize()
                err = max_err(dx, rdx)
                again = rmsnorm_bwd(x, g, s)
                check(close(torch, dx, rdx, atol, rtol)
                      and dscale_ok(torch, ds, rds, x, g, sdtype)
                      and torch.equal(again[0], dx)
                      and torch.equal(again[1], ds),
                      f"rmsnorm backward {dname} x, {sdtype} scale {shape}: "
                      f"dx max err {err:.3g} (atol {atol}, rtol {rtol}), "
                      f"dscale max err {max_err(ds, rds):.3g} (1e-5 of the "
                      f"terms' magnitudes + one ulp); same bits when "
                      f"repeated")
                if (dname == "bfloat16" and sdtype == torch.bfloat16
                        and shape == (8192, 960)):
                    rn_bwd_err = err

    # the split-row entry (the split-heads Mamba2 mixer's gated norm): one
    # rank's columns of rows `whole` wide, the other columns' squares added
    # on this card where the mixer's psum over 'model' adds the other
    # ranks'; zamba2's pod-rank (5 heads of 64) and four-card (20 heads)
    # columns, decode's 2 rows, a block whose start is not 16-byte aligned
    # (the scalar kernels) and a narrow one; both dtypes.  (rows, columns,
    # whole width, first column)
    rs_cases = [(2048, 320, 5120, 1600), (2048, 1280, 5120, 0),
                (2, 320, 5120, 4800), (33, 100, 300, 100),
                (257, 384, 1536, 384)]
    rs_err = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for rows, d, whole, c0 in rs_cases:
            xw = randn((rows, whole), dtype)
            sw = torch.linspace(0.5, 1.5, whole, device=dev).to(dtype)
            xl, sl = xw[:, c0:c0 + d], sw[c0:c0 + d]
            other = torch.cat([xw[:, :c0], xw[:, c0 + d:]], -1).float()
            other = (other * other).sum(-1)

            def sum_rows(ss, other=other):
                return ss + other

            out = rmsnorm_split(xl, sl, whole, sum_rows)
            ref = rmsnorm_split_ref(xl, sl, whole, sum_rows)
            whole_ref = rmsnorm_ref(xw, sw)[:, c0:c0 + d]
            torch.cuda.synchronize()
            err = max_err(out, ref)
            check(close(torch, out, ref, atol, rtol)
                  and close(torch, out, whole_ref, atol, rtol),
                  f"rmsnorm_split {dname} columns {c0}:{c0 + d} of {rows} "
                  f"rows x {whole}: max err {err:.3g} against its plain "
                  f"version, {max_err(out, whole_ref):.3g} against the "
                  f"whole row's norm (atol {atol}, rtol {rtol})")
            if dname == "bfloat16" and (rows, d) == (2048, 320):
                rs_err = err

    # its backward pair, against autograd through every simulated rank's
    # rmsnorm_split_ref on float32 copies (one loss over all ranks'
    # outputs, each rank's squares summed with the others') and against
    # rmsnorm_split_bwd_ref; the rank at the case's columns runs the
    # kernels, `sum_rows` adding the other ranks' dots.  dscale to the
    # whole-row backward's bound (dscale_ok's: 1e-5 of the terms'
    # magnitudes plus, in bf16, one ulp)
    rs_bwd_err = None
    for dname, dtype in dts.items():
        atol, rtol = RN_TOL[dname]
        for rows, d, whole, c0 in rs_cases:
            xw, gw = randn((rows, whole), dtype), randn((rows, whole), dtype)
            sw = torch.linspace(0.5, 1.5, whole, device=dev).to(dtype)
            cols = [slice(k, k + d) for k in range(0, whole, d)]
            me = c0 // d
            xs = [xw[:, c].float().requires_grad_() for c in cols]
            ss = [sw[c].float().requires_grad_() for c in cols]
            with torch.enable_grad():
                loss = sum((rmsnorm_split_ref(
                    xs[r], ss[r], whole, lambda v, r=r: v + sum(
                        (xs[k] * xs[k]).sum(-1) for k in range(len(cols))
                        if k != r)) * gw[:, c].float()).sum()
                    for r, c in enumerate(cols))
                want_dx, want_ds = torch.autograd.grad(loss, (xs[me], ss[me]))
            del xs, ss, loss
            sq = (xw.float() ** 2).sum(-1)
            others = sum((gw[:, c].float() * sw[c].float()
                          * xw[:, c].float()).sum(-1)
                         for r, c in enumerate(cols) if r != me)

            def sum_dots(v, others=others):
                return v + others

            xl, gl, sl = (xw[:, c0:c0 + d], gw[:, c0:c0 + d].contiguous(),
                          sw[c0:c0 + d].contiguous())
            dx, ds = rmsnorm_split_bwd(xl, gl, sl, sq, whole, sum_dots)
            rdx, rds = rmsnorm_split_bwd_ref(xl, gl, sl, sq, whole, sum_dots)
            torch.cuda.synchronize()
            again = rmsnorm_split_bwd(xl, gl, sl, sq, whole, sum_dots)
            xf, gf = xl.float(), gl.float()
            mag = (gf * xf * torch.rsqrt(sq / whole + 1e-6)[:, None]).abs(
            ).sum(0)
            ds_ok = all(bool(((ds.float() - w.float()).abs()
                              <= 1e-5 * mag + (rtol * w.float().abs())).all())
                        for w in (want_ds, rds))
            err = max(max_err(dx, want_dx), max_err(dx, rdx))
            check(close(torch, dx, want_dx, atol, rtol)
                  and close(torch, dx, rdx, atol, rtol) and ds_ok
                  and torch.equal(again[0], dx) and torch.equal(again[1], ds),
                  f"rmsnorm_split backward {dname} columns {c0}:{c0 + d} of "
                  f"{rows} rows x {whole} ({len(cols)} simulated ranks): dx "
                  f"max err {err:.3g} against autograd and its plain "
                  f"version (atol {atol}, rtol {rtol}), dscale max err "
                  f"{max(max_err(ds, want_ds), max_err(ds, rds)):.3g} (1e-5 "
                  f"of the terms' magnitudes + {rtol} relative); same bits "
                  f"when repeated")
            if dname == "bfloat16" and (rows, d) == (2048, 320):
                rs_bwd_err = err

    def ssd_inputs(b, L, H, P, N, dtype, steep=False):
        x = (0.5 * randn((b, L, H, P), torch.float32)).to(dtype)
        dt = F.softplus(randn((b, L, H), torch.float32))
        A = -torch.exp(0.3 * randn((H,), torch.float32))
        if steep:                   # decay of exp(-16000) over 64 tokens
            dt, A = dt + 5.0, torch.full((H,), -50.0, device=dev)
        B = (0.5 * randn((b, L, N), torch.float32)).to(dtype)
        C = (0.5 * randn((b, L, N), torch.float32)).to(dtype)
        return x, dt, A, B, C

    def ssd_model_layout(b, H, N, L=1024, P=64):
        """x, B, C as `models/ssm.py` hands them to the kernel: split
        views of one bf16 conv output, row stride H*P + 2N elements."""
        xBC = (0.5 * randn((b, L, H * P + 2 * N), torch.float32)).to(
            torch.bfloat16)
        x, B, C = torch.split(xBC, [H * P, N, N], dim=-1)
        dt = F.softplus(randn((b, L, H), torch.float32))
        A = -torch.exp(0.3 * randn((H,), torch.float32))
        return x.reshape(b, L, H, P), dt, A, B, C

    ssd_cases = [  # b, L, H, P, N, chunk, steep
        (4, 1024, 24, 64, 128, 256, False),   # mamba2-130m prefill
        (2, 1024, 80, 64, 64, 256, False),    # zamba2-2.7b prefill
        (1, 64, 4, 16, 16, 16, False),        # tests/test_kernels.py
        (2, 256, 8, 32, 32, 128, False),
        (1, 100, 4, 16, 32, 32, False),
        (1, 128, 1, 64, 128, 64, False),
        (1, 1000, 4, 64, 128, 256, False),    # ragged L
        (1, 64, 2, 16, 16, 64, True),         # steep decay
    ]
    ssd_err = None
    for dname, dtype in dts.items():
        atol, rtol = SSD_TOL[dname]
        for b, L, H, P, N, chunk, steep in ssd_cases:
            x, dt, A, B, C = ssd_inputs(b, L, H, P, N, dtype, steep)
            tc_before = ssd.tc_launches
            out, _ = ssd(x, dt, A, B, C, chunk=chunk)
            ref = ssd_plain(x, dt, A, B, C, chunk)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            tc = ssd.tc_launches - tc_before
            check(bool(torch.isfinite(out).all())
                  and close(torch, out, ref, atol, rtol)
                  and tc == (dname == "bfloat16"),
                  f"ssd {dname} b={b} L={L} H={H} P={P} N={N} "
                  f"chunk={chunk} steep={steep}: max err {err:.3g} "
                  f"(atol {atol}, rtol {rtol}; max |y| "
                  f"{float(ref.float().abs().max()):.3g}); tensor-core "
                  f"launches {tc}")
            if dname == "bfloat16" and (b, L, H) == (4, 1024, 24):
                ssd_err = err
    atol, rtol = SSD_TOL["bfloat16"]
    for b, H, N in ((4, 24, 128), (2, 80, 64)):   # the models' split views
        x, dt, A, B, C = ssd_model_layout(b, H, N)
        out, _ = ssd(x, dt, A, B, C, chunk=256)
        ref = ssd_plain(x, dt, A, B, C, 256)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out).all())
              and close(torch, out, ref, atol, rtol),
              f"ssd bfloat16 b={b} L=1024 H={H} P=64 N={N} in the model's "
              f"strided layout (views of one (b, L, H*P + 2N) tensor): max "
              f"err {err:.3g} (atol {atol}, rtol {rtol})")
    x, dt, A, B, C = ssd_inputs(2, 130, 4, 16, 32, torch.float32)
    out, _ = ssd(x, dt, A, B, C)
    ref, _ = ssd_ref(x, dt, A, B, C)
    err = max_err(out, ref)
    check(err <= 1e-3, f"ssd float32 against the sequential ssd_ref "
          f"(b=2, L=130): max err {err:.3g} (tol 1e-3, as "
          f"tests/test_kernels.py)")

    # the SSD backward kernel against autograd through ssd_plain (its
    # chunk of 64), the same dy, and bf16 also against its rounding model
    # `ssd_bwd_tc_plain` (the tensor-core route's chunk of 128, splits and
    # head groups): mamba2-130m's and zamba2-2.7b's train shapes, the
    # forward's small, ragged and steep cases, then the models' split
    # views; every gradient finite, dA exactly 0 at the steep decay (as
    # autograd's), the same bits when repeated (no atomics), and every
    # bf16 call on the tensor-core route, which reads the forward's states
    def ssd_grads(x, dt, A, B, C, dy):
        ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
        with torch.enable_grad():
            return torch.autograd.grad(ssd_plain(*ins, 64), ins, dy)

    def bwd_errs(got, want, dname, model=False):
        """(every gradient within SSD_BWD_TOL and finite, its errors);
        against the rounding model, ddt and dA within SSD_BWD_TC_FP32_TOL
        of their largest"""
        ok, errs = True, []
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            e, big = max_err(g, w), float(w.float().abs().max())
            if dname == "float32":
                good = e <= SSD_BWD_TOL["float32"] * big
            elif model and name in ("ddt", "dA"):
                good = e <= SSD_BWD_TC_FP32_TOL * big
            else:
                good = close(torch, g, w, *SSD_BWD_TOL["bfloat16"])
            ok &= good and g.dtype == w.dtype and bool(
                torch.isfinite(g).all())
            errs.append(f"{name} {e:.3g} of {big:.3g}")
        return ok, ", ".join(errs)

    def bwd_kernel(x, dt, A, B, C, dy):
        """`_launch_bwd` as `_SSD` calls it: a bf16 call reads the
        states its forward kept; and the tensor-core launches it made"""
        states = (_launch(x, dt, A, B, C, keep=True)[1]
                  if x.dtype == torch.bfloat16 else None)
        tc0 = ssd.bwd_tc_launches
        got = _launch_bwd(x, dt, A, B, C, dy, states)
        return got, ssd.bwd_tc_launches - tc0, states

    def tc_model(x, dt, A, B, C, dy):
        b, L, H = x.shape[:3]
        return ssd_bwd_tc_plain(x, dt, A, B, C, dy,
                                bwd_heads_per_group(b, L, H, dev))

    bwd_cases = [(8, 1024, 24, 64, 128, False),   # mamba2-130m train
                 (2, 1024, 80, 64, 64, False)]    # zamba2-2.7b train
    bwd_cases += [(b, L, H, P, N, steep) for b, L, H, P, N, _, steep
                  in ssd_cases[2:]]
    ssd_bwd_err = None
    for dname, dtype in dts.items():
        for b, L, H, P, N, steep in bwd_cases:
            x, dt, A, B, C = ssd_inputs(b, L, H, P, N, dtype, steep)
            dy = randn((b, L, H, P), dtype)
            got, tc, states = bwd_kernel(x, dt, A, B, C, dy)
            want = ssd_grads(x, dt, A, B, C, dy)
            torch.cuda.synchronize()
            again = _launch_bwd(x, dt, A, B, C, dy, states)
            ok, errs = bwd_errs(got, want, dname)
            what = "autograd through ssd_plain"
            if dname == "bfloat16":
                ok_m, errs_m = bwd_errs(got, tc_model(x, dt, A, B, C, dy),
                                        dname, model=True)
                ok &= ok_m and tc == 1
                errs += (f"; against ssd_bwd_tc_plain: {errs_m} (ddt, dA "
                         f"{SSD_BWD_TC_FP32_TOL} of their largest)")
            if steep:
                ok &= bool((got[2] == 0).all())
            check(ok and all(torch.equal(a, g) for a, g in zip(again, got)),
                  f"ssd backward {dname} b={b} L={L} H={H} P={P} N={N} "
                  f"steep={steep} against {what}: {errs} (tolerance "
                  f"{SSD_BWD_TOL[dname]}); finite, the same bits when "
                  f"repeated; tensor-core launches {tc}"
                  + ("; dA exactly 0" if steep else ""))
            if dname == "bfloat16" and (b, H) == (8, 24):
                ssd_bwd_err = max_err(got[0], want[0])
    for b, H, N in ((8, 24, 128), (2, 80, 64)):   # the models' split views
        x, dt, A, B, C = ssd_model_layout(b, H, N)
        dy = randn(x.shape, torch.bfloat16)
        got, tc, states = bwd_kernel(x, dt, A, B, C, dy)
        again = _launch_bwd(x, dt, A, B, C, dy, states)
        ok, errs = bwd_errs(got, ssd_grads(x, dt, A, B, C, dy), "bfloat16")
        ok_m, errs_m = bwd_errs(got, tc_model(x, dt, A, B, C, dy),
                                "bfloat16", model=True)
        check(ok and ok_m and tc == 1
              and all(torch.equal(a, g) for a, g in zip(again, got)),
              f"ssd backward bfloat16 b={b} L=1024 H={H} P=64 N={N} in "
              f"the model's strided layout: {errs}; against "
              f"ssd_bwd_tc_plain: {errs_m}; the same bits when repeated")

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
    fa_flops, fa_bytes, fa_bound, fa_by = fa_cost(B, S, H, K, D)
    zq, zk, zv = (randn((2, S, 32, 80), torch.bfloat16) for _ in range(3))
    fa_zamba_ms, _ = cuda_ms(
        torch, lambda: flash_attention(zq, zk, zv, pos, pos), 20)
    zqt, zkt, zvt = (t.transpose(1, 2).contiguous() for t in (zq, zk, zv))
    fa_zamba_lib_ms, _ = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        zqt, zkt, zvt, is_causal=True), 20)
    _, _, fa_zamba_bound, fa_zamba_by = fa_cost(2, S, 32, 32, 80)

    x = randn((4096, 960), torch.bfloat16)
    s = torch.linspace(0.5, 1.5, 960, device=dev).to(torch.bfloat16)
    rn_ms, rn_host_us = cuda_ms(torch, lambda: rmsnorm(x, s), 200)
    rn_plain_ms, _ = cuda_ms(torch, lambda: rmsnorm_ref(x, s), 200)
    rn_lib_ms, _ = cuda_ms(torch, lambda: F.rms_norm(x, (960,), s, 1e-6),
                           200)
    # the backward at smollm-360m's training rows; the library yardstick is
    # aten's fused RMSNorm backward where this torch has it (it reads the
    # rstd its forward saved), else autograd's backward through F.rms_norm
    xb, gb = randn((8192, 960), torch.bfloat16), randn((8192, 960),
                                                        torch.bfloat16)
    rn_bwd_ms, rn_bwd_host_us = cuda_ms(
        torch, lambda: rmsnorm_bwd(xb, gb, s), 200)
    rn_bwd_plain_ms, _ = cuda_ms(torch, lambda: rmsnorm_bwd_ref(xb, gb, s),
                                 50)
    if hasattr(torch.ops.aten, "_fused_rms_norm_backward"):
        _, rstd = torch.ops.aten._fused_rms_norm(xb, [960], s, 1e-6)
        rn_bwd_lib = "torch.ops.aten._fused_rms_norm_backward"
        rn_bwd_lib_ms, _ = cuda_ms(
            torch, lambda: torch.ops.aten._fused_rms_norm_backward(
                gb, xb, [960], rstd, s, [True, True]), 200)
    else:
        xr, sr = xb.clone().requires_grad_(), s.clone().requires_grad_()
        yr = F.rms_norm(xr, (960,), sr, 1e-6)
        rn_bwd_lib = "autograd backward of F.rms_norm"
        rn_bwd_lib_ms, _ = cuda_ms(torch, lambda: torch.autograd.grad(
            yr, (xr, sr), gb, retain_graph=True), 200)
    rn_bwd_flops, rn_bwd_bytes, rn_bwd_bound, rn_bwd_by = rn_bwd_cost(
        8192, 960)
    # the plain attention backward the training path runs (the VJP of
    # `attention_ref`, its forward recomputed), at smollm's training shape
    tq = randn((8, 1024, 15, 64), torch.bfloat16)
    tk, tv = (randn((8, 1024, 5, 64), torch.bfloat16) for _ in range(2))
    tg = randn((8, 1024, 15, 64), torch.bfloat16)

    def fa_plain_bwd():
        qkv = [t.detach().requires_grad_() for t in (tq, tk, tv)]
        with torch.enable_grad():
            out = _ref_call(*qkv, pos, pos, None, None, 64 ** -0.5, True)
            return torch.autograd.grad(out, qkv, tg)

    fa_train_ms, _ = cuda_ms(torch, lambda: flash_attention(tq, tk, tv, pos,
                                                            pos), 20)
    fa_plain_bwd_ms, _ = cuda_ms(torch, fa_plain_bwd, 5)
    x4 = randn((4, 960), torch.bfloat16)
    rn_decode_ms, _ = cuda_ms(torch, lambda: rmsnorm(x4, s), 500)
    rn_decode_lib_ms, _ = cuda_ms(
        torch, lambda: F.rms_norm(x4, (960,), s, 1e-6), 500)
    rn_shapes = []  # each model's prefill widths, bf16 x and scale
    for rows, d in ((4096, 960), (4096, 768), (4096, 1536), (2048, 2560),
                    (2048, 5120), (4, 960), (4096, 6144), (2048, 7168),
                    (4096, 1024)):
        xr = randn((rows, d), torch.bfloat16)
        sr = torch.linspace(0.5, 1.5, d, device=dev).to(torch.bfloat16)
        k_ms, _ = cuda_ms(torch, lambda: rmsnorm(xr, sr), 200)
        l_ms, _ = cuda_ms(torch, lambda: F.rms_norm(xr, (d,), sr, 1e-6), 200)
        _, _, bnd, by = rn_cost(rows, d)
        rn_shapes.append({"shape": [rows, d], "ms": k_ms, "library_ms": l_ms,
                          "bound_ms": bnd, "bound_by": by})

    # the split-row entry at zamba2's prefill rows (2 x 1024) on a pod
    # rank's 5 heads and a four-card rank's 20 (columns of rows 5120
    # wide), the sum over ranks left out (one card): the kernel pair, its
    # plain version, and F.rms_norm over the whole row, the nearest
    # library call
    rs_shapes = []
    for rows, d in ((2048, 320), (2048, 1280)):
        xr = randn((rows, d), torch.bfloat16)
        sr = torch.linspace(0.5, 1.5, d, device=dev).to(torch.bfloat16)
        xw = randn((rows, 5120), torch.bfloat16)
        sw = torch.linspace(0.5, 1.5, 5120, device=dev).to(torch.bfloat16)
        k_ms, host_us = cuda_ms(torch, lambda: rmsnorm_split(
            xr, sr, 5120, lambda ss: ss), 200)
        p_ms, _ = cuda_ms(torch, lambda: rmsnorm_split_ref(
            xr, sr, 5120, lambda ss: ss), 200)
        l_ms, _ = cuda_ms(torch, lambda: F.rms_norm(xw, (5120,), sw, 1e-6),
                          200)
        flops, nbytes, bnd, by = rn_cost(rows, d)
        rs_shapes.append({"shape": [rows, d], "whole": 5120, "ms": k_ms,
                          "plain_ms": p_ms, "library_ms": l_ms,
                          "bound_ms": bnd, "bound_by": by, "flops": flops,
                          "bytes": nbytes, "host_us": host_us})

    fa_shapes = []  # the new phases' prefill attention, bf16
    for name, B, S, T, H, K, D, causal in FA_MODEL_CASES:
        mq = randn((B, S, H, D), torch.bfloat16)
        mk, mv = (randn((B, T, K, D), torch.bfloat16) for _ in range(2))
        qp = torch.arange(S, dtype=torch.int32, device=dev)
        kp = torch.arange(T, dtype=torch.int32, device=dev)
        k_ms, _ = cuda_ms(torch, lambda: flash_attention(
            mq, mk, mv, qp, kp, causal=causal), 20)
        p_ms, _ = cuda_ms(torch, lambda: plain_fa(
            mq, mk, mv, qp, kp, None, None, causal), 5)
        mqt, mkt, mvt = (t.transpose(1, 2).contiguous() for t in (mq, mk, mv))
        l_ms, _ = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            mqt, mkt, mvt, is_causal=causal, enable_gqa=K != H), 20)
        _, _, bnd, by = fa_cost(B, S, H, K, D, T, causal)
        fa_shapes.append({"name": name, "shape": [B, S, T, H, K, D],
                          "causal": causal, "ms": k_ms, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": bnd,
                          "bound_by": by})
        print(f"  flash_attention at {name} (B={B} S={S} T={T} H={H} K={K} "
              f"D={D} causal={causal}): {k_ms:.4f} ms, plain {p_ms:.4f}, "
              f"sdpa {l_ms:.4f}, bound {bnd:.4f} by {by}", flush=True)
        del mq, mk, mv, mqt, mkt, mvt

    cp_rows, cp_err = phase_context_parallel_attention(torch, dev, randn,
                                                       plain_fa)

    b, L, H, P, N = 4, 1024, 24, 64, 128          # mamba2-130m prefill
    sx, sdt, sA, sB, sC = ssd_inputs(b, L, H, P, N, torch.bfloat16)
    ssd_ms, ssd_host_us = cuda_ms(
        torch, lambda: ssd(sx, sdt, sA, sB, sC, chunk=256), 20)
    ssd_plain_ms, _ = cuda_ms(
        torch, lambda: ssd_plain(sx, sdt, sA, sB, sC, 256), 5)
    ssd_flops, ssd_bytes, ssd_bound, ssd_by = ssd_cost(b, L, H, P, N)
    zx, zdt, zA, zB, zC = ssd_inputs(2, 1024, 80, 64, 64, torch.bfloat16)
    ssd_zamba_ms, _ = cuda_ms(
        torch, lambda: ssd(zx, zdt, zA, zB, zC, chunk=256), 20)
    ssd_zamba_bound = ssd_cost(2, 1024, 80, 64, 64)[2]
    # the same shapes in the model's strided layout (the prefill's inputs)
    mv = ssd_model_layout(4, 24, 128)
    ssd_strided_ms, _ = cuda_ms(torch, lambda: ssd(*mv, chunk=256), 20)
    zv = ssd_model_layout(2, 80, 64)
    ssd_zamba_strided_ms, _ = cuda_ms(torch, lambda: ssd(*zv, chunk=256), 20)
    del mv, zv
    # the SSD backward at the train shapes (bf16, dy from the seed), beside
    # autograd's backward through ssd_plain (the graph kept, the backward
    # alone timed) and its bound
    ssd_bwd_rows, bwd_inputs = [], []
    for name, (b, L, H, P, N) in (("mamba2-130m", (8, 1024, 24, 64, 128)),
                                  ("zamba2-2.7b", (2, 1024, 80, 64, 64))):
        bv = ssd_inputs(b, L, H, P, N, torch.bfloat16)
        bdy = randn((b, L, H, P), torch.bfloat16)
        states = _launch(*bv, keep=True)[1]   # what `_SSD` keeps
        k_ms, host_us = cuda_ms(
            torch, lambda: _launch_bwd(*bv, bdy, states), 10)
        ins = [t.detach().clone().requires_grad_() for t in bv]
        with torch.enable_grad():
            by = ssd_plain(*ins, 64)
        p_ms, _ = cuda_ms(torch, lambda: torch.autograd.grad(
            by, ins, bdy, retain_graph=True), 3)
        flops, nbytes, bnd, bby = ssd_bwd_cost(b, L, H, P, N)
        ssd_bwd_rows.append({"name": name, "shape": [b, L, H, P, N],
                             "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
                             "bound_by": bby, "flops": flops,
                             "bytes": nbytes, "host_us": host_us})
        print(f"  ssd backward at {name}'s train shape (b={b} L={L} H={H} "
              f"P={P} N={N}, bf16, the forward's states read): {k_ms:.4f} "
              f"ms (autograd through ssd_plain {p_ms:.4f}, no library "
              f"call, bound {bnd:.4f} by {bby} at the chunk of "
              f"{TC_CHUNK}: {flops:.4g} FLOP, {nbytes:.4g} B; host us "
              f"{host_us:.1f})", flush=True)
        del ins, by
        bwd_inputs.append((bv, bdy, states))
    # the split-row backward pair at the forward's shapes (the sum over
    # ranks left out), its plain version, and the whole row's fused
    # backward (2048 x 5120), the nearest library call
    rs_bwd_shapes = []
    for rows, d in ((2048, 320), (2048, 1280)):
        xr, gr = randn((rows, d), torch.bfloat16), randn((rows, d),
                                                         torch.bfloat16)
        sr = torch.linspace(0.5, 1.5, d, device=dev).to(torch.bfloat16)
        sq = (xr.float() ** 2).sum(-1) * (5120 / d)
        k_ms, host_us = cuda_ms(torch, lambda: rmsnorm_split_bwd(
            xr, gr, sr, sq, 5120, lambda v: v), 200)
        p_ms, _ = cuda_ms(torch, lambda: rmsnorm_split_bwd_ref(
            xr, gr, sr, sq, 5120, lambda v: v), 200)
        flops, nbytes, bnd, by = rn_bwd_cost(rows, d)
        rs_bwd_shapes.append({"shape": [rows, d], "whole": 5120, "ms": k_ms,
                              "plain_ms": p_ms, "bound_ms": bnd,
                              "bound_by": by, "flops": flops,
                              "bytes": nbytes, "host_us": host_us})
    rs_bwd_lib_ms = None
    if hasattr(torch.ops.aten, "_fused_rms_norm_backward"):
        xw, gw = randn((2048, 5120), torch.bfloat16), randn((2048, 5120),
                                                            torch.bfloat16)
        sw = torch.linspace(0.5, 1.5, 5120, device=dev).to(torch.bfloat16)
        _, rstd = torch.ops.aten._fused_rms_norm(xw, [5120], sw, 1e-6)
        rs_bwd_lib_ms, _ = cuda_ms(
            torch, lambda: torch.ops.aten._fused_rms_norm_backward(
                gw, xw, [5120], rstd, sw, [True, True]), 200)
    for r in rs_bwd_shapes:
        r["library_ms"] = rs_bwd_lib_ms
        print(f"  rmsnorm_split backward {r['shape'][0]} x {r['shape'][1]} "
              f"of 5120: {r['ms']:.5f} ms (plain {r['plain_ms']:.5f}, the "
              f"whole row's fused backward {rs_bwd_lib_ms}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}; host us "
              f"{r['host_us']:.1f})", flush=True)
    rn_flops, rn_bytes, rn_bound, rn_by = rn_cost(4096, 960)
    print(f"  flash_attention {fa_ms:.4f} ms (plain {fa_plain_ms:.4f}, sdpa "
          f"{fa_lib_ms:.4f}, bound {fa_bound:.4f} by {fa_by}), at the "
          f"zamba2 shape {fa_zamba_ms:.4f} ms (sdpa {fa_zamba_lib_ms:.4f}, "
          f"bound {fa_zamba_bound:.4f} by {fa_zamba_by}); rmsnorm "
          f"{rn_ms:.4f} ms (plain {rn_plain_ms:.4f}, F.rms_norm "
          f"{rn_lib_ms:.4f}, bound {rn_bound:.4f} by {rn_by}); rmsnorm at "
          f"4 rows {rn_decode_ms:.4f} ms (F.rms_norm {rn_decode_lib_ms:.4f});"
          f" ssd {ssd_ms:.4f} ms (plain {ssd_plain_ms:.4f}, no library "
          f"call, bound {ssd_bound:.4f} by {ssd_by}), in the model's strided "
          f"layout {ssd_strided_ms:.4f} ms; ssd at the zamba2 shape "
          f"{ssd_zamba_ms:.4f} ms (bound {ssd_zamba_bound:.4f}), strided "
          f"{ssd_zamba_strided_ms:.4f} ms; host us per call: flash "
          f"{fa_host_us:.1f}, rmsnorm {rn_host_us:.1f}, ssd "
          f"{ssd_host_us:.1f}", flush=True)
    for r in rn_shapes:
        print(f"  rmsnorm {r['shape'][0]} x {r['shape'][1]}: {r['ms']:.5f} ms, "
              f"F.rms_norm {r['library_ms']:.5f} ms, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}", flush=True)
    for r in rs_shapes:
        print(f"  rmsnorm_split {r['shape'][0]} x {r['shape'][1]} of "
              f"{r['whole']}: {r['ms']:.5f} ms (plain {r['plain_ms']:.5f}, "
              f"F.rms_norm of the whole row {r['library_ms']:.5f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}; host us "
              f"{r['host_us']:.1f})", flush=True)
    print(f"  rmsnorm backward 8192 x 960: {rn_bwd_ms:.5f} ms (plain "
          f"{rn_bwd_plain_ms:.5f}, {rn_bwd_lib} {rn_bwd_lib_ms:.5f}, bound "
          f"{rn_bwd_bound:.5f} by {rn_bwd_by}; host us {rn_bwd_host_us:.1f}); "
          f"flash attention at the training shape (8,1024,15,64) "
          f"{fa_train_ms:.4f} ms, its plain backward (forward recomputed, "
          f"VJP) {fa_plain_bwd_ms:.4f} ms", flush=True)
    # the SSD backward's passes, after every CUDA-event timing above (the
    # profiler's tracing slows the plain routes' many launches)
    for row, (bv, bdy, states) in zip(ssd_bwd_rows, bwd_inputs):
        row["passes_ms"] = kernel_ms(
            torch, lambda: _launch_bwd(*bv, bdy, states), 5)
        # the forward's passes 1 and 2, which a backward that recomputed
        # the states instead of reading the forward's would run again
        row["recompute_states_ms"] = {
            k: v for k, v in kernel_ms(torch, lambda: _launch(*bv), 5).items()
            if k.startswith(("tc::chunk_state", "tc::state_pass"))}
        print(f"  ssd backward at {row['name']}'s train shape, its passes "
              f"(torch.profiler, ms a call): "
              f"{json.dumps(row['passes_ms']) if row['passes_ms'] else 'not measured'}; "
              f"the forward's passes 1-2 that recomputing the states would "
              f"add: {json.dumps(row['recompute_states_ms']) if row['recompute_states_ms'] else 'not measured'}",
              flush=True)
    del bwd_inputs
    gated = phase_gated_norm(torch, dev, randn)
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
            "zamba2_shape_ms": fa_zamba_ms,
            "zamba2_shape_bound_ms": fa_zamba_bound,
            "zamba2_shape_bound_by": fa_zamba_by,
            "zamba2_shape_library_ms": fa_zamba_lib_ms, "host_us": fa_host_us,
            "flops": fa_flops, "bytes": fa_bytes,
            "train_shape_ms": fa_train_ms,
            "train_plain_backward_ms": fa_plain_bwd_ms,
            "train_backward": "the VJP of the plain attention (no backward "
                              "kernel, as in the reference)",
            "model_shapes": fa_shapes,
            "context_parallel": {
                "shape": "a rank's q (2,256,15,64) at each quarter of 1024 "
                         "positions against the gathered k/v (2,1024,5,64), "
                         "causal, and with an 8-token window",
                "max_abs_err": cp_err, "tolerance": FA_TOL["bfloat16"],
                "rows": cp_rows}},
        "rmsnorm": {
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:32",
            "shape": "x (4096,960) bf16", "max_abs_err": rn_err,
            "tolerance": RN_TOL["bfloat16"], "ms": rn_ms,
            "plain_ms": rn_plain_ms, "bound_ms": rn_bound,
            "bound_by": rn_by, "library_ms": rn_lib_ms,
            "decode_rows_ms": rn_decode_ms,
            "decode_rows_library_ms": rn_decode_lib_ms,
            "model_shapes": rn_shapes, "host_us": rn_host_us,
            "flops": rn_flops, "bytes": rn_bytes,
            "bwd_shape": "x, g (8192,960) bf16, scale bf16",
            "bwd_max_abs_err": rn_bwd_err, "bwd_ms": rn_bwd_ms,
            "bwd_plain_ms": rn_bwd_plain_ms, "bwd_bound_ms": rn_bwd_bound,
            "bwd_bound_by": rn_bwd_by, "bwd_library_ms": rn_bwd_lib_ms,
            "bwd_library": rn_bwd_lib, "bwd_host_us": rn_bwd_host_us,
            "bwd_flops": rn_bwd_flops, "bwd_bytes": rn_bwd_bytes,
            # the split-row entry: its two kernels around the caller's sum
            # of one float a row over 'model' (launched where a mesh's
            # 'model' splits the Mamba2 mixer's heads, which no one-card
            # path does: the four-card test in tests/test_torch_cuda.py
            # counts it there)
            "split": {
                "name": "rmsnorm_split",
                "shape": "x (2048,320) of rows 5120 wide bf16 (a pod "
                         "rank's 5 heads), the rows' squares summed on "
                         "the card",
                "max_abs_err": rs_err, "tolerance": RN_TOL["bfloat16"],
                "ms": rs_shapes[0]["ms"],
                "plain_ms": rs_shapes[0]["plain_ms"],
                "bound_ms": rs_shapes[0]["bound_ms"],
                "bound_by": rs_shapes[0]["bound_by"],
                "library_ms": rs_shapes[0]["library_ms"],
                "library": "F.rms_norm over the whole row (2048,5120)",
                "model_shapes": rs_shapes,
                "bwd_max_abs_err": rs_bwd_err,
                "bwd_ms": rs_bwd_shapes[0]["ms"],
                "bwd_plain_ms": rs_bwd_shapes[0]["plain_ms"],
                "bwd_bound_ms": rs_bwd_shapes[0]["bound_ms"],
                "bwd_bound_by": rs_bwd_shapes[0]["bound_by"],
                "bwd_library_ms": rs_bwd_lib_ms,
                "bwd_library": "the whole row's fused RMSNorm backward "
                               "(2048,5120), where this torch has it",
                "bwd_model_shapes": rs_bwd_shapes}},
        "ssd": {
            "name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:80",
            "shape": "x (4,1024,24,64) N=128 bf16, dt/A fp32",
            "max_abs_err": ssd_err, "tolerance": SSD_TOL["bfloat16"],
            "ms": ssd_ms, "plain_ms": ssd_plain_ms, "bound_ms": ssd_bound,
            "bound_by": ssd_by, "library_ms": None,
            "library": "none: no PyTorch call computes the SSD scan",
            "strided_ms": ssd_strided_ms,
            "zamba2_shape_ms": ssd_zamba_ms,
            "zamba2_shape_strided_ms": ssd_zamba_strided_ms,
            "zamba2_shape_bound_ms": ssd_zamba_bound, "host_us": ssd_host_us,
            "flops": ssd_flops, "bytes": ssd_bytes},
        # the SSD backward (training; the reference differentiates the
        # scan, and this kernel is that gradient of the TPU kernel's
        # function)
        "ssd_bwd": {
            "name": "ssd_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:80",
            "shape": "x, dy (8,1024,24,64) N=128 bf16, dt/A fp32 "
                     "(mamba2-130m's train step)",
            "max_abs_err": ssd_bwd_err, "tolerance": SSD_BWD_TOL["bfloat16"],
            "ms": ssd_bwd_rows[0]["ms"],
            "plain_ms": ssd_bwd_rows[0]["plain_ms"],
            "bound_ms": ssd_bwd_rows[0]["bound_ms"],
            "bound_by": ssd_bwd_rows[0]["bound_by"], "library_ms": None,
            "library": "none: no PyTorch call computes the SSD scan",
            "zamba2_shape_ms": ssd_bwd_rows[1]["ms"],
            "zamba2_shape_plain_ms": ssd_bwd_rows[1]["plain_ms"],
            "zamba2_shape_bound_ms": ssd_bwd_rows[1]["bound_ms"],
            "model_shapes": ssd_bwd_rows},
        "rmsnorm_gated": gated,
    }


#: context parallelism: a rank's queries (S = 256 of smollm's 1024
#: positions on a 'data' of 4, both rows of a 2 x 1024 batch) against
#: the keys and values gathered from every rank; each quarter's start
CP_B, CP_S, CP_T, CP_H, CP_K, CP_D = 2, 256, 1024, 15, 5, 64
CP_STARTS = (768, 0, 256, 512)


def phase_context_parallel_attention(torch, dev, randn, plain_fa):
    """Phase 2b's context-parallel block: the flash kernel at a rank's
    query positions against the whole sequence's keys, in float32 and
    bf16, causal and with an 8-token window, each quarter of the
    sequence, held to its plain version (FA_TOL), then timed beside it
    and beside `scaled_dot_product_attention` given the same boolean
    mask, with the bound of the pairs and the key rows the mask lets
    through.  Returns (rows, the largest bf16 error)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, S, T, H, K, D = CP_B, CP_S, CP_T, CP_H, CP_K, CP_D
    kp = torch.arange(T, dtype=torch.int32, device=dev)
    rows, worst = [], 0.0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = FA_TOL[dname]
        k = randn((B, T, K, D), dtype)
        v = randn((B, T, K, D), dtype, 3.0)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        for start in CP_STARTS:
            q = randn((B, S, H, D), dtype)
            qt = q.transpose(1, 2).contiguous()
            qp = torch.arange(start, start + S, dtype=torch.int32,
                              device=dev)
            for window in (None, 8):
                out = flash_attention(q, k, v, qp, kp, window=window)
                ref = plain_fa(q, k, v, qp, kp, window, None, True)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                check(close(torch, out, ref, atol, rtol),
                      f"flash_attention {dname} at a context-parallel "
                      f"rank's positions {start}-{start + S - 1} of {T}, "
                      f"window={window}: max err {err:.3g} (atol {atol}, "
                      f"rtol {rtol})")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                mask = kp[None, :] <= qp[:, None]
                if window is not None:
                    mask &= (qp[:, None] - kp[None, :]) < window
                k_ms, _ = cuda_ms(torch, lambda: flash_attention(
                    q, k, v, qp, kp, window=window), 20)
                p_ms, _ = cuda_ms(torch, lambda: plain_fa(
                    q, k, v, qp, kp, window, None, True), 5)
                l_ms, _ = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
                _, _, bnd, by = fa_cost(
                    B, S, H, K, D, T, pairs=int(mask.sum()),
                    kv_rows=int(mask.any(0).sum()),
                    fp32=dtype == torch.float32)
                rows.append({"dtype": dname, "positions": [start,
                                                           start + S - 1],
                             "window": window, "max_abs_err": err,
                             "ms": k_ms, "plain_ms": p_ms,
                             "library_ms": l_ms, "bound_ms": bnd,
                             "bound_by": by})
                print(f"  flash_attention context-parallel {dname} q "
                      f"{start}-{start + S - 1} of {T} window={window}: "
                      f"err {err:.3g}, {k_ms:.4f} ms, plain {p_ms:.4f}, "
                      f"sdpa with the mask {l_ms:.4f}, bound {bnd:.5f} by "
                      f"{by}", flush=True)
    return rows, worst


def phase_grouped_mm(torch, dev):
    """Phase 2c: the MoE block's grouped GEMM, a PyTorch library call
    (`torch._grouped_mm`, the reference's `jax.lax.ragged_dot`, no Pallas
    kernel), against its per-expert loop at the MoE prefills' shapes;
    then both timed beside the bound.  Reported as a library call, not
    as a kernel."""
    from repro_torch.models.moe import grouped_mm, grouped_mm_plain

    print("phase 2c: the MoE grouped GEMM (torch._grouped_mm) against its "
          "per-expert loop", flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, rows, E, d, f, skewed in GMM_CASES:
        draw = torch.Generator().manual_seed(8)
        weights = torch.rand(E, generator=draw) ** 3 if skewed \
            else torch.ones(E)
        pick = torch.multinomial(weights, rows, replacement=True,
                                 generator=draw)
        sizes_cpu = torch.bincount(pick, minlength=E)
        sizes = sizes_cpu.to(dev)
        used = int((sizes_cpu > 0).sum())
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            w = torch.randn((E, d, f), generator=gen, device=dev).div_(
                d ** 0.5).to(dtype)
            got = grouped_mm(x, w, sizes)
            want = grouped_mm_plain(x, w, sizes_cpu)
            torch.cuda.synchronize()
            atol, rtol = GMM_TOL[dname]
            err = max_err(got, want)
            check(close(torch, got, want, atol, rtol),
                  f"grouped_mm {dname} {name}: {rows} rows over {E} experts "
                  f"({E - used} empty, largest group "
                  f"{int(sizes_cpu.max())}), {d} -> {f}: max err {err:.3g} "
                  f"(atol {atol}, rtol {rtol})")
            if dname == "bfloat16":
                g_ms, g_host_us = cuda_ms(
                    torch, lambda: grouped_mm(x, w, sizes), 20)
                p_ms, _ = cuda_ms(
                    torch, lambda: grouped_mm_plain(x, w, sizes_cpu), 5)
                flops, nbytes, bnd, by = gmm_cost(rows, d, f, used)
                out[name] = {
                    "name": "grouped_mm", "route": "library",
                    "call": "torch._grouped_mm",
                    "replaces": "src/repro/models/moe.py:105 "
                                "(jax.lax.ragged_dot)",
                    "rows": rows, "experts": E, "empty_groups": E - used,
                    "largest_group": int(sizes_cpu.max()), "d": d, "f": f,
                    "max_abs_err": err, "tolerance": GMM_TOL[dname],
                    "ms": g_ms, "per_expert_loop_ms": p_ms,
                    "bound_ms": bnd, "bound_by": by, "flops": flops,
                    "bytes": nbytes, "host_us": g_host_us}
                print(f"  grouped_mm {name} bf16: {g_ms:.4f} ms, per-expert "
                      f"loop {p_ms:.4f} ms, bound {bnd:.4f} by {by} "
                      f"({flops:.4g} flops, {nbytes:.4g} bytes)", flush=True)
            del x, w, got, want
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recorded_routes():
    """The experts each MoE `route` call chooses, in call order: one
    (tokens, K) tensor a call, sorted along K (the block's output does not
    depend on the order).  Empty for a model without MoE."""
    from repro_torch.models import moe
    log, route = [], moe.route

    def recording(params, x2d, cfg):
        w, idx, aux = route(params, x2d, cfg)
        log.append(idx.sort(-1).values)
        return w, idx, aux

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = route


def route_flips(torch, a, b, batch):
    """(rows whose last position's experts differ between the recordings
    a and b in any layer, as a (batch,) bool tensor; tokens whose experts
    differ in any layer, counted over every position)."""
    last = torch.zeros(batch, dtype=torch.bool)
    tokens = None
    for x, y in zip(a, b):
        differ = (x != y).any(-1).cpu()
        tokens = differ if tokens is None else tokens | differ
        last |= differ.reshape(batch, -1)[:, -1]
    return last, 0 if tokens is None else int(tokens.sum())


def compare_prefills(torch, run_a, run_b, batch):
    """Run two prefills, recording their MoE routes; (max |diff| of the
    last-position logits over the rows whose routes agree, argmax
    agreement over those rows, rows compared, tokens whose routes
    flipped, the two logits)."""
    with recorded_routes() as ra:
        a = run_a()
    with recorded_routes() as rb:
        b = run_b()
    torch.cuda.synchronize()
    flipped, n_tokens = route_flips(torch, ra, rb, batch)
    keep = (~flipped).to(a.device)
    err = max_err(a[keep], b[keep]) if bool(keep.any()) else float("inf")
    agree = int((a.argmax(-1) == b.argmax(-1))[keep].sum())
    return err, agree, int(keep.sum()), n_tokens, a, b


def phase_serve(torch, dev, arch, batch, n_requests, slots, max_new,
                per_prefill, per_step, tol, layers=None, feed="tokens",
                fp32=True, cross=None):
    """Full-width `arch` (bf16, random weights from seed 0): prefill
    `batch` x 1024 tokens, then the continuous-batching loop, with every
    launch counter set to 0 just before and read just after;
    `per_prefill` / `per_step` are the launches each kernel must show.
    The prefill logits are held against the plain routes within `tol`,
    on the rows whose MoE routes agree in every layer (a route flips
    where two experts' probabilities tie within the routes' rounding;
    flipped tokens are counted and reported).

    layers: the depth is cut to this many layers (printed);
    feed: "tokens"; "embeds", 1024 bf16 embeddings a row from a seed (the
        float32 check then feeds token ids: a float32 model cannot take
        the bf16-cast embeddings, in either package); or "encdec", 1000
        source frames of bf16 embeddings and 1024 tokens;
    fp32: True for the float32 check of the same prefill, else the reason
        it does not run (printed);
    cross: for an encoder-decoder, (launches per `prefill_cross`, greedy
        decode steps) run after the prefill against 1000 encoded source
        frames, before the loop.
    """
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.models import build_model, encdec, param_count
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns

    wrappers = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "ssd": ssd}
    cfg = ARCHS[arch]
    if layers:
        print(f"  {arch}: depth cut from {cfg.n_layers} to {layers} layers "
              f"(published widths)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=layers, unit=())
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, remat=False, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(params)
    print(f"  {arch}: {n_params} parameters", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1024), device=dev,
                           generator=gen)
    inputs = {"tokens": tokens}
    if feed == "embeds":
        inputs = {"embeds": torch.randn((batch, 1024, cfg.d_model),
                                        generator=gen, device=dev).to(
            torch.bfloat16)}
    elif feed == "encdec":
        inputs["src_embeds"] = torch.randn(
            (batch, 1000, cfg.d_model), generator=gen, device=dev).to(
            torch.bfloat16)
    scfg = ServeConfig(max_len=96)
    prefill, decode_step, init_cache = make_serve_fns(cfg, scfg, dev)

    def counted():
        return dict({k: w.launches for k, w in wrappers.items()},
                    rmsnorm_gated=rmsnorm.gated_launches)

    for w in wrappers.values():
        w.launches = 0
    rmsnorm.gated_launches = 0
    flash_attention.tc_launches = 0
    ssd.tc_launches = 0
    t0 = time.perf_counter()
    logits = prefill(params, inputs)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    after_prefill = counted()
    tc_prefill = flash_attention.tc_launches
    ssd_tc_prefill = ssd.tc_launches
    if cross:
        # encode the source once into the cross caches, then decode greedily
        per_cross, cross_steps = cross
        cache = init_cache(batch, 1024, src_len=1000)
        with torch.no_grad():
            cache = encdec.prefill_cross(params, inputs["src_embeds"], cfg,
                                         cache)
        torch.cuda.synchronize()
        after_cross = counted()
        tok, cross_logits = tokens[:, :1], []
        for i in range(cross_steps):
            tok, lg, cache = decode_step(params, cache, tok, i)
            cross_logits.append(lg[:, 0])
        torch.cuda.synchronize()
        after_decode = counted()
        del cache
    else:
        after_cross = after_decode = after_prefill
    queue = make_requests(n_requests, cfg.vocab_size)
    results, stats = serve_loop(params, cfg, scfg, queue, slots=slots,
                                max_new=max_new, device=dev)
    torch.cuda.synchronize()
    counts = counted()
    tc_total = flash_attention.tc_launches

    def minus(a, b):
        return {k: a[k] - b[k] for k in a}

    check(after_prefill == per_prefill,
          f"{arch} prefill launched {after_prefill} (expected "
          f"{per_prefill})")
    if cross:
        in_cross = minus(after_cross, after_prefill)
        in_steps = minus(after_decode, after_cross)
        check(in_cross == per_cross
              and in_steps == {k: n * cross_steps
                               for k, n in per_step.items()},
              f"{arch} prefill_cross of 1000 source frames launched "
              f"{in_cross} (expected {per_cross}); {cross_steps} greedy "
              f"decode steps against it launched {in_steps} ({per_step} a "
              f"step)")
        check(all(bool(torch.isfinite(lg).all()) for lg in cross_logits),
              f"{arch}: {cross_steps} decode steps' logits finite")
    check(tc_prefill == after_prefill["flash_attention"]
          and tc_total == counts["flash_attention"],
          f"{arch}: every flash-attention launch took the tensor-core "
          f"kernel ({tc_prefill} in prefill, {tc_total} in all)")
    check(ssd_tc_prefill == after_prefill["ssd"],
          f"{arch}: every SSD launch of the prefill took the tensor-core "
          f"kernel ({ssd_tc_prefill} of {after_prefill['ssd']})")
    check(logits.shape == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} finite")
    steps = stats["steps"]
    in_loop = minus(counts, after_decode)
    check(in_loop == {k: n * steps for k, n in per_step.items()},
          f"{arch} decode loop: {steps} steps launched {in_loop} "
          f"({per_step} a step; decode attention is the plain path and "
          f"decode runs the recurrent step, not the SSD scan)")
    check(stats["served"] == n_requests and len(results) == n_requests
          and all(len(r) == max_new for r in results.values()),
          f"{arch}: all {n_requests} requests served with {max_new} new "
          f"tokens each")
    check(all(0 <= t < cfg.vocab_size for r in results.values() for t in r),
          f"{arch}: every token in the vocabulary")
    peak_bytes = torch.cuda.max_memory_allocated()

    naive_prefill, _, _ = make_serve_fns(
        cfg, ServeConfig(max_len=96, attention_impl="naive"), dev)
    err, agree, rows, flipped, logits, plain = compare_prefills(
        torch, lambda: prefill(params, inputs),
        lambda: naive_prefill(params, inputs), batch)
    check(err <= tol,
          f"{arch} prefill logits, kernels vs plain path: max diff "
          f"{err:.4g} over the {rows}/{batch} rows whose routes agree (tol "
          f"{tol}; logits max |x| {float(plain.abs().max()):.3g}; "
          f"{flipped} of {batch * 1024} tokens changed experts); argmax "
          f"agrees on {agree}/{rows}")
    out = {"prefill_max_diff_vs_plain": err, "argmax_agree": agree,
           "rows_compared": rows, "tokens_route_flipped": flipped}
    if cross:
        # decode at position 0 against the forward's position 0 (the
        # mirrored cross-attention RoPE leaves position 0 unrotated in
        # both, so they agree there and not after)
        with torch.no_grad():
            full, _ = build_model(cfg, remat=False, device=dev).apply(
                params, inputs)
        first_err = max_err(cross_logits[0], full[:, 0])
        del full
        check(first_err <= tol,
              f"{arch}: the first decode step against prefill_cross's "
              f"cache vs the forward's position 0: max diff "
              f"{first_err:.4g} (tol {tol})")
        out["decode_pos0_max_diff_vs_forward"] = first_err

    prefill_ms, _ = cuda_ms(torch, lambda: prefill(params, inputs), 5)
    plain_prefill_ms, _ = cuda_ms(
        torch, lambda: naive_prefill(params, inputs), 5)

    if fp32 is True:
        # cast leaf by leaf, so that the peak is the float32 tree, not
        # both trees
        def to_fp32(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    to_fp32(v)
                else:
                    tree[k] = v.float()
                    del v
                    torch.cuda.empty_cache()
        to_fp32(params)
        fp32_in = inputs if feed == "tokens" else {"tokens": tokens}
        fp32_err, _, fp32_rows, fp32_flipped, kernel32, plain32 = \
            compare_prefills(torch, lambda: prefill(params, fp32_in),
                             lambda: naive_prefill(params, fp32_in), batch)
        check(fp32_err <= FULL_FP32_TOL,
              f"{arch} prefill with float32 weights, kernels vs plain path: "
              f"max diff {fp32_err:.3g} over the {fp32_rows}/{batch} rows "
              f"whose routes agree (tol {FULL_FP32_TOL}; {fp32_flipped} "
              f"tokens changed experts)")
        out.update(fp32_prefill_max_diff_vs_plain=fp32_err,
                   fp32_tokens_route_flipped=fp32_flipped)
        if fp32_in is inputs and fp32_flipped == 0 and flipped == 0:
            # how far bf16 rounding alone moves each route's logits
            kernel_drift = max_err(logits, plain32)
            plain_drift = max_err(plain, plain32)
            print(f"  {arch} bf16 prefill vs the float32 one: kernels "
                  f"{kernel_drift:.4g}, plain path {plain_drift:.4g}",
                  flush=True)
            out["bf16_drift_from_fp32"] = {"kernels": kernel_drift,
                                           "plain": plain_drift}
        del kernel32, plain32
    else:
        print(f"  {arch}: no float32 check ({fp32})", flush=True)
    del params, logits, plain, inputs
    torch.cuda.empty_cache()
    out.update({"prefill_ms": prefill_ms, "prefill_first_s": prefill_first_s,
                "plain_prefill_ms": plain_prefill_ms,
                "decode_tok_per_s": stats["tok_per_s"],
                "decode_steps": steps, "decode_wall_s": stats["wall_s"],
                "peak_memory_bytes": peak_bytes, "params": n_params,
                "layers": cfg.n_layers,
                "flash_attention_tc_launches": tc_total,
                "ssd_tc_launches": ssd_tc_prefill})
    if cross:
        out.update(prefill_cross_launches=minus(after_cross, after_prefill))
    return out, counts


# kernel names by what they do in an MoE prefill (torch.profiler's names)
PROFILE_GROUPS = [
    ("grouped GEMM", re.compile(r"group", re.I)),
    ("flash attention", re.compile(r"flash", re.I)),
    ("RMSNorm", re.compile(r"rmsnorm", re.I)),
    ("sort, scatter and gather",
     re.compile(r"sort|radix|scatter|gather|index|histogram|scan|repeat",
                re.I)),
    ("dense GEMM", re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)),
]


def profile_moe_prefill(torch, dev):
    """Where mixtral-8x22b's prefill (4 layers, 4 x 1024 tokens) spends
    the card's time: `launch/profile.py` over 3 warm prefills, the kernels
    grouped by name (PROFILE_GROUPS; the rest is elementwise work and
    copies), and the idle share of the traced window (the host)."""
    from repro_torch.launch.profile import profile_prefill

    prof = profile_prefill("mixtral-8x22b", 4, 1024, calls=3,
                           device=str(dev), layers=4)
    busy_us = prof["device_busy_ms_per_prefill"] * 3 * 1e3
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["elementwise and copies"] = 0.0
    for kernel, us in prof["kernels_us"].items():
        name = next((n for n, pat in PROFILE_GROUPS if pat.search(kernel)),
                    "elementwise and copies")
        groups[name] += us
    shares = {name: us / busy_us for name, us in groups.items()}
    print(f"  mixtral-8x22b prefill profile (4 layers, 4 x 1024): device "
          f"busy {prof['device_busy_ms_per_prefill']:.3f} of a "
          f"{prof['device_window_ms_per_prefill']:.3f} ms window a prefill "
          f"(idle share {prof['device_idle_share']:.3f}); host "
          f"{prof['host_ms_per_prefill']:.3f} ms a prefill", flush=True)
    for name, share in shares.items():
        print(f"    {share:.3f} of busy  {name} "
              f"({groups[name] / 3 / 1e3:.4f} ms a prefill)", flush=True)
    for kernel, us in list(prof["kernels_us"].items())[:12]:
        print(f"    {us / 3 / 1e3:9.4f} ms a prefill  {kernel[:100]}",
              flush=True)
    return {"busy_shares": shares,
            **{k: v for k, v in prof.items() if k != "kernels_us"},
            "top_kernels_us": dict(list(prof["kernels_us"].items())[:12])}


def phase_main_paths(torch, dev):
    print("phase 3: main path, full-width smollm-360m", flush=True)
    smollm = phase_serve(
        torch, dev, "smollm-360m", 4, 8, 4, 16,
        {"flash_attention": 32, "rmsnorm": 65, "ssd": 0, "rmsnorm_gated": 0},
        {"flash_attention": 0, "rmsnorm": 65, "ssd": 0, "rmsnorm_gated": 0}, PREFILL_TOL)
    print("phase 3b: main path, full-width mamba2-130m", flush=True)
    mamba = phase_serve(
        torch, dev, "mamba2-130m", 4, 8, 4, 16,
        {"flash_attention": 0, "rmsnorm": 49, "ssd": 24, "rmsnorm_gated": 24},
        {"flash_attention": 0, "rmsnorm": 49, "ssd": 0, "rmsnorm_gated": 24}, MAMBA_PREFILL_TOL)
    print("phase 3c: main path, full-width zamba2-2.7b", flush=True)
    zamba = phase_serve(
        torch, dev, "zamba2-2.7b", 2, 4, 2, 8,
        {"flash_attention": 9, "rmsnorm": 127, "ssd": 54, "rmsnorm_gated": 54},
        {"flash_attention": 0, "rmsnorm": 127, "ssd": 0, "rmsnorm_gated": 54}, ZAMBA_PREFILL_TOL)
    print("phase 3d: main path, mixtral-8x22b at published widths",
          flush=True)
    mixtral = phase_serve(
        torch, dev, "mixtral-8x22b", 4, 8, 4, 8,
        {"flash_attention": 4, "rmsnorm": 9, "ssd": 0, "rmsnorm_gated": 0},
        {"flash_attention": 0, "rmsnorm": 9, "ssd": 0, "rmsnorm_gated": 0},
        PREFILL_TOL, layers=4)
    mixtral[0]["profile"] = profile_moe_prefill(torch, dev)
    print("phase 3e: main path, kimi-k2 at published widths", flush=True)
    kimi = phase_serve(
        torch, dev, "kimi-k2-1t-a32b", 2, 4, 2, 8,
        {"flash_attention": 1, "rmsnorm": 3, "ssd": 0, "rmsnorm_gated": 0},
        {"flash_attention": 0, "rmsnorm": 3, "ssd": 0, "rmsnorm_gated": 0}, PREFILL_TOL,
        layers=1, fp32="its float32 weights, 77.5 GB, and the bf16 ones "
                       "exceed the card")
    print("phase 3f: main path, full-width pixtral-12b fed embeddings",
          flush=True)
    pixtral = phase_serve(
        torch, dev, "pixtral-12b", 2, 4, 2, 8,
        {"flash_attention": 40, "rmsnorm": 81, "ssd": 0, "rmsnorm_gated": 0},
        {"flash_attention": 0, "rmsnorm": 81, "ssd": 0, "rmsnorm_gated": 0}, PREFILL_TOL,
        feed="embeds")
    print("phase 3g: main path, full-width seamless-m4t-large-v2",
          flush=True)
    seamless = phase_serve(
        torch, dev, "seamless-m4t-large-v2", 4, 8, 4, 8,
        {"flash_attention": 72, "rmsnorm": 122, "ssd": 0, "rmsnorm_gated": 0},
        {"flash_attention": 0, "rmsnorm": 73, "ssd": 0, "rmsnorm_gated": 0}, PREFILL_TOL,
        feed="encdec", cross=({"flash_attention": 24, "rmsnorm": 49,
                               "ssd": 0, "rmsnorm_gated": 0}, 16),
        fp32="the encoder casts the source embeddings to bf16, which a "
             "float32 model cannot take (in either package)")
    runs = {"smollm-360m": smollm, "mamba2-130m": mamba,
            "zamba2-2.7b": zamba, "mixtral-8x22b": mixtral,
            "kimi-k2-1t-a32b": kimi, "pixtral-12b": pixtral,
            "seamless-m4t-large-v2": seamless}
    metrics = {arch: m for arch, (m, _) in runs.items()}
    counts = {arch: c for arch, (_, c) in runs.items()}
    return metrics, counts


def phase_reference_checks(torch, dev):
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    print("phase 4: reference checks on small inputs", flush=True)
    for arch in ("smollm-360m", "gemma2-2b", "mamba2-130m", "zamba2-2.7b",
                 "mixtral-8x22b", "kimi-k2-1t-a32b", "pixtral-12b"):
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

    # the encoder-decoder in bf16 (its encoder casts the source to bf16,
    # which a float32 model cannot take), at the repository's bf16
    # tolerance
    cfg = reduced(ARCHS["seamless-m4t-large-v2"])
    cpu_params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    batch = {"src_embeds": torch.randn((2, 20, cfg.d_model), generator=gen),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=gen)}
    with torch.no_grad():
        want, _ = build_model(cfg, impl="naive", remat=False,
                              device="cpu").apply(cpu_params, batch)
        got, _ = build_model(cfg, impl="auto", remat=False, device=dev).apply(
            tree_map(lambda t: t.to(dev), cpu_params),
            {k: v.to(dev) for k, v in batch.items()})
    err = max_err(got.cpu(), want)
    check(err <= DECODE_TOL,
          f"reduced seamless bf16 (20 source frames, 24 tokens): kernel "
          f"path on the card vs plain path on the CPU, max diff {err:.3g} "
          f"(tol {DECODE_TOL})")

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

    cfg = reduced(ARCHS["mamba2-130m"])
    model = build_model(cfg, impl="auto", remat=False, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(6))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.init_cache(2, 25)
        errs = []
        for t in range(24):
            lg, cache = model.decode(params, cache, toks[:, t:t + 1], t)
            errs.append(max_err(lg[:, 0], full[:, t]))
    check(max(errs) <= DECODE_TOL,
          f"reduced mamba2 (24 tokens, chunk 16): recurrent decode vs the "
          f"SSD-kernel forward on the card, max diff {max(errs):.3g} "
          f"(tol {DECODE_TOL})")


def tree_max_err(torch, a, b):
    from repro_torch.tree import leaves
    return max(max_err(x, y) for x, y in zip(leaves(a), leaves(b)))


def tree_equal(torch, a, b):
    from repro_torch.tree import leaves
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def excess_over_two_steps(torch, a, b, p, lr0):
    """The largest of |a - b| - 2.2 lr0 - one bf16 ulp of p over a leaf,
    taken in slices of 2^26 elements (a may lie on the host)."""
    rows = 1 << 26
    a, b, p = a.reshape(-1), b.reshape(-1), p.reshape(-1)
    worst = float("-inf")
    for i in range(0, b.numel(), rows):
        sa = a[i:i + rows].to(b.device).float()
        sb, sp = b[i:i + rows].float(), p[i:i + rows].float()
        worst = max(worst, float(((sa - sb).abs() - 2.2 * lr0
                                  - 2.0 ** -7 * sp.abs()).max()))
    return worst


def check_bf16_step(torch, arch, new, metrics, plain_new, plain_metrics,
                    old, lr0, n_params):
    """Phase 5b's bf16 check: one step with the kernels (`new` params,
    on the card or the host) against the same step on the plain routes
    (`plain_new`) from `old`: the losses within TRAIN_LOSS_TOL, each
    updated weight within two steps (a gradient near zero may change
    sign) plus one bf16 ulp.  Returns (loss diff, weights that differ)."""
    from repro_torch.tree import leaves, named_leaves
    loss_err = abs(float(metrics["loss"]) - float(plain_metrics["loss"]))
    worst, differ = 0.0, 0
    for (_, a), b, p in zip(named_leaves(new), leaves(plain_new),
                            leaves(old)):
        worst = max(worst, excess_over_two_steps(torch, a, b, p, lr0))
        differ += int((a.to(b.device) != b).sum())
    check(loss_err <= TRAIN_LOSS_TOL and worst <= 0.0,
          f"{arch} bf16 step, kernels vs plain path: loss "
          f"{float(metrics['loss']):.5f} vs {float(plain_metrics['loss']):.5f}"
          f" (diff {loss_err:.3g}, tol {TRAIN_LOSS_TOL}); updated params "
          f"within two steps (2 lr = {2 * lr0:.3g}) plus one bf16 ulp; "
          f"{differ} of {n_params} weights differ")
    return loss_err, differ


def check_fp32_step(torch, arch, k1, km, q1, qm, lr0,
                    grad_tol=TRAIN_FP32_GRAD_TOL, settle_tol=None):
    """Phase 5b's float32 check: the step with the kernels (`k1`) and on
    the plain routes (`q1`) from the same float32 state: the loss within
    TRAIN_FP32_LOSS_RTOL; the first moments (0.1 x the clipped gradient)
    per leaf within `grad_tol` of the leaf's largest; where the
    first moment is clear of zero (twice `settle_tol`, by default
    `grad_tol`) the step's sign is settled and the updated weights agree
    to TRAIN_FP32_PARAM_TOL, elsewhere within two steps.  Returns (loss
    relative diff, first moments' error, settled weights' error)."""
    from repro_torch.tree import leaves
    fp32_rel = abs(float(km["loss"]) - float(qm["loss"])) / abs(
        float(qm["loss"]))
    mu_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                 for a, b in zip(leaves(k1["opt"]["mu"]),
                                 leaves(q1["opt"]["mu"])))
    p_err, unsettled, within_two = 0.0, 0, True
    for a, b, mu in zip(leaves(k1["params"]), leaves(q1["params"]),
                        leaves(q1["opt"]["mu"])):
        settled = mu.abs() > 2 * (settle_tol or grad_tol) * mu.abs().max()
        d = (a - b).abs()
        p_err = max(p_err, float(d[settled].max()) if settled.any() else 0.0)
        unsettled += int((~settled).sum())
        within_two &= float(d.max()) <= 2.2 * lr0 + 2.0 ** -22 * float(
            b.abs().max())
    check(fp32_rel <= TRAIN_FP32_LOSS_RTOL and mu_err <= grad_tol
          and p_err <= TRAIN_FP32_PARAM_TOL and within_two,
          f"{arch} float32 step, kernels vs plain path: loss relative diff "
          f"{fp32_rel:.3g} (tol {TRAIN_FP32_LOSS_RTOL}); first moments "
          f"(0.1 x clipped gradient) per leaf {mu_err:.3g} of the leaf's "
          f"largest (tol {grad_tol}); updated weights {p_err:.3g} "
          f"apart where the step's sign is settled (tol "
          f"{TRAIN_FP32_PARAM_TOL}; {unsettled} weights with a first moment "
          f"within {2 * (settle_tol or grad_tol):.3g} of the leaf's largest "
          f"held to two steps: "
          f"{within_two})")
    return fp32_rel, mu_err, p_err


def ssm_train_launches(cfg):
    """Launches of one train step with remat of an SSM arch: every
    Mamba2 block's pre-norm and gated norm, and each shared block's two
    norms, in the forward and again in remat's recompute, the final norm
    once; one norm backward a norm; the SSD forward twice and its
    backward once a mixer; the shared blocks' attention twice.  Of the
    norms, the gated ones (one a mixer: its forward twice, its backward
    once) also count in `rmsnorm_gated`."""
    mixers = cfg.n_layers
    shared = cfg.n_layers // cfg.shared_attn_every if \
        cfg.shared_attn_every else 0
    norms = 2 * mixers + 2 * shared
    return {"flash_attention": 2 * shared, "rmsnorm": 2 * norms + 1,
            "rmsnorm.bwd": norms + 1, "ssd": 2 * mixers, "ssd_bwd": mixers,
            "rmsnorm_gated": 2 * mixers, "rmsnorm_gated.bwd": mixers}


def phase_paper_plane(torch, dev, card):
    """11: the paper's analytic plane on the card, every call held to
    the port's own CPU route (`launch/paper_plane.py`)."""
    from repro_torch.launch.paper_plane import RTOL, run

    print("phase 11: the paper's analytic plane on the card", flush=True)
    t_phase = time.perf_counter()
    out = run(dev)
    phase_s = time.perf_counter() - t_phase
    secs = out["seconds"]
    for name, runs in secs.items():
        ratio, cpu_runs = "", secs.get(name + "_cpu")
        if cpu_runs:
            mid = statistics.median(runs)
            ratio = (f"; median {mid:.4f} s, "
                     f"{mid / statistics.median(cpu_runs):.3f} x the CPU "
                     f"route's median")
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in runs)} s wall"
              f"{ratio} ({card})")
    for name in ("paper_grid", "network_grid"):
        r = out["profile"][name]
        print(f"  one batched evaluate, {name} on "
              f"{out['profile']['trace']}: "
              f"{r.get('device_ops_per_evaluate', 'not measured')} device "
              f"ops, busy {r.get('device_busy_ms_per_evaluate', 'n/a')} ms "
              f"of a {r.get('device_window_ms_per_evaluate', 'n/a')} ms "
              f"window (idle share {r.get('device_idle_share', 'n/a')}), "
              f"host {r['host_ms_per_evaluate']:.3f} ms, "
              f"{r.get('host_syncs_per_evaluate', 'not measured')} host "
              f"syncs with its best point read ({card})")
    print(f"  host syncs of a sweep_all of {out['profile']['trace']} "
          f"(design space built, 64 and 96 Gb/s): "
          f"{out['profile'].get('host_syncs_sweep_all_one_trace')}")
    print(f"  the card's runs bit-equal: {out['bit_equal']}")
    print(f"  sweep_all summary (bw -> mean, max best speedup): "
          f"{out['summary']}")
    print(f"  balancer packets differing from the CPU route: "
          f"{out['balance_packets_differing_from_cpu']}")
    for line in out["failures"]:
        print(f"  FAILED: {line}")
    print(f"  phase 11 took {phase_s:.1f} s")
    check(not out["failures"],
          f"the analytic plane on the card agrees with its CPU route "
          f"(rtol {RTOL}, tie rule) and meets the paper's band "
          f"({len(out['failures'])} failures)")
    out["phase_s"] = phase_s
    return out


def phase_event_plane(torch, dev, card):
    """12: the event engine and the fault plane on the card, every call
    held to the port's own CPU route (`launch/event_plane.py`)."""
    from repro_torch.launch.event_plane import RTOL, run

    print("phase 12: the event engine and the fault plane on the card",
          flush=True)
    t_phase = time.perf_counter()
    out = run(dev)
    phase_s = time.perf_counter() - t_phase
    secs = out["seconds"]
    for name, runs in secs.items():
        if name.endswith("_cpu") and name[:-4] in secs:
            continue
        ratio, cpu_runs = "", secs.get(name + "_cpu")
        if cpu_runs:
            mid = statistics.median(runs)
            cmid = statistics.median(cpu_runs)
            ratio = (f"; CPU route {', '.join(f'{t:.4f}' for t in cpu_runs)}"
                     f" s; medians {mid:.4f} | {cmid:.4f} s, "
                     f"{mid / cmid:.3f} x the CPU route's")
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in runs)} s wall"
              f"{ratio} ({card})")
    print(f"  policy mean speedups over the 15 at 96 Gb/s: "
          f"{out['policy_mean_speedup']} (static grid best "
          f"{out['grid_best_mean']!r}); packets whose plane differs from "
          f"the CPU route: {out['policy_packets_differing_from_cpu']}")
    print(f"  fidelity worst speedup error: {out['fidelity_worst']}")
    print(f"  faulted vgg ({out['faulted']['scenario']}): striped "
          f"{out['faulted']['striped']}, xy {out['faulted']['xy']}, "
          f"adaptive refuses: {out['faulted'].get('adaptive_refuses')}")
    print(f"  retained-speedup means: {out['retained_mean']}; resharded "
          f"cells: {out['resharded_cells']}")
    for what, d in out["reshard"].items():
        print(f"  {what}: degraded {d['degraded_time']!r} s, rebuilt "
              f"{d['resharded_time']!r} s (migration "
              f"{d['migration_time']!r} s, eras {d['eras']}), shipped "
              f"{'rebuilt' if d['resharded'] else 'degraded'}")
    prof = out["profile"]
    r = prof["planned_static"]
    print(f"  one planned PacketSim.run('static') on {prof['trace']}: "
          f"{r.get('device_ops_per_run', 'not measured')} device ops, busy "
          f"{r.get('device_busy_ms_per_run', 'n/a')} ms of a "
          f"{r.get('device_window_ms_per_run', 'n/a')} ms window (idle "
          f"share {r.get('device_idle_share', 'n/a')}), host "
          f"{r['host_ms_per_run']:.3f} ms, "
          f"{r.get('host_syncs_per_run', 'not measured')} host syncs "
          f"({card})")
    print(f"  one greedy online run on {prof['trace']}: "
          f"{prof['online_greedy_host_ms']:.3f} ms on the host ({card})")
    for line in out["failures"]:
        print(f"  FAILED: {line}")
    print(f"  phase 12 took {phase_s:.1f} s")
    check(not out["failures"],
          f"the event engine and the fault plane on the card agree with "
          f"their CPU route (rtol {RTOL}, tie rule) and keep their bounds "
          f"({len(out['failures'])} failures)")
    out["phase_s"] = phase_s
    return out


def phase_ssm_train(torch, dev):
    """Full-width mamba2-130m (8 x 1024) and zamba2-2.7b (2 x 1024)
    trained on the card through `make_train_step` (bf16 weights from
    seed 0, AdamW, remat on, tokens from the data pipeline), the SSD
    scan differentiated by its backward kernel."""
    import dataclasses
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.train import device_batch, train_loop
    from repro_torch.models import param_count
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import (TrainConfig, make_loss_fn,
                                           make_train_step, value_and_grad)
    from repro_torch.tree import leaves, tree_map

    wrappers = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "ssd": ssd}

    def reset():
        for w in wrappers.values():
            w.launches = 0
        rmsnorm.bwd_launches = ssd.bwd_launches = 0
        rmsnorm.gated_launches = rmsnorm.gated_bwd_launches = 0
        flash_attention.tc_launches = ssd.tc_launches = 0
        ssd.bwd_tc_launches = 0

    def read():
        c = {k: w.launches for k, w in wrappers.items()}
        c.update({"rmsnorm.bwd": rmsnorm.bwd_launches,
                  "ssd_bwd": ssd.bwd_launches,
                  "rmsnorm_gated": rmsnorm.gated_launches,
                  "rmsnorm_gated.bwd": rmsnorm.gated_bwd_launches})
        return c, {"flash_attention": flash_attention.tc_launches,
                   "ssd": ssd.tc_launches, "ssd_bwd": ssd.bwd_tc_launches}

    print("phase 10: training the SSM models on the card", flush=True)
    torch.cuda.empty_cache()
    metrics, counts = {}, {}
    for arch, B, S in (("mamba2-130m", 8, 1024), ("zamba2-2.7b", 2, 1024)):
        t_arch = time.perf_counter()
        full_check = arch == "mamba2-130m"
        cfg = ARCHS[arch]
        dcfg = DataConfig(seq_len=S, global_batch=B,
                          vocab_size=cfg.vocab_size)
        opt = OptimizerConfig(lr=1e-3, warmup_steps=2,
                              total_steps=TRAIN_STEPS)
        lr0 = float(opt.lr) / opt.warmup_steps

        def tcfg(impl):
            return TrainConfig(optimizer=opt, attention_impl=impl,
                               remat=True)

        step_fn, init_fn = make_train_step(cfg, tcfg("auto"), dev)
        plain_fn, _ = make_train_step(cfg, tcfg("naive"), dev)

        def batch_fn(step):
            return device_batch(cfg, dcfg, step, dev)

        def initial_state():
            return init_fn(torch.Generator(device=dev).manual_seed(0))

        state0 = initial_state()
        n_params = param_count(state0["params"])
        b0 = batch_fn(0)

        # launches of one step, derived from the model; every forward
        # launch of the bf16 step on a tensor-core kernel
        expected = ssm_train_launches(cfg)
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state1, m1 = step_fn(state0, b0)
        torch.cuda.synchronize()
        first_step_s = time.perf_counter() - t0
        got, tc = read()
        check(got == expected and tc == {"flash_attention":
                                         expected["flash_attention"],
                                         "ssd": expected["ssd"],
                                         "ssd_bwd": expected["ssd_bwd"]},
              f"{arch} train step launched {got} (expected {expected}: "
              f"{cfg.n_layers} Mamba2 mixers, remat's recompute included; "
              f"tensor-core launches {tc})")
        check(all(bool(torch.isfinite(t).all()) for t in leaves(state1))
              and int(state1["step"]) == 1,
              f"{arch} one step: loss {float(m1['loss']):.5f}, every leaf "
              f"of the new state finite")
        counts[f"{arch}-train"] = got

        # the same step on the plain routes (ssd_scan, plain attention and
        # norms); the kernels' new params wait on the host, so that three
        # states of zamba2 never share the card
        new_params = tree_map(lambda t: t.cpu(), state1["params"])
        del state1
        p1, pm1 = plain_fn(state0, b0)
        loss_err, differ = check_bf16_step(
            torch, arch, new_params, m1, p1["params"], pm1,
            state0["params"], lr0, n_params)
        del p1, new_params
        m = {"params": n_params, "first_step_s": first_step_s,
             "loss_kernels_vs_plain_bf16": loss_err,
             "weights_differing_bf16": differ,
             "first_step_peak_memory_bytes":
                 torch.cuda.max_memory_allocated()}
        # float32 weights: the loss and each leaf's gradient (what the
        # first moments hold, before the factor 0.1 and the clip) on the
        # kernel routes, the plain routes, and the plain routes with the
        # scan at chunk 64 (the config's: 256); for mamba2 also the plain
        # routes in float64, the reference each float32 route's error is
        # read against.  For zamba2 the float32 gradients are the whole
        # float32 check: two float32 AdamW states of its 2.7e9
        # parameters, or its float64 gradient, besides the weights do not
        # fit one card
        params32 = tree_map(lambda t: t.float(), state0["params"])
        if not full_check:
            state0 = None
        torch.cuda.empty_cache()
        grads = {}
        for route, rcfg, impl in (
                ("kernels", cfg, "auto"), ("plain", cfg, "naive"),
                ("plain-64", dataclasses.replace(cfg, ssm_chunk=64),
                 "naive")):
            loss_fn = make_loss_fn(rcfg, TrainConfig(
                attention_impl=impl, remat=True), dev)
            (loss, _), g = value_and_grad(loss_fn, params32, b0)
            grads[route] = (float(loss), g if route == "plain" else
                            tree_map(lambda t: t.cpu(), g))
            del g
        if full_check:
            grads["float64"] = float64_loss_and_grad(torch, cfg, params32,
                                                     b0, dev)

        def rel(a, b):
            """(loss, worst leaf's gradient) of route a against route b,
            each relative to b's (the gradient's to the leaf's largest)"""
            (la, ga), (lb, gb) = grads[a], grads[b]
            return abs(la - lb) / abs(lb), max(
                float((x.to(dev).double() - y.to(dev).double()).abs().max())
                / max(float(y.abs().max()), 1e-30)
                for x, y in zip(leaves(ga), leaves(gb)))

        fp32_rel, g_err = rel("kernels", "plain")
        spread_rel, spread = rel("plain-64", "plain")
        m.update(loss_rel_kernels_vs_plain_fp32_grads=fp32_rel,
                 grad_rel_kernels_vs_plain_fp32=g_err,
                 grad_rel_plain_chunk_64_vs_256_fp32=spread)
        if full_check:
            k_rel, k_err = rel("kernels", "float64")
            p_rel, p_err = rel("plain", "float64")
            check(max(k_rel, p_rel) <= TRAIN_FP32_LOSS_RTOL
                  and max(k_err, p_err) <= SSM_TRAIN_FP32_GRAD_TOL,
                  f"{arch} float32 loss and gradients against the plain "
                  f"routes' float64: kernel routes {k_rel:.3g} (loss, "
                  f"relative) and {k_err:.3g} (gradients per leaf, of the "
                  f"leaf's largest), plain routes {p_rel:.3g} and "
                  f"{p_err:.3g} (tol {TRAIN_FP32_LOSS_RTOL} and "
                  f"{SSM_TRAIN_FP32_GRAD_TOL})")
            m.update(loss_rel_kernels_vs_float64=k_rel,
                     grad_rel_kernels_vs_float64=k_err,
                     loss_rel_plain_vs_float64=p_rel,
                     grad_rel_plain_vs_float64=p_err)
        # two float32 routes, each within the bound of float64, are within
        # twice it of each other
        check(fp32_rel <= TRAIN_FP32_LOSS_RTOL
              and g_err <= 2 * SSM_TRAIN_FP32_GRAD_TOL,
              f"{arch} float32 loss and gradients, kernels vs plain path: "
              f"loss relative diff {fp32_rel:.3g} (tol "
              f"{TRAIN_FP32_LOSS_RTOL}); gradients per leaf {g_err:.3g} of "
              f"the leaf's largest (tol {2 * SSM_TRAIN_FP32_GRAD_TOL}); two "
              f"plain routes (the scan at chunk 64 and 256) {spread:.3g} "
              f"apart, loss {spread_rel:.3g}")
        del grads, params32
        if full_check:
            # float32 weights, whole AdamW steps (phase 5b's checks): the
            # first moments within twice the bound; a weight's step sign
            # is settled where its first moment is clear of zero by twice
            # what this run read the two routes' gradients off float64
            state0_f32 = dict(state0, params=tree_map(lambda t: t.float(),
                                                      state0["params"]))
            k1, km = step_fn(state0_f32, b0)
            q1, qm = plain_fn(state0_f32, b0)
            m["loss_rel_kernels_vs_plain_fp32"], \
                m["first_moment_rel_kernels_vs_plain_fp32"], \
                m["params_max_diff_settled_fp32"] = check_fp32_step(
                    torch, arch, k1, km, q1, qm, lr0,
                    2 * SSM_TRAIN_FP32_GRAD_TOL, k_err + p_err)
            del k1, q1, state0_f32
        del state0
        torch.cuda.empty_cache()

        # steps through the launcher's loop, from the seed's state again
        # (zamba2: a step holds two AdamW states of 27 GB; AdamW walks its
        # largest leaves in slices, `optim.ADAMW_SLICE`, so that chained
        # steps fit the card)
        n_steps = TRAIN_STEPS if full_check else ZAMBA_TRAIN_STEPS
        ckdir = ROOT / "build" / "chip_smoke_ssm_ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        ck = AsyncCheckpointer(str(ckdir), keep=1)
        torch.cuda.reset_peak_memory_stats()
        state, stats = train_loop(step_fn, initial_state(), batch_fn,
                                  n_steps, ck, ckpt_every=n_steps + 1,
                                  log_every=n_steps,
                                  restart_fn=initial_state)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        ce = [stats["ce"][i] for i in range(n_steps)]
        warm = sorted(stats["step_s"][i] for i in range(2, n_steps))
        step_s = warm[len(warm) // 2]
        ok = stats["recoveries"] == 0 and stats["steps_run"] == n_steps
        if full_check:
            ce_end = sum(ce[-3:]) / 3
            check(ok and ce_end < ce[0] - TRAIN_CE_DROP,
                  f"{arch}: {n_steps} steps, ce {ce[0]:.4f} -> {ce[-1]:.4f} "
                  f"(the last 3 average {ce_end:.4f}, must be more than "
                  f"{TRAIN_CE_DROP} below the first), {stats['recoveries']} "
                  f"recoveries")
        else:
            check(ok and all(math.isfinite(c) for c in ce),
                  f"{arch}: {n_steps} steps through train_loop, ce "
                  f"{ce[0]:.4f} -> {ce[-1]:.4f}, finite, "
                  f"{stats['recoveries']} recoveries")
        m.update(ce=ce, recoveries=stats["recoveries"], steps=n_steps)
        del state
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        tokens = B * S
        mfu = 6 * n_params * tokens / step_s / PEAK_BF16_FLOPS
        m.update(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                 peak_memory_bytes=peak_bytes, mfu_6nt=mfu, launches=got)
        counted = ""
        if full_check:
            # the same step counted (plain routes, fake tensors): remat's
            # replay and the scan's chunked products included
            flops = count_train_step(torch, cfg, tcfg("naive"), B, S)[0].flops
            m.update(mfu_count=flops / step_s / PEAK_BF16_FLOPS,
                     count_flops_per_step=flops)
            counted = (f"MFU {m['mfu_count']:.4f} from the count ({flops:.4g}"
                       f" FLOPs a step over 989 TFLOP/s), ")
        print(f"  {arch} train step {step_s * 1e3:.2f} ms (median of steps "
              f"3-{n_steps} through train_loop; first {first_step_s:.2f} s), "
              f"{tokens / step_s:,.0f} tokens/s, peak memory {peak_bytes} B, "
              f"{counted}MFU {mfu:.4f} from 6 N T ({n_params} parameters); "
              f"phase {time.perf_counter() - t_arch:.1f} s", flush=True)
        metrics[f"{arch}-train"] = m
    return metrics, counts


def phase_train(torch, dev):
    """Full-width smollm-360m training (bf16 weights from seed 0, AdamW,
    remat on, 8 x 1024 tokens a step from the data pipeline)."""
    import shutil

    from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                     latest_steps, restore)
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.profile import profile_train
    from repro_torch.launch.train import device_batch, train_loop
    from repro_torch.models import param_count
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves, tree_map

    print("phase 5: training, full-width smollm-360m", flush=True)
    arch, B, S = "smollm-360m", 8, 1024
    cfg = ARCHS[arch]
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)

    def tcfg(impl):
        return TrainConfig(optimizer=opt, attention_impl=impl, remat=True)

    step_fn, init_fn = make_train_step(cfg, tcfg("auto"), dev)
    plain_fn, _ = make_train_step(cfg, tcfg("naive"), dev)

    def batch_fn(step):
        return device_batch(cfg, dcfg, step, dev)

    state0 = init_fn(torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(state0["params"])
    b0 = batch_fn(0)

    # 5a: launches of one step, derived from the model: every block's norm
    # runs in the forward and again in remat's recompute, the final norm
    # once; every attention block likewise; one norm backward per norm
    blocks = len(cfg.unit) * cfg.n_units
    attn = sum(b.kind == "attn" for b in cfg.unit) * cfg.n_units
    expected = {"flash_attention": 2 * attn, "rmsnorm": 2 * blocks + 1,
                "rmsnorm.bwd": blocks + 1, "ssd": 0}
    for w in (flash_attention, rmsnorm, ssd):
        w.launches = 0
    rmsnorm.bwd_launches = flash_attention.tc_launches = 0
    t0 = time.perf_counter()
    state1, m1 = step_fn(state0, b0)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "rmsnorm": rmsnorm.launches,
              "rmsnorm.bwd": rmsnorm.bwd_launches, "ssd": ssd.launches}
    check(counts == expected and flash_attention.tc_launches == 2 * attn,
          f"{arch} train step launched {counts} (expected {expected}: "
          f"{blocks} blocks, {attn} attention, remat's recompute included; "
          f"all {flash_attention.tc_launches} flash launches on the "
          f"tensor-core kernel)")
    check(all(bool(torch.isfinite(t).all()) for t in leaves(state1))
          and int(state1["step"]) == 1,
          f"{arch} one step: loss {float(m1['loss']):.5f}, every leaf of "
          f"the new state finite")

    # 5b: the same step on the plain path (plain attention and norms)
    p1, pm1 = plain_fn(state0, b0)
    lr0 = float(opt.lr) / opt.warmup_steps
    loss_err, differ = check_bf16_step(
        torch, arch, state1["params"], m1, p1["params"], pm1,
        state0["params"], lr0, n_params)
    del p1
    # ... and with float32 weights: the first moments (0.1 x the clipped
    # gradient) agree per leaf; the loss to TRAIN_FP32_LOSS_RTOL
    state0_f32 = dict(state0, params=tree_map(lambda t: t.float(),
                                              state0["params"]))
    k1, km = step_fn(state0_f32, b0)
    q1, qm = plain_fn(state0_f32, b0)
    fp32_rel, mu_err, p_err = check_fp32_step(torch, arch, k1, km, q1, qm,
                                              lr0)
    del k1, q1, state0_f32, state1, state0
    torch.cuda.empty_cache()

    # 5c: TRAIN_STEPS steps through the launcher's loop, checkpoints async;
    # the initial state is made again from its seed, so that no reference
    # outside the loop keeps it alive (peak memory is the loop's own)
    def initial_state():
        return init_fn(torch.Generator(device=dev).manual_seed(0))

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = AsyncCheckpointer(str(ckdir), keep=3)
    torch.cuda.reset_peak_memory_stats()
    state, stats = train_loop(step_fn, initial_state(), batch_fn,
                              TRAIN_STEPS, ck, ckpt_every=10,
                              log_every=TRAIN_STEPS,
                              restart_fn=initial_state)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
    ck.save_async(state, TRAIN_STEPS)
    ck.wait()
    ce = [stats["ce"][i] for i in range(TRAIN_STEPS)]
    ce_end = sum(ce[-3:]) / 3
    check(stats["recoveries"] == 0 and stats["steps_run"] == TRAIN_STEPS
          and ce_end < ce[0] - TRAIN_CE_DROP,
          f"{arch}: {TRAIN_STEPS} steps, ce {ce[0]:.4f} -> {ce[-1]:.4f} (the "
          f"last 3 average {ce_end:.4f}, must be more than {TRAIN_CE_DROP} "
          f"below the first), {stats['recoveries']} recoveries; checkpoints "
          f"{latest_steps(str(ckdir))}")
    warm = sorted(stats["step_s"][i] for i in range(2, TRAIN_STEPS))
    step_s = warm[len(warm) // 2]

    # 5d: restore into a fresh state; the next step matches the
    # uninterrupted run bit for bit
    fresh = init_fn(torch.Generator(device=dev).manual_seed(1))
    restored = restore(str(ckdir), fresh)
    check(tree_equal(torch, restored, state)
          and int(restored["step"]) == TRAIN_STEPS,
          f"{arch}: checkpoint step {TRAIN_STEPS} restored into a fresh "
          f"state, bit for bit (bf16 params, fp32 moments, int32 step)")
    del fresh
    nb = batch_fn(TRAIN_STEPS)
    cont, cm = step_fn(state, nb)
    again, am = step_fn(restored, nb)
    diff = tree_max_err(torch, cont, again)
    check(tree_equal(torch, cont, again) and float(cm["loss"]) == float(
        am["loss"]),
          f"{arch}: step {TRAIN_STEPS} from the restored state matches the "
          f"uninterrupted run bit for bit (max diff {diff:.3g}, loss "
          f"{float(cm['loss']):.6f})")
    del cont, again, restored, state
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 5e: where a step's device time goes (torch.profiler, 3 warm steps)
    prof = profile_train(arch, B, S, calls=3, device=str(dev))
    top = list(prof["kernels_us"].items())[:8]

    tokens = B * S
    H, D = cfg.n_heads, cfg.head_dim
    attn_flops = 3 * 4 * B * H * D * (S * (S + 1) // 2) * attn
    model_flops = 6 * n_params * tokens + attn_flops
    mfu = model_flops / step_s / PEAK_BF16_FLOPS
    # the same step counted (plain routes, fake tensors): remat's replay
    # and the attention's masked half included, as the card runs them
    counted = count_train_step(torch, cfg, tcfg("naive"), B, S)
    mfu_count = counted[0].flops / step_s / PEAK_BF16_FLOPS
    bwd_share_of_step = prof["plain_attention_bwd_ms_per_step"] / (
        step_s * 1e3)
    print(f"  {arch} train step {step_s * 1e3:.2f} ms (median of steps 2-"
          f"{TRAIN_STEPS - 1}; first {first_step_s:.2f} s), {tokens / step_s:,.0f} "
          f"tokens/s, peak memory {peak_bytes} B, MFU {mfu:.4f} "
          f"({model_flops:.4g} model FLOPs a step over 989 TFLOP/s), "
          f"{mfu_count:.4f} from the count ({counted[0].flops:.4g} FLOPs "
          f"a step); "
          f"profile: device busy {prof['device_busy_ms_per_step']:.2f} of "
          f"{prof['device_window_ms_per_step']:.2f} ms a step (idle share "
          f"{prof['device_idle_share']:.3f}), plain attention backward "
          f"{prof['plain_attention_bwd_ms_per_step']:.2f} ms a step "
          f"({prof['plain_attention_bwd_share_of_busy']:.3f} of busy, "
          f"{bwd_share_of_step:.3f} of the untraced step)", flush=True)
    for name, us in top:
        print(f"    {us / 3 / 1e3:9.4f} ms a step  {name[:100]}", flush=True)
    metrics = {
        "step_ms": step_s * 1e3, "first_step_s": first_step_s,
        "tokens_per_s": tokens / step_s, "peak_memory_bytes": peak_bytes,
        "mfu": mfu, "model_flops_per_step": model_flops, "params": n_params,
        "mfu_count": mfu_count, "count_flops_per_step": counted[0].flops,
        "ce_first": ce[0], "ce_last": ce[-1], "ce": ce,
        "recoveries": stats["recoveries"],
        "loss_kernels_vs_plain_bf16": loss_err,
        "loss_rel_kernels_vs_plain_fp32": fp32_rel,
        "first_moment_rel_kernels_vs_plain_fp32": mu_err,
        "params_max_diff_settled_fp32": p_err,
        "weights_differing_bf16": differ,
        "resume_max_diff": diff,
        "plain_attention_bwd_share_of_step": bwd_share_of_step,
        "profile": {k: v for k, v in prof.items() if k != "kernels_us"},
        "profile_top_kernels_us": dict(top)}
    counts = {"flash_attention": counts["flash_attention"],
              "rmsnorm": counts["rmsnorm"], "ssd": counts["ssd"],
              "rmsnorm.bwd": counts["rmsnorm.bwd"]}
    return metrics, counts, counted


@contextlib.contextmanager
def recorded_drops(torch):
    """The rows each capacity-bucketed expert call (`moe._grouped_ffn`)
    drops, in call order: one bool tensor a call, True where a row is
    past its expert's capacity (padding rows are not counted).  Counted
    here from a stable sort of the expert ids, apart from the port's
    cumulative-sum positions."""
    from repro_torch.models import moe
    log, inner = [], moe._grouped_ffn

    def recording(rows, ids, n_experts, cap, *weights):
        order = ids.argsort(stable=True)
        sorted_ids = ids[order]
        # a row's rank among its expert's rows: its index in the sorted
        # ids less the index of that expert's first row
        rank = (torch.arange(ids.numel(), device=ids.device)
                - torch.searchsorted(sorted_ids, sorted_ids))
        dropped = torch.zeros_like(ids, dtype=torch.bool)
        dropped[order] = (rank >= cap) & (sorted_ids < n_experts)
        log.append(dropped)
        return inner(rows, ids, n_experts, cap, *weights)

    moe._grouped_ffn = recording
    try:
        yield log
    finally:
        moe._grouped_ffn = inner


def start_group(torch, dev):
    """The launchers' 1-rank group (`launch.mesh.init_process_group`),
    and one all-reduce on the card to prove NCCL up (its start is lazy).
    Raises if either fails."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    init_process_group("cuda")
    backend = str(dist.get_backend())
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    torch.cuda.synchronize()
    check("nccl" in backend and float(one) == 1.0
          and dist.get_world_size() == 1,
          f"process group: 1 rank, backend {backend!r}; an all-reduce on "
          f"the card returns {float(one)}")
    return backend


def check_expert_parallel(torch, dev):
    """Phase 4's check of the explicit MoE path: reduced mixtral's block
    at the default capacity 1.25, float32, on the card's host mesh and on
    the CPU's, at a prefill-like 2 x 64 tokens and a decode-like 4 x 1
    (where each expert's bucket holds one row): the same rows dropped,
    values within PARITY_TOL."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.runtime.parallel import ParallelContext, parallel_context

    cfg = reduced(ARCHS["mixtral-8x22b"])
    gen = torch.Generator().manual_seed(8)
    params = {k: v.float() for k, v in moe.moe_init(gen, cfg).items()}
    out = {}
    for shape in ((2, 64), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen)
        runs = {}
        for where in ("cpu", "cuda"):
            calls = moe.moe_block_expert_parallel.calls
            with recorded_drops(torch) as drops, \
                    use_mesh(make_host_mesh(where)), \
                    parallel_context(ParallelContext()):
                y, aux = moe.moe_block({k: v.to(where) for k, v in
                                        params.items()}, x.to(where), cfg)
            runs[where] = (y.cpu(), float(aux), [d.cpu() for d in drops],
                           moe.moe_block_expert_parallel.calls - calls)
        (y_cpu, aux_cpu, d_cpu, n_cpu), (y_card, aux_card, d_card, n_card) \
            = runs.values()
        same = len(d_cpu) == len(d_card) == 1 and all(
            torch.equal(a, b) for a, b in zip(d_cpu, d_card))
        n_dropped = int(d_cpu[0].sum())
        err = max_err(y_card, y_cpu)
        check(n_cpu == n_card == 1 and same
              and err <= PARITY_TOL and abs(aux_card - aux_cpu) <= PARITY_TOL,
              f"reduced mixtral expert-parallel block ({shape[0]} x "
              f"{shape[1]} tokens, capacity 1.25, float32): card vs CPU "
              f"drop the same {n_dropped} of {d_cpu[0].numel()} expert rows; "
              f"max diff {err:.3g}, aux {aux_card:.6f} vs {aux_cpu:.6f} (tol "
              f"{PARITY_TOL})")
        out[f"{shape[0]}x{shape[1]}"] = {"max_diff": err,
                                         "rows_dropped": n_dropped}
    check(sum(v["rows_dropped"] for v in out.values()) > 0,
          "the capacity dropped rows in these checks")
    return out


def phase_distributed_serve(torch, dev):
    """6a: mixtral-8x22b (published widths, 4 layers, bf16 weights from
    seed 0, as phase 3d) served under the launcher's host mesh and
    context."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.models import build_model, moe
    from repro_torch.runtime.parallel import ParallelContext, parallel_context
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns

    print("phase 6a: distribution, mixtral-8x22b on the host mesh under "
          "the launcher's context", flush=True)
    arch, batch, slots, n_requests, max_new = "mixtral-8x22b", 4, 4, 8, 8
    cfg = dataclasses.replace(ARCHS[arch], n_layers=4, unit=())
    mesh = make_host_mesh("cuda")
    print(f"  mesh {mesh.shape} on {mesh.device_type}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, remat=False, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    inputs = {"tokens": tokens}
    scfg = ServeConfig(max_len=96)
    prefill, _, _ = make_serve_fns(cfg, scfg, dev)
    wrappers = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "ssd": ssd}
    ep = moe.moe_block_expert_parallel

    def counted():
        return {k: w.launches for k, w in wrappers.items()}

    ctx = ParallelContext()
    for w in wrappers.values():
        w.launches = 0
    ep.calls = flash_attention.tc_launches = 0
    with use_mesh(mesh), parallel_context(ctx):
        logits = prefill(params, inputs)
    torch.cuda.synchronize()
    in_prefill, ep_prefill = counted(), ep.calls
    results, stats = serve_loop(params, cfg, scfg,
                                make_requests(n_requests, cfg.vocab_size),
                                slots, max_new, dev, mesh)
    torch.cuda.synchronize()
    counts, ep_total = counted(), ep.calls
    peak_bytes = torch.cuda.max_memory_allocated()
    steps = stats["steps"]
    per_prefill = {"flash_attention": 4, "rmsnorm": 9, "ssd": 0}
    per_step = {"flash_attention": 0, "rmsnorm": 9, "ssd": 0}
    check(in_prefill == per_prefill and ep_prefill == cfg.n_layers
          and flash_attention.tc_launches == 4,
          f"{arch} prefill under the context launched {in_prefill} "
          f"(expected {per_prefill}) and called moe_block_expert_parallel "
          f"{ep_prefill} times (one a layer: {cfg.n_layers})")
    in_loop = {k: counts[k] - in_prefill[k] for k in counts}
    check(in_loop == {k: n * steps for k, n in per_step.items()}
          and ep_total - ep_prefill == cfg.n_layers * steps,
          f"{arch} loop under the context: {steps} steps launched {in_loop} "
          f"and {ep_total - ep_prefill} expert-parallel calls "
          f"({cfg.n_layers} a step)")
    check(logits.shape == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and stats["served"] == n_requests
          and all(len(r) == max_new for r in results.values())
          and all(0 <= t < cfg.vocab_size for r in results.values()
                  for t in r),
          f"{arch}: prefill logits finite; all {n_requests} requests served "
          f"with {max_new} tokens in the vocabulary; {stats['tok_per_s']:.2f} "
          f"tokens/s, peak memory {peak_bytes} B")

    # the loop again, warm (its first steps above met new shapes)
    _, warm = serve_loop(params, cfg, scfg,
                         make_requests(n_requests, cfg.vocab_size), slots,
                         max_new, dev, mesh)
    print(f"  {arch} loop again, warm: {warm['tok_per_s']:.2f} tokens/s",
          flush=True)

    # the rows the capacity drops: per layer in prefill, per decode step
    with recorded_drops(torch) as drops, use_mesh(mesh), parallel_context(ctx):
        prefill(params, inputs)
    prefill_drops = [int(d.sum()) for d in drops]
    prefill_rows = drops[0].numel()
    with recorded_drops(torch) as drops:
        serve_loop(params, cfg, scfg, make_requests(n_requests,
                                                    cfg.vocab_size),
                   slots, max_new, dev, mesh)
    per_call = [int(d.sum()) for d in drops]
    step_drops = [sum(per_call[i:i + cfg.n_layers])
                  for i in range(0, len(per_call), cfg.n_layers)]
    print(f"  {arch} capacity 1.25: rows dropped per layer in prefill "
          f"{prefill_drops} of {prefill_rows} bucketed rows a layer "
          f"(8192 routed); per decode step (4 layers, {slots * 2} routed "
          f"rows a layer) {step_drops}", flush=True)
    check(len(prefill_drops) == cfg.n_layers
          and len(step_drops) == steps,
          f"{arch}: drops recorded for every layer of the prefill and "
          f"every decode step")

    # nothing drops at capacity factor 8 (an expert's bucket holds every
    # routed row): the prefill against the dropless path, on the rows
    # whose routes agree
    roomy = ParallelContext(capacity_factor=float(cfg.n_experts))

    def under(c):
        def run():
            with use_mesh(mesh), parallel_context(c):
                return prefill(params, inputs)
        return run

    with recorded_drops(torch) as drops:
        err, agree, rows, flipped, _, _ = compare_prefills(
            torch, under(roomy), lambda: prefill(params, inputs), batch)
    roomy_drops = sum(int(d.sum()) for d in drops)
    check(roomy_drops == 0 and err <= PREFILL_TOL,
          f"{arch} prefill at capacity factor {roomy.capacity_factor} "
          f"(no row dropped: {roomy_drops}) vs the dropless path: max diff "
          f"{err:.4g} over the {rows}/{batch} rows whose routes agree (tol "
          f"{PREFILL_TOL}; {flipped} of {batch * 1024} tokens changed "
          f"experts); argmax agrees on {agree}/{rows}")
    prefill_ms, _ = cuda_ms(torch, under(ctx), 5)
    dropless_ms, _ = cuda_ms(torch, lambda: prefill(params, inputs), 5)

    # the bucketed expert products at the prefill's shape: the 8192
    # routed rows of one layer (arriving as 10240 rows with the padding of
    # the send budget C), 8 buckets of cap_e = 1280
    gen = torch.Generator(device=dev).manual_seed(2)
    j = next(j for j, b in enumerate(cfg.unit) if b.kind == "moe")
    layer = {k: v[0] for k, v in params["units"][f"b{j}"]["moe"].items()}
    n_rows, cap = 10240, 1280
    ids = torch.randint(0, cfg.n_experts, (n_rows,), device=dev,
                        generator=gen)
    ids[8192:] = cfg.n_experts
    bucket_in = torch.randn((n_rows, cfg.d_model), device=dev,
                            generator=gen, dtype=torch.bfloat16)
    ws = (layer["w_gate"], layer["w_up"], layer["w_down"])
    ffn_ms, _ = cuda_ms(torch, lambda: moe._grouped_ffn(
        bucket_in, ids, cfg.n_experts, cap, *ws), 3)
    ff = cfg.moe_d_ff
    ffn_flops = 3 * 2 * cfg.n_experts * cap * cfg.d_model * ff
    grouped_flops = 3 * 2 * 8192 * cfg.d_model * ff
    print(f"  {arch} prefill under the context {prefill_ms:.3f} ms "
          f"(dropless path {dropless_ms:.3f} ms); the bucketed expert "
          f"products (torch.bmm over 8 x {cap} rows) {ffn_ms:.4f} ms a "
          f"layer, {ffn_flops / grouped_flops:.3f}x the grouped GEMM's "
          f"operations (bound {ffn_flops / PEAK_BF16_FLOPS * 1e3:.4f} ms)",
          flush=True)
    del params, logits, bucket_in, layer, ws
    torch.cuda.empty_cache()
    metrics = {
        "prefill_ms": prefill_ms, "dropless_prefill_ms": dropless_ms,
        "prefill_calls_expert_parallel": ep_prefill,
        "decode_tok_per_s": stats["tok_per_s"], "decode_steps": steps,
        "decode_tok_per_s_warm": warm["tok_per_s"],
        "decode_wall_s": stats["wall_s"], "peak_memory_bytes": peak_bytes,
        "prefill_rows_dropped_per_layer": prefill_drops,
        "prefill_bucketed_rows_per_layer": prefill_rows,
        "decode_rows_dropped_per_step": step_drops,
        "no_drop_prefill_max_diff_vs_dropless": err,
        "no_drop_rows_compared": rows, "no_drop_argmax_agree": agree,
        "no_drop_tokens_route_flipped": flipped,
        "bucketed_ffn_ms": ffn_ms,
        "bucketed_ffn_bound_ms": ffn_flops / PEAK_BF16_FLOPS * 1e3,
        "bucketed_ffn_ops_vs_grouped": ffn_flops / grouped_flops}
    return metrics, counts


def phase_distributed_train(torch, dev):
    """6b: full-width smollm-360m (bf16 weights from seed 0, AdamW,
    remat, 8 x 1024 tokens a step) trained through `train_loop` on the
    host mesh, as `launch/train.py --mesh host` does."""
    import shutil

    from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                     restore, save)
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.launch.train import device_batch, train_loop
    from repro_torch.optim.optimizers import OptimizerConfig, cosine_lr
    from repro_torch.runtime.parallel import ParallelContext, parallel_context
    from repro_torch.runtime.sharding import place, state_shardings
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves, named_leaves

    print("phase 6b: distribution, smollm-360m trained on the host mesh",
          flush=True)
    arch, B, S, n = "smollm-360m", 8, 1024, 3
    cfg = ARCHS[arch]
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(optimizer=opt, remat=True)
    mesh = make_host_mesh("cuda")
    mesh_step, init_fn = make_train_step(cfg, tcfg, dev, mesh=mesh)
    plain_step, _ = make_train_step(cfg, tcfg, dev)

    def batch_fn(step):
        return device_batch(cfg, dcfg, step, dev)

    state0 = init_fn(torch.Generator(device=dev).manual_seed(0))
    sh = state_shardings(mesh, state0, "adamw")
    ckdir = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    blocks = len(cfg.unit) * cfg.n_units
    attn = sum(b.kind == "attn" for b in cfg.unit) * cfg.n_units
    per_step = {"flash_attention": 2 * attn, "rmsnorm": 2 * blocks + 1,
                "rmsnorm.bwd": blocks + 1, "ssd": 0}
    with use_mesh(mesh), parallel_context(ParallelContext()):
        placed = place(state0, sh)
        same = all(tuple(t.placements) == s.placements
                   for t, (_, s) in zip(leaves(placed), named_leaves(sh)))
        check(same, f"{arch}: the state placed by state_shardings on "
                    f"{mesh.shape} ({len(leaves(placed))} DTensor leaves)")
        for w in (flash_attention, rmsnorm, ssd):
            w.launches = 0
        rmsnorm.bwd_launches = 0
        state, stats = train_loop(mesh_step, placed, batch_fn, n,
                                  AsyncCheckpointer(str(ckdir)),
                                  ckpt_every=n + 1, log_every=n)
        torch.cuda.synchronize()
        counts = {"flash_attention": flash_attention.launches,
                  "rmsnorm": rmsnorm.launches,
                  "rmsnorm.bwd": rmsnorm.bwd_launches, "ssd": ssd.launches}
        check(counts == {k: v * n for k, v in per_step.items()}
              and stats["recoveries"] == 0,
              f"{arch}: {n} steps on the mesh launched {counts} ({per_step} "
              f"a step), no recovery")
        del placed
        plain, losses = state0, []
        for i in range(n):
            plain, m = plain_step(plain, batch_fn(i))
            losses.append(float(m["loss"]))
        mesh_losses = [stats["loss"][i] for i in range(n)]
        loss_err = max(abs(a - b) for a, b in zip(mesh_losses, losses))
        lr_sum = sum(float(cosine_lr(opt, i)) for i in range(n))
        worst, differ, total = 0.0, 0, 0
        for (_, a), b, p in zip(named_leaves(state["params"]),
                                leaves(plain["params"]),
                                leaves(state0["params"])):
            a = a.full_tensor()
            excess = ((a.float() - b.float()).abs() - 2.2 * lr_sum
                      - 2.0 ** -7 * p.float().abs()).max()
            worst = max(worst, float(excess))
            differ += int((a != b).sum())
            total += a.numel()
        bit_equal = differ == 0 and mesh_losses == losses
        check(loss_err <= TRAIN_LOSS_TOL and worst <= 0.0,
              f"{arch} {n} bf16 steps on the mesh vs the meshless step: "
              f"losses {mesh_losses} vs {losses} (max diff {loss_err:.3g}, "
              f"tol {TRAIN_LOSS_TOL}); params within two steps' lr "
              f"(2.2 x {lr_sum:.3g}) plus one bf16 ulp; {differ} of {total} "
              f"weights differ: {'bit-equal' if bit_equal else 'not bit-equal'}")
        # step times in turns, from the states reached (plain, mesh,
        # mesh, plain, ...), each ended by a synchronise
        times = {"mesh": [], "meshless": []}
        for i, which in enumerate(["meshless", "mesh", "mesh",
                                   "meshless"] * 2):
            fn = mesh_step if which == "mesh" else plain_step
            b = batch_fn(n + i)
            t0 = time.perf_counter()
            if which == "mesh":
                state, _ = fn(state, b)
            else:
                plain, _ = fn(plain, b)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
        step_s = statistics.median(times["mesh"])
        plain_s = statistics.median(times["meshless"])
        print(f"  {arch} the loop's steps on the mesh "
              f"{[round(stats['step_s'][i] * 1e3, 2) for i in range(n)]} ms; "
              f"then in turns, mesh {[round(t * 1e3, 2) for t in times['mesh']]}"
              f" ms, meshless {[round(t * 1e3, 2) for t in times['meshless']]}"
              f" ms", flush=True)

        save(str(ckdir), state, int(state["step"]))
        restored = restore(str(ckdir), state0, shardings=sh)
        exact = all(
            tuple(r.placements) == tuple(t.placements)
            and r.dtype == t.dtype and torch.equal(r.full_tensor(),
                                                   t.full_tensor())
            for r, t in zip(leaves(restored), leaves(state)))
        check(exact, f"{arch}: the sharded state's checkpoint (step "
                     f"{int(state['step'])}) "
                     f"restored with shardings= bit for bit, each leaf on "
                     f"its sharding's placements")
    del state, restored, plain, state0
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"  {arch} step on the mesh {step_s * 1e3:.2f} ms (median of 4 "
          f"in turns), {B * S / step_s:,.0f} tokens/s; meshless "
          f"{plain_s * 1e3:.2f} ms", flush=True)
    metrics = {"losses_mesh": mesh_losses, "losses_meshless": losses,
               "loss_max_diff": loss_err, "weights_differing": differ,
               "bit_equal": bit_equal, "step_ms": step_s * 1e3,
               "meshless_step_ms": plain_s * 1e3,
               "tokens_per_s": B * S / step_s,
               "loop_step_ms": [stats["step_s"][i] * 1e3 for i in range(n)],
               "turns_ms": {k: [t * 1e3 for t in v]
                            for k, v in times.items()}}
    return metrics, counts


def count_train_step(torch, cfg, tcfg, B, S):
    """The port's count of one train step (`launch/roofline.py: count`) of
    `cfg` on B x S tokens from the data pipeline, on the CPU under fake
    tensors: (Roofline, Extras)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.launch.roofline import count
    from repro_torch.runtime.train import make_train_step

    step, init = make_train_step(cfg, tcfg, device="cpu")
    real = batch_for_model(cfg, DataConfig(seq_len=S, global_batch=B,
                                           vocab_size=cfg.vocab_size), 0)
    dtypes = {k: torch.from_numpy(v).dtype for k, v in real.items()}
    with FakeTensorMode():
        state = init(torch.Generator().manual_seed(0))
        batch = {k: torch.zeros(v.shape, dtype=dtypes[k])
                 for k, v in real.items()}
    return count(step, state, batch)


def count_prefill(torch, cfg, batch):
    """The port's count of phase 3's prefill call of `cfg` on `batch`
    rows of 1024 random tokens (int64), on the CPU under fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import count
    from repro_torch.models import build_model
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns

    prefill, _, _ = make_serve_fns(cfg, ServeConfig(max_len=96), "cpu")
    with FakeTensorMode():
        params = build_model(cfg, remat=False, device="cpu").init(
            torch.Generator().manual_seed(0))
        tokens = torch.zeros((batch, 1024), dtype=torch.int64)
    return count(prefill, params, {"tokens": tokens})


def roofline_row(name, rl, ex, measured_ms):
    """Print one path's roofline against its measured median; the share
    is the least time the card could take (FLOPs at the bf16 peak, or the
    floor's bytes at HBM's rate, whichever is larger) over the measured
    time."""
    from repro_torch.launch.roofline import HBM_BW
    t_unfused = rl.hbm_bytes / HBM_BW
    bound = max(rl.t_compute, ex.t_floor)
    binds = "compute" if rl.t_compute >= ex.t_floor else "memory (floor)"
    share = bound * 1e3 / measured_ms
    print(f"  {name}: {rl.flops:.6g} FLOPs, bytes {rl.hbm_bytes:.6g} "
          f"unfused / {ex.floor_bytes} floor; t_compute "
          f"{rl.t_compute * 1e3:.4f} ms, t_memory {t_unfused * 1e3:.4f} ms "
          f"unfused / {ex.t_floor * 1e3:.4f} ms floor; {binds} binds "
          f"(unfused: {rl.dominant}); measured {measured_ms:.2f} ms; "
          f"roofline share {share:.4f}", flush=True)
    return {"flops": rl.flops, "unfused_bytes": rl.hbm_bytes,
            "floor_bytes": ex.floor_bytes, "t_compute_ms": rl.t_compute * 1e3,
            "t_memory_unfused_ms": t_unfused * 1e3,
            "t_memory_floor_ms": ex.t_floor * 1e3, "binds": binds,
            "measured_ms": measured_ms, "roofline_share": share,
            "flops_by_op": ex.flops_by_op}


def phase_roofline(torch, dev, metrics, train_count, card):
    """7: the roofline of the paths this script times, and the count held
    to the real program on the card."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.roofline import flop_counter
    from repro_torch.launch.train import device_batch
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    print(f"phase 7: the roofline of the paths this script times ({card}; "
          f"H100 SXM datasheet peaks: 989 TFLOP/s bf16, 3.35 TB/s)",
          flush=True)
    cfg = ARCHS["smollm-360m"]
    B, S = 8, 1024
    rl, ex = train_count
    train = metrics["smollm-360m-train"]

    # check 1: the count's FLOPs equal FlopCounterMode around one real
    # plain-route step on the card (the kernels are opaque to a dispatch
    # mode, so the plain routes; the count runs them too)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(optimizer=opt, attention_impl="naive", remat=True)
    step, init = make_train_step(cfg, tcfg, dev)
    state = init(torch.Generator(device=dev).manual_seed(0))
    batch = device_batch(cfg, DataConfig(seq_len=S, global_batch=B,
                                         vocab_size=cfg.vocab_size), 0, dev)
    real_bytes = sum(t.numel() * t.element_size()
                     for t in leaves(state) + list(batch.values()))
    with flop_counter() as fc:
        new, _ = step(state, batch)
        torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    del new, state, batch
    torch.cuda.empty_cache()
    check(real_flops == int(rl.flops),
          f"smollm-360m train step ({B} x {S}, AdamW, remat, plain routes): "
          f"FlopCounterMode on the card counts {real_flops} FLOPs, the "
          f"fake-tensor count {int(rl.flops)}")
    # check 2: the memory estimate
    check(real_bytes == ex.argument_bytes,
          f"smollm-360m train step: the count's argument bytes "
          f"{ex.argument_bytes} equal the real state's and batch's on the "
          f"card ({real_bytes})")
    peak_ratio = ex.peak_bytes / train["peak_memory_bytes"]
    print(f"  smollm-360m train step: MemTracker's peak {ex.peak_bytes} B "
          f"(fake tensors, plain routes) against phase 5's "
          f"max_memory_allocated {train['peak_memory_bytes']} B (kernels, "
          f"the loop's peak): ratio {peak_ratio:.4f}", flush=True)

    rows = {}
    rows["smollm-360m prefill 4 x 1024"] = roofline_row(
        "smollm-360m prefill 4 x 1024", *count_prefill(torch, cfg, 4),
        metrics["smollm-360m"]["prefill_ms"])
    rows["smollm-360m train step 8 x 1024"] = roofline_row(
        "smollm-360m train step 8 x 1024 (AdamW, remat)", rl, ex,
        train["step_ms"])
    mixtral = dataclasses.replace(ARCHS["mixtral-8x22b"], n_layers=4,
                                  unit=())
    rows["mixtral-8x22b (4 layers) prefill 4 x 1024"] = roofline_row(
        "mixtral-8x22b (4 of 56 layers) prefill 4 x 1024",
        *count_prefill(torch, mixtral, 4),
        metrics["mixtral-8x22b"]["prefill_ms"])
    return {"paths": rows, "train_flops_card": real_flops,
            "train_flops_count": rl.flops,
            "train_argument_bytes": ex.argument_bytes,
            "train_peak_bytes_count": ex.peak_bytes,
            "train_peak_ratio_to_max_memory_allocated": peak_ratio}


def phase_tensor_parallel(torch, dev, train_count):
    """8: the mesh's train step and sharded serving on the 1-rank
    host mesh, against the meshless paths; the sequence-split decode
    combine at full width."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.launch.roofline import flop_counter
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.launch.train import device_batch
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.parallel import ParallelContext, parallel_context
    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.runtime.sharding import place, state_shardings
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    print("phase 8: the mesh's sharded paths, smollm-360m on the host mesh",
          flush=True)
    t_phase = time.perf_counter()
    arch, B, S = "smollm-360m", 8, 1024
    cfg = ARCHS[arch]
    mesh = make_host_mesh("cuda")
    wrappers = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "ssd": ssd}

    def reset():
        for w in wrappers.values():
            w.launches = 0
        rmsnorm.bwd_launches = 0

    def read():
        out = {k: w.launches for k, w in wrappers.items()}
        out["rmsnorm.bwd"] = rmsnorm.bwd_launches
        return out

    # 8a: one train step on the mesh vs meshless
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(optimizer=opt, remat=True)
    mesh_step, init_fn = make_train_step(cfg, tcfg, dev, mesh=mesh)
    plain_step, _ = make_train_step(cfg, tcfg, dev)
    batch = device_batch(cfg, DataConfig(seq_len=S, global_batch=B,
                                         vocab_size=cfg.vocab_size), 0, dev)
    state0 = init_fn(torch.Generator(device=dev).manual_seed(0))
    blocks = len(cfg.unit) * cfg.n_units
    attn = sum(b.kind == "attn" for b in cfg.unit) * cfg.n_units
    per_step = {"flash_attention": 2 * attn, "rmsnorm": 2 * blocks + 1,
                "ssd": 0, "rmsnorm.bwd": blocks + 1}
    with use_mesh(mesh), parallel_context(ParallelContext()):
        placed = place(state0, state_shardings(mesh, state0, "adamw"))
        mesh_step(placed, batch)                   # warm
        torch.cuda.synchronize()
        reset()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        new, m = mesh_step(placed, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        # the step's own draw: its peak over what was allocated before it
        step_peak = torch.cuda.max_memory_allocated() - held
        train_counts = read()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    want, wm = plain_step(state0, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = torch.cuda.max_memory_allocated() - held
    check(train_counts == per_step,
          f"{arch} step on the mesh launched {train_counts} (expected "
          f"{per_step})")
    differ = sum(int((a.full_tensor() != b).sum()) for a, b in
                 zip(leaves(new["params"]), leaves(want["params"])))
    check(differ == 0 and float(m["loss"]) == float(wm["loss"]),
          f"{arch} one step through the mesh's train step on "
          f"{mesh.shape}: loss {float(m['loss'])} vs meshless "
          f"{float(wm['loss'])}, {differ} weights differ (bit-equal); "
          f"{step_ms:.2f} ms vs meshless {plain_ms:.2f} ms; "
          f"max_memory_allocated over what each found allocated "
          f"{step_peak} B vs meshless {plain_peak} B")
    del new, want, placed
    # FlopCounterMode around a real plain-route step on the mesh
    rl, _ = train_count
    naive = TrainConfig(optimizer=opt, attention_impl="naive", remat=True)
    naive_step, _ = make_train_step(cfg, naive, dev, mesh=mesh)
    with use_mesh(mesh), parallel_context(ParallelContext()):
        placed = place(state0, state_shardings(mesh, state0, "adamw"))
        with flop_counter() as fc:
            naive_step(placed, batch)
            torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    check(real_flops == int(rl.flops),
          f"{arch} plain-route step on the mesh: FlopCounterMode on the "
          f"card {real_flops} FLOPs, the fake-tensor count {int(rl.flops)}")
    del placed, state0, batch
    torch.cuda.empty_cache()

    # 8b: the serve loop through the sharded serving functions
    params = build_model(cfg, remat=False, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    scfg = ServeConfig(max_len=96)
    runs = {}
    serve_peak = {}
    for name, on in (("meshless", None), ("mesh", mesh), ("mesh ", mesh),
                     ("meshless ", None)):
        reset()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res, st = serve_loop(params, cfg, scfg, make_requests(8,
                                                              cfg.vocab_size),
                             4, 8, dev, on)
        torch.cuda.synchronize()
        serve_peak.setdefault(name.strip(), []).append(
            torch.cuda.max_memory_allocated() - held)
        runs.setdefault(name.strip(), []).append((res, st, read()))
    (res_m, st_m, serve_counts), (res_p, st_p, plain_counts) = \
        runs["mesh"][0], runs["meshless"][0]
    steps = st_m["steps"]
    check(serve_counts == plain_counts and serve_counts["rmsnorm"] ==
          (blocks + 1) * steps and serve_counts["flash_attention"] == 0,
          f"{arch} serve loop on the mesh: {steps} decode steps launched "
          f"{serve_counts} (meshless {plain_counts})")
    check(res_m == res_p and st_m["served"] == 8,
          f"{arch} serve loop through the sharded serving functions: the "
          f"meshless loop's tokens for all {st_m['served']} requests; "
          f"tokens/s {[round(r[1]['tok_per_s'], 2) for r in runs['mesh']]} "
          f"vs meshless "
          f"{[round(r[1]['tok_per_s'], 2) for r in runs['meshless']]} "
          f"(in turns); max_memory_allocated over what each found "
          f"allocated {serve_peak['mesh']} B vs meshless "
          f"{serve_peak['meshless']} B")
    del params

    # 8c: the sequence-split decode combine at full width
    gen = torch.Generator(device=dev).manual_seed(4)
    H, K, D, L, slots, pos = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              1024, 4, 1500)
    k_pos = A.ring_positions(pos, L, dev)
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    split_err, split = {}, {}
    for dtype, tol in (("float32", (1e-5, 0.0)),
                       ("bfloat16", (2.0 ** -8, 2.0 ** -7))):
        dt = getattr(torch, dtype)
        q = torch.randn((slots, 1, H, D), generator=gen, device=dev,
                        dtype=torch.float32).to(dt)
        k, v = (torch.randn((slots, L, K, D), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
                for _ in range(2))

        def whole():
            return A.sdpa_naive(q, k, v, q_pos, k_pos, None, None, D ** -0.5)

        def parts():
            return A.combine_partials(*(torch.stack(t) for t in zip(*(
                A.decode_partial(q, k[:, i:i + L // 4], v[:, i:i + L // 4],
                                 q_pos, k_pos[i:i + L // 4], None, None,
                                 D ** -0.5) for i in range(0, L, L // 4)))),
                q.dtype if dt == torch.float32 else torch.bfloat16)

        got, ref = parts(), whole()
        split_err[dtype] = max_err(got, ref)
        check(got.shape == ref.shape and close(torch, got, ref, *tol),
              f"sequence-split decode combine, {slots} slots x {L} "
              f"positions in 4 slices, H={H} K={K} D={D}, {dtype} queries: "
              f"max diff {split_err[dtype]:.3g} from the whole-cache "
              f"decode attention (atol {tol[0]:.3g}, rtol {tol[1]:.3g})")
        split[dtype] = {"split_ms": cuda_ms(torch, parts, 20)[0],
                        "whole_ms": cuda_ms(torch, whole, 20)[0]}
    # decode_attention's split branch on the mesh (one slice, gathered
    # over 'model' by NCCL) against its whole-cache branch
    layer = {kk: vv.float() for kk, vv in A.attention_init(
        torch.Generator(device=dev).manual_seed(5), cfg, dev).items()}
    x = torch.randn((slots, 1, cfg.d_model), generator=gen, device=dev)
    cache = {"k": k.clone(), "v": v.clone()}
    ref, _ = A.decode_attention(layer, x, cache, cfg, pos)
    cache = {"k": k.clone(), "v": v.clone(),
             "seq": A.SeqShard(L, 0, ("model",))}
    with use_mesh(mesh):
        got, _ = A.decode_attention(layer, x, cache, cfg, pos)
    check(close(torch, got, ref, 1e-5, 0.0),
          f"decode_attention's sequence-split branch on {mesh.shape} vs its "
          f"whole-cache branch: max diff {max_err(got, ref):.3g} (float32)")
    phase_s = time.perf_counter() - t_phase
    print(f"  {arch} phase 8: {phase_s:.1f} s; split combine "
          f"{split} ms (CUDA events, 20 calls)", flush=True)
    metrics = {"step_ms": step_ms, "meshless_step_ms": plain_ms,
               "step_max_memory_allocated": step_peak,
               "meshless_step_max_memory_allocated": plain_peak,
               "serve_max_memory_allocated": serve_peak["mesh"],
               "meshless_serve_max_memory_allocated": serve_peak["meshless"],
               "train_flops_card": real_flops,
               "serve_tok_per_s": [r[1]["tok_per_s"] for r in runs["mesh"]],
               "meshless_serve_tok_per_s": [r[1]["tok_per_s"]
                                            for r in runs["meshless"]],
               "decode_steps": steps, "split_combine_max_diff": split_err,
               "split_combine_ms": split, "phase_s": phase_s}
    return metrics, {f"{arch}-tp-train": train_counts,
                     f"{arch}-tp-serve": {k: serve_counts[k]
                                          for k in wrappers}}


def phase_unit_gather(torch, dev):
    """9: the per-unit gather through the mesh, on the 1-rank host mesh
    (every unit's shard is the whole unit: the gathers wrap without a
    copy): mixtral-8x22b at published widths, 4 layers, under the
    launcher's context (the expert stacks taken at the expert-parallel
    path's shard), and zamba2-2.7b's prefill (the hybrid's super-units,
    the mixers' projections), each against the meshless functions on
    the same weights, bit for bit."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.runtime.parallel import ParallelContext, parallel_context
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns
    from repro_torch.runtime.sharding import params_shardings, place

    print("phase 9: the per-unit gather through the mesh (mixtral-8x22b "
          "under the launcher's context, zamba2-2.7b's prefill)", flush=True)
    t_phase = time.perf_counter()
    mesh = make_host_mesh("cuda")
    wrappers = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "ssd": ssd}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def read():
        return {k: w.launches for k, w in wrappers.items()}

    metrics, counts = {}, {}
    for arch, layers, batch, steps in (("mixtral-8x22b", 4, 4, 8),
                                       ("zamba2-2.7b", None, 2, 0)):
        cfg = ARCHS[arch]
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers, unit=())
        params = build_model(cfg, remat=False, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (batch, 1024), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(1))
        scfg = ServeConfig(max_len=1024 + steps + 1)
        plain_fns = make_serve_fns(cfg, scfg, dev)
        mesh_fns = make_serve_fns(cfg, scfg, dev, mesh)
        ctx = ParallelContext()
        out = {}
        for name, (prefill, decode, init_cache) in (("mesh", mesh_fns),
                                                    ("meshless", plain_fns)):
            with use_mesh(mesh), parallel_context(ctx):
                p = place(params, params_shardings(mesh, params)) \
                    if name == "mesh" else params
                reset()
                moe.moe_block_expert_parallel.calls = 0
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                logits = prefill(p, {"tokens": tokens})
                torch.cuda.synchronize()
                launched = read()
                toks = [torch.argmax(logits, dim=-1)]
                if steps:
                    cache = init_cache(batch, scfg.max_len)
                    for pos in range(steps):
                        nxt, _, cache = decode(p, cache, toks[-1][:, None]
                                               .to(torch.int32), pos)
                        toks.append(nxt[:, 0])
                torch.cuda.synchronize()
            out[name] = (logits, torch.stack(toks, 1), launched,
                         torch.cuda.max_memory_allocated() - held,
                         moe.moe_block_expert_parallel.calls)
            del p
        (lg_m, tk_m, n_m, peak_m, ep_m), (lg_p, tk_p, n_p, peak_p, ep_p) = \
            out["mesh"], out["meshless"]
        check(torch.equal(lg_m, lg_p) and torch.equal(tk_m, tk_p),
              f"{arch} through the mesh's per-unit gather on {mesh.shape}: "
              f"prefill logits bit-equal to the meshless functions' "
              f"({int((lg_m != lg_p).sum())} differ), tokens "
              f"{tk_m.shape} equal ({bool(torch.equal(tk_m, tk_p))})")
        check(n_m == n_p and n_m["rmsnorm"] > 0 and
              (n_m["ssd"] > 0 if cfg.ssm_state else
               n_m["flash_attention"] > 0) and
              (ep_m == ep_p >= cfg.n_layers if cfg.n_experts else True),
              f"{arch} prefill launches through the mesh {n_m} (meshless "
              f"{n_p}); expert-parallel calls {ep_m} (meshless {ep_p})")
        print(f"  {arch}: max_memory_allocated over what each found "
              f"allocated: through the mesh {peak_m} B, meshless {peak_p} B",
              flush=True)
        metrics[arch] = {"max_memory_allocated": peak_m,
                         "meshless_max_memory_allocated": peak_p,
                         "prefill_launches": n_m,
                         "expert_parallel_calls": ep_m}
        counts[f"{arch}-unit-gather"] = n_m
        del params, tokens, out, lg_m, lg_p
        torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 9: {metrics['phase_s']:.1f} s", flush=True)
    return metrics, counts


def phase_obs_plane(torch, dev, card, expect_syncs):
    """13: the observability and co-design planes on the card, every call
    held to the port's own CPU route (`launch/obs_plane.py`)."""
    from repro_torch.launch.obs_plane import RTOL, run

    print("phase 13: the observability and co-design planes on the card",
          flush=True)
    t_phase = time.perf_counter()
    out = run(dev, expect_syncs=expect_syncs)
    phase_s = time.perf_counter() - t_phase
    for name, sec in out["seconds"].items():
        print(f"  {name}: {sec:.4f} s wall ({card})")
    for policy, r in out["recorded"].items():
        print(f"  recorded {policy} run of smollm_360m:prefill: "
              f"{r['events']} events on {r['tracks']} tracks, "
              f"{r['critical_segments']} critical segments, makespan "
              f"{r['total_time']!r} s, critical shares "
              f"{r['critical_shares']}")
    print(f"  validate errors on zfnet: {out['validate_error']}")
    g = out["guided"]
    print(f"  whatif_guided on zfnet, resnet50, gnmt: "
          f"{g['points_evaluated']} (CPU route {g['points_evaluated_cpu']})"
          f" of {g['points_exhaustive']} points; projected "
          f"{g['projected_best']}")
    prof = out["profile"]
    print(f"  profiled sweep_all of the 15 paper traces: coverage "
          f"{prof['coverage']:.4f} of {prof['wall_s']:.4f} s; host syncs "
          f"of an unprofiled sweep_all of {prof['trace']}: "
          f"{prof.get('host_syncs_sweep_all_one_trace')} (phase 11: "
          f"{expect_syncs})")
    for cell, c in out["codesign"].items():
        print(f"  codesign {cell}: {c['seconds']:.4f} s on the card, "
              f"{c['seconds_cpu']:.4f} s on the CPU route "
              f"({c['seconds'] / c['seconds_cpu']:.3f} x), "
              f"{c['evaluations']} | {c['evaluations_cpu']} evaluations, "
              f"{c['states_differing']} states differing, "
              f"{c['package']}, co-designed speedup "
              f"{c['speedup_codesigned']!r}, spread wired "
              f"{c['spread_wired']!r} -> hybrid {c['spread_hybrid']!r} "
              f"({card})")
    r = out["evaluate_profile"]
    print(f"  one PlacementProblem.evaluate ({r['cell']}, greedy seed): "
          f"{r.get('device_ops_per_evaluate', 'not measured')} device ops, "
          f"busy {r.get('device_busy_ms_per_evaluate', 'n/a')} ms of a "
          f"{r.get('device_window_ms_per_evaluate', 'n/a')} ms window "
          f"(idle share {r.get('device_idle_share', 'n/a')}), host "
          f"{r['host_ms_per_evaluate']:.3f} ms, "
          f"{r.get('host_syncs_per_evaluate', 'not measured')} host syncs "
          f"({card})")
    for line in out["failures"]:
        print(f"  FAILED: {line}")
    print(f"  phase 13 took {phase_s:.1f} s")
    check(not out["failures"],
          f"the observability and co-design planes on the card agree with "
          f"their CPU route (rtol {RTOL}, tie rule) and keep their bounds "
          f"({len(out['failures'])} failures, "
          f"{out['codesign_states_differing']} co-design states differing)")
    out["phase_s"] = phase_s
    return out


def phase_observatory(torch, dev, card):
    """14: the linter and the bench observatory on the card, the
    walkthrough held to its own CPU route (`launch/observatory.py`)."""
    import tempfile

    from repro_torch.launch.observatory import RTOL, compare, phase_calls, run

    print("phase 14: the linter and the bench observatory on the card",
          flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        on_card = run(dev, out_dir=str(pathlib.Path(d) / "card"))
        on_cpu = run("cpu", out_dir=str(pathlib.Path(d) / "cpu"))
        failures = compare(on_card, on_cpu)
        html = [pathlib.Path(o["html"]).read_bytes()
                for o in (on_card, on_cpu)]
    t0 = time.perf_counter()
    lint = subprocess.run([sys.executable, "-m", "repro_torch.lint", "src"],
                          cwd=ROOT, capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    lint_s = time.perf_counter() - t0
    summary = lint.stderr.strip().splitlines()[-1] if lint.stderr else ""
    scanned = re.search(r"in (\d+) file", summary)
    phase_s = time.perf_counter() - t_phase
    out = {
        "seconds": {f"{half}_{route}": o["seconds"][half]
                    for route, o in (("card", on_card), ("cpu", on_cpu))
                    for half in ("profile", "observatory")},
        "phase_calls": phase_calls(on_card["profiler"]),
        "coverage": {"card": on_card["profiler"].coverage(),
                     "cpu": on_cpu["profiler"].coverage()},
        "events": len(on_card["result"].trace.events),
        "ledger_entries": on_card["entries"],
        "ledger_findings": len(on_card["findings"]),
        "html_bytes": len(html[0]),
        "lint": {"rc": lint.returncode, "summary": summary,
                 "files_scanned": int(scanned.group(1)) if scanned else None,
                 "seconds": lint_s},
        "failures": failures, "phase_s": phase_s}
    for name, sec in out["seconds"].items():
        print(f"  {name}: {sec:.4f} s wall ({card})")
    print(f"  profiled sweep_all of "
          f"{len({r.workload for r in on_card['sweeps']})} traces "
          f"and a recorded greedy run of zfnet: "
          f"{sum(out['phase_calls'].values())} phase calls on "
          f"{len(out['phase_calls'])} paths, coverage "
          f"{out['coverage']['card']:.4f} on the card, "
          f"{out['coverage']['cpu']:.4f} on the CPU route; "
          f"{out['events']} events")
    print(f"  bench ledger: {out['ledger_entries']} entries, "
          f"{out['ledger_findings']} findings; HTML {out['html_bytes']} "
          f"bytes, byte-equal on both routes: {html[0] == html[1]}")
    print(f"  python -m repro_torch.lint src: rc {lint.returncode}, "
          f"{out['lint']['files_scanned']} files scanned in {lint_s:.2f} s "
          f"({summary})")
    for line in lint.stdout.splitlines()[:20] + failures:
        print(f"  FAILED: {line}")
    print(f"  phase 14 took {phase_s:.1f} s")
    check(not failures,
          f"the observatory's profile half on the card agrees with its CPU "
          f"route (rtol {RTOL}, tie rule; {len(failures)} failures)")
    check(html[0] == html[1] and out["ledger_entries"] > 0,
          "the committed ledger's HTML report is byte-equal on both routes")
    check(lint.returncode == 0 and summary.startswith(
        "repro_torch.lint: 0 finding(s)") and out["lint"]["files_scanned"],
          f"the port's linter passes src/ ({summary})")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import KERNELS, _build
        from repro_torch.kernels.rmsnorm.ops import rmsnorm
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
    # the split-row entry's launches over every main path below (phases
    # 3-10; none of them splits heads over 'model' on one card)
    rmsnorm.split_launches = 0
    grouped_mm = phase_grouped_mm(torch, dev)
    metrics, counts = phase_main_paths(torch, dev)
    metrics["grouped_mm"] = grouped_mm
    phase_reference_checks(torch, dev)
    backend = start_group(torch, dev)
    metrics["expert_parallel_card_vs_cpu"] = check_expert_parallel(torch, dev)
    metrics["smollm-360m-train"], counts["smollm-360m-train"], \
        train_count = phase_train(torch, dev)
    metrics["mixtral-8x22b-mesh"], counts["mixtral-8x22b-mesh"] = \
        phase_distributed_serve(torch, dev)
    metrics["smollm-360m-train-mesh"], counts["smollm-360m-train-mesh"] = \
        phase_distributed_train(torch, dev)
    metrics["roofline"] = phase_roofline(torch, dev, metrics, train_count,
                                         card)
    metrics["smollm-360m-tp"], tp_counts = phase_tensor_parallel(
        torch, dev, train_count)
    counts.update(tp_counts)
    metrics["unit-gather"], gather_counts = phase_unit_gather(torch, dev)
    counts.update(gather_counts)
    ssm_metrics, ssm_counts = phase_ssm_train(torch, dev)
    metrics.update(ssm_metrics)
    counts.update(ssm_counts)
    metrics["paper-plane"] = phase_paper_plane(torch, dev, card)
    metrics["event-plane"] = phase_event_plane(torch, dev, card)
    metrics["obs-plane"] = phase_obs_plane(
        torch, dev, card,
        metrics["paper-plane"]["profile"]["host_syncs_sweep_all_one_trace"])
    metrics["observatory"] = phase_observatory(torch, dev, card)

    # every path counts the forward kernels; only SSM training launches
    # the SSD backward; the serving and SSM training paths count the
    # gated norm
    for name, entry in kernels.items():
        by_path = {path: c[name] for path, c in counts.items() if name in c}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    kernels["rmsnorm_gated"]["bwd_launches_by_path"] = {
        path: counts[path]["rmsnorm_gated.bwd"]
        for path in ("mamba2-130m-train", "zamba2-2.7b-train")}
    kernels["rmsnorm_gated"]["bwd_launches"] = sum(
        kernels["rmsnorm_gated"]["bwd_launches_by_path"].values())
    kernels["rmsnorm"]["split"]["launches"] = rmsnorm.split_launches
    kernels["rmsnorm"]["bwd_launches"] = sum(
        counts[path]["rmsnorm.bwd"]
        for path in ("smollm-360m-train", "smollm-360m-train-mesh",
                     "smollm-360m-tp-train", "mamba2-130m-train",
                     "zamba2-2.7b-train"))
    serve = [m for m in metrics.values() if "flash_attention_tc_launches" in m]
    kernels["flash_attention"]["tc_launches"] = sum(
        m["flash_attention_tc_launches"] for m in serve) + sum(
        counts[path]["flash_attention"] for path in (
            "smollm-360m-train", "mixtral-8x22b-mesh",
            "smollm-360m-train-mesh", "smollm-360m-tp-train",
            "mixtral-8x22b-unit-gather", "zamba2-2.7b-unit-gather",
            "zamba2-2.7b-train"))
    kernels["ssd"]["tc_launches"] = sum(m["ssd_tc_launches"] for m in serve) \
        + sum(counts[path]["ssd"] for path in (
            "zamba2-2.7b-unit-gather", "mamba2-130m-train",
            "zamba2-2.7b-train"))
    metrics.update(card=card, build_s=build_s, process_group=backend)
    print(json.dumps({"metrics": metrics}))
    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}}
    torch.distributed.destroy_process_group()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
