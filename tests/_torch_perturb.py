"""How far a float32 model's outputs move when its embedding table moves
by a relative `--rel` (each entry times 1 + rel or 1 - rel, signs from a
seed): the yardstick for a bound between two runs that differ only in
the order of their float32 sums (a mesh against one card).

    PYTHONPATH=src:tests python tests/_torch_perturb.py --arch zamba2-2.7b \\
        --batch 2 --seq 1024 [--reduced] [--seed 3]
    PYTHONPATH=src:tests python tests/_torch_perturb.py --arch zamba2-2.7b \\
        --reduced --train --device cuda

Without `--train`: the last-position prefill logits on the CPU's plain
routes; one JSON line, the largest change and the largest logit.  At
full width it needs the memory of the model's float32 weights three
times over (zamba2-2.7b: about 33 GB).

With `--train`: two AdamW steps (lr 1e-3, remat, plain routes, TF32
off) of `--batch` x `--seq` random tokens, as `tests/test_torch_cuda.py`'s
four-card unit-gather test takes them, from the same float32 params
(drawn on the CPU) on `--device`, again with the embedding perturbed,
and on the CPU:
one JSON line a step with each comparison's worst optimizer-state leaf
(its largest error over the leaf's largest value), the worst three,
and the params' largest differences over lr, each with the first
moment's size there over its leaf's largest.
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.runtime.serve import ServeConfig, make_serve_fns

from _torch_dist_worker import seeded_params


def perturbed(params, rel, seed):
    """params with the embedding table times 1 +- rel (signs from seed)."""
    table = params["embed"]["table"]
    sign = torch.where(torch.rand(table.shape, generator=torch.Generator()
                                  .manual_seed(seed)) < 0.5, -1.0, 1.0)
    out = dict(params)
    out["embed"] = dict(params["embed"],
                        table=table * (1 + rel * sign.to(table.device)))
    return out


def prefill(cfg, args):
    params = seeded_params(cfg, args.seed, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32))
    fill, _, _ = make_serve_fns(cfg, ServeConfig(
        max_len=args.seq, attention_impl="naive"), "cpu")
    with torch.no_grad():
        base = fill(params, {"tokens": tokens})
        moved = fill(perturbed(params, args.rel, args.seed),
                     {"tokens": tokens})
    return [dict(max_abs_change=float((moved - base).abs().max()),
                 max_abs_logit=float(base.abs().max()))]


def train(cfg, args):
    from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
    from repro_torch.runtime.train import TrainConfig, make_train_step
    from repro_torch.tree import named_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(2)]
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def run(device, rel):
        step, _ = make_train_step(cfg, TrainConfig(
            optimizer=opt, remat=True, attention_impl="naive"), device)
        params = tree_map(lambda t: t.to(device),
                          seeded_params(cfg, 0, "cpu"))
        if rel:
            params = perturbed(params, rel, args.seed)
        state = {"params": params, "opt": build_optimizer(opt).init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        out = []
        for b in batches:
            state, _ = step(state, {k: v.to(device) for k, v in b.items()})
            out.append({"/".join(p): t.detach().cpu() for p, t in
                        named_leaves({"opt": state["opt"],
                                      "params": state["params"]})})
        return out

    def worst(a, b):
        return sorted(((float((a[k] - b[k]).abs().max())
                        / max(float(b[k].abs().max()), 1e-30), k)
                       for k in b if k.startswith("opt/")), reverse=True)[:3]

    def moved_params(a, b):
        """The params' largest difference (over lr) and, where it is, the
        first moment's size over its leaf's largest (0.1 x the gradient
        after the first step)."""
        out = []
        for k in b:
            if not k.startswith("params/"):
                continue
            d = (a[k] - b[k]).abs().flatten()
            i = int(torch.argmax(d))
            mu = b["opt/mu/" + k[len("params/"):]].abs().flatten()
            out.append((float(d[i]) / opt.lr, float(mu[i] / mu.max()), k))
        return sorted(out, reverse=True)[:3]

    base = run(args.device, 0.0)
    moved = run(args.device, args.rel)
    cpu = run("cpu", 0.0) if args.device != "cpu" else None
    lines = []
    for i in range(2):
        line = {"step": i + 1, "perturbed": worst(moved[i], base[i])}
        if cpu is not None:
            line["device_vs_cpu"] = worst(base[i], cpu[i])
            line["device_vs_cpu_params"] = moved_params(base[i], cpu[i])
        lines.append(line)
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--rel", type=float, default=1e-7)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    args.batch = args.batch or (4 if args.train else 2)
    args.seq = args.seq or (16 if args.train else 1024)
    cfg = reduced(ARCHS[args.arch]) if args.reduced else ARCHS[args.arch]
    t0 = time.perf_counter()
    for line in (train if args.train else prefill)(cfg, args):
        print(json.dumps(dict(arch=args.arch, reduced=args.reduced,
                              batch=args.batch, seq=args.seq, rel=args.rel,
                              device=args.device, **line,
                              seconds=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
