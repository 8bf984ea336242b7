"""The plain reference against the program's plain CPU path at reduced
sizes, in float32: logits of both configurations, the training loss
and gradients (the MoE's load-balancing term, which the reference does
not compute, weighted 0), and one AdamW update against the program's
optimizer."""

import pytest
import torch

from pb_small import small_cell
from portbench import weights
from portbench.harness import RunContext
from portbench.reference import decoder, optim
from repro_torch.models import build_model
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.train import TrainConfig, make_loss_fn
from repro_torch.tree import tree_map


def _setup(name, seed=3):
    cell = small_cell(name)
    ctx = RunContext(cell=cell, seed=seed, seconds=0, trace=False,
                     device="cpu", started=0.0)
    mcfg = ctx.model_config()
    tmpl = build_model(mcfg, device="meta").init(torch.Generator())
    params = tree_map(lambda t: t.float(), weights.draw(
        tmpl, seed, "cpu", weights.residual_branches(cell.config)))
    toks = weights.tokens(seed, 0, 0, (2, 33), cell.config["vocab_size"],
                          "cpu")
    return cell, mcfg, params, toks


@pytest.mark.parametrize("name", ["mamba2-train", "mixtral-prefill"])
def test_logits_match_the_program(name):
    cell, mcfg, params, toks = _setup(name)
    model = build_model(mcfg, remat=False, device="cpu")
    with torch.no_grad():
        got, _ = model.apply(params, {"tokens": toks[:, :-1]})
        want = decoder.forward(params, toks[:, :-1].long(), cell.config,
                               act_dtype=torch.float32)
        last = decoder.forward(params, toks[:, :-1].long(), cell.config,
                               act_dtype=torch.float32, last_only=True)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(last, want[:, -1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["mamba2-train", "mixtral-prefill"])
def test_loss_and_gradients_match_the_program(name):
    cell, mcfg, params, toks = _setup(name)
    z = 1e-4
    tcfg = TrainConfig(remat=False, z_loss_weight=z, aux_loss_weight=0.0)
    loss_fn = make_loss_fn(mcfg, tcfg, "cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got, _ = loss_fn(live, batch)
    got.backward()
    flat = {p: t for p, t in weights.named_leaves(params)}
    want, grads = decoder.grads(flat, batch["tokens"], batch["labels"],
                                cell.config, z,
                                act_dtype=torch.float32)
    assert abs(got.item() - want.item()) < 1e-5
    for path, t in weights.named_leaves(live):
        assert torch.allclose(t.grad, grads[path], atol=1e-5, rtol=1e-4), path


def test_adamw_matches_the_program():
    cell, _, params, _ = _setup("mamba2-train")
    opt_cfg = dict(cell.traffic["optimizer"])
    program = build_optimizer(OptimizerConfig(**opt_cfg))
    g = torch.Generator().manual_seed(0)
    flat = {p: t for p, t in weights.named_leaves(params)}
    grads = {p: torch.randn(t.shape, generator=g) * 0.1
             for p, t in flat.items()}
    new, _ = program.update(decoder.unflatten(grads), program.init(params),
                            params, 0)
    mine = {p: t.clone() for p, t in flat.items()}
    norms = optim.adamw_step(mine, dict(grads), {}, opt_cfg, 0,
                             {p: torch.float32 for p in flat})
    for path, t in weights.named_leaves(new):
        assert torch.allclose(t, mine[path], atol=1e-7, rtol=1e-6), path
    scale = min(1.0, 1.0 / optim.global_norm(grads))
    for p, v in norms.items():
        assert v == pytest.approx(float(grads[p].norm()) * scale, rel=1e-5)
