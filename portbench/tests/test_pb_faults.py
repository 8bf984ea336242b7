"""Runs with the timed path broken underneath come out not correct, and
so does the control, at CPU sizes: the harness's whole run, its look
for a card skipped, with each fault a one-chip cell can have planted in
the program's timed entry."""

import pytest
import torch

from pb_small import context, small_cell
from portbench import calibrate
from portbench.compare import judge
from portbench.harness import run_cell


def state_unchanged(name, fn):
    if name != "train_step":
        return fn

    def step(state, batch):
        _, metrics = fn(state, batch)
        return state, metrics
    return step


def token_altered(name, fn):
    """The served token moved off the argmax where prefill makes it."""
    if name != "prefill":
        return fn

    def prefill(params, batch):
        last = fn(params, batch).clone()
        top = last.argmax(-1)
        alt = (top + 1) % last.shape[-1]
        last[torch.arange(last.shape[0]), alt] = last.max(-1).values + 1
        return last
    return prefill


def row_dropped(name, fn):
    """Half of the batch left out: every row answered with the first's."""
    if name != "prefill":
        return fn

    def prefill(params, batch):
        half = {k: v[:1] for k, v in batch.items()}
        last = fn(params, half)
        return last.expand(batch["tokens"].shape[0], -1)
    return prefill


@pytest.mark.parametrize("name, fault, seed", [
    ("mamba2-train", state_unchanged, 20),
    ("mamba2-train", calibrate.half_batch, 20),
    ("mixtral-prefill", token_altered, 21),
    ("mixtral-prefill", row_dropped, 21),
], ids=["state_unchanged", "half_batch", "token_altered", "row_dropped"])
def test_a_fault_is_not_correct(name, fault, seed):
    """Seeds whose one checked prefill (two prompts, at these sizes,
    none spared) meets no near tie of the router."""
    cell = small_cell(name)
    assert run_cell(context(cell, seed=seed))["correct"] is True
    line = run_cell(context(cell, seed=seed, wrap=fault))
    assert line["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"]
               for c in line["checks"].values())


@pytest.mark.parametrize("name, seed", [("mamba2-train", 20),
                                        ("mixtral-prefill", 21)])
def test_the_control_is_not_correct(name, seed):
    """The reference with float8 weight products in the program's place
    fails a limit; the program at the same seed passes them (the
    prefill's at a seed with no near tie of the router)."""
    cell = small_cell(name)
    limits = {k: v for k, v in cell.limits.items()}
    if cell.traffic["kind"] == "train":
        row = calibrate.train_seed(cell, seed, "cpu", control=True,
                                   faults=False)
    else:
        row = calibrate.prefill_seed(cell, seed, "cpu", control=True)
    assert judge(row["program"], limits)[0] is True
    assert judge(row["control"], limits)[0] is False
