"""Context parallelism for training: a batch whose rows do not divide over
the data axes trains on each rank's part of its sequence, or replicated,
on gloo ranks on the CPU, against the meshless port and the JAX
package's compiled sharded step.

- Two float32 AdamW steps on a (2, 4) ("data", "model") mesh equal the
  meshless steps at three batch shapes: (1, 64) and (3, 32), which
  `batch_spec` splits on the sequence (32 and 16 positions a rank of
  'data'), and (3, 15), which it replicates; for reduced smollm, gemma2
  (window 32, softcaps), mixtral (window 32; the expert-parallel path at
  64 and 96 tokens, the dropless one at 45; capacity 8.0 so that no row
  drops and the aux loss off, against the dropless step, as
  `test_torch_tensor_parallel.py` holds it), mamba2 and zamba2 (chunk 16:
  each rank's part is whole chunks; the conv reads the previous rank's
  rows and the scan carries the earlier ranks' state), and seamless in
  bf16 (its source of 32 frames splits at every shape, so at (3, 15) the
  source is split while the target is whole); and reduced smollm with 4
  microbatches of a (4, 32) batch (each microbatch one row, split on its
  sequence); and mamba2 on the "chunked" route at (3, 40), whose scan
  returns the final state the next ranks carry (20 positions a rank,
  padded to a chunk multiple: the padding leaves that state as it was).
  The tolerances are `test_torch_tensor_parallel.py`'s: loss
  1e-5 relative, optimizer state 1e-6, params 1e-4 where the first
  moment is clear of zero and within two steps elsewhere; mixtral's and
  zamba2's float32 steps are ill-conditioned (`test_torch_unit_gather.py`
  measured it): their state within 1e-3 of each leaf's largest, params
  within two steps; seamless under that file's bf16 bounds.
- The sharded serving prefill on (2, 4) of reduced smollm's (1, 64)
  and (3, 15) batches gives every rank the meshless last-position
  logits (the split one from the rank holding the last position;
  `test_torch_tensor_parallel.py`'s logit bound, 1e-3).
- Reduced smollm's losses at (1, 64) and (3, 15) equal the reference's
  step compiled on 8 host devices with `logical_batch_shardings` (1e-5
  relative).
- The per-rank FLOPs and collective bytes of reduced smollm's (1, 64)
  train step on a fake (2, 4) group are pinned; the meshless count over
  the rank's is 8.
- The MoE dispatcher reads the global token count of a split or a
  replicated batch: reduced mixtral takes the expert-parallel path at
  (1, 64) and (3, 32) on (2, 4), the dropless one at (3, 15), as the
  reference's dispatcher does on the global batch.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_auto_mesh, use_mesh
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.parallel import ParallelContext, parallel_context
from repro_torch.runtime.serve import ServeConfig, make_serve_fns
from repro_torch.runtime.sharding import leaf_shard
from repro_torch.runtime.train import TrainConfig, make_train_step

from _torch_dist import finish, start_ranks
from _torch_parity import both_params, configs, numpy_params, train_batch
from test_torch_tensor_parallel import (BF16_LOSS_RTOL, BF16_RTOL,
                                        BF16_STATE, LOGIT_ATOL, LOSS_RTOL,
                                        OPT,
                                        PARAM_ATOL, STATE_ATOL, STEP_BOUND,
                                        _flat, _float32_params)

REPO = os.path.join(os.path.dirname(__file__), "..")
MESH = (2, 4)
ARCHS_HERE = ("smollm-360m", "gemma2-2b", "mixtral-8x22b", "mamba2-130m",
              "zamba2-2.7b", "seamless-m4t-large-v2")
#: (rows, sequence): split on the sequence, split with several rows,
#: replicated
SHAPES = {"1x64": (1, 64), "3x32": (3, 32), "3x15": (3, 15)}
#: the ill-conditioned float32 steps (`test_torch_unit_gather.py`)
ILL_CONDITIONED = ("mixtral-8x22b", "zamba2-2.7b")
ILL_STATE = 1e-3
MICRO = ("smollm-micro", (4, 32), 4)
#: mamba2's scan on the "chunked" route (`ssd_scan`), at a split part
#: that is not a whole number of chunks
SCAN = ("mamba2-scan", "mamba2-130m", (3, 40), "chunked")
TIMEOUT_S = 420

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_auto_mesh, use_mesh
from repro.optim.optimizers import OptimizerConfig, build_optimizer
from repro.runtime.sharding import logical_batch_shardings, state_shardings
from repro.runtime.train import TrainConfig, make_train_step
d = np.load(sys.argv[1])
params = {}
for key in d.files:
    if key.startswith("params/"):
        node, parts = params, key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(d[key])
cfg = reduced(ARCHS["smollm-360m"])
mesh = make_auto_mesh((2, 4), ("data", "model"))
rep = NamedSharding(mesh, P())
opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
step, _ = make_train_step(cfg, TrainConfig(optimizer=opt, remat=False))
out = {}
for shape in sys.argv[2].split(","):
    state = {"params": params, "opt": build_optimizer(opt).init(params),
             "step": jnp.zeros((), jnp.int32)}
    out[shape] = []
    for i in (0, 1):
        batch = {k: jnp.asarray(d[f"{shape}/batch{i}/{k}"])
                 for k in ("tokens", "labels")}
        sh = state_shardings(mesh, state, "adamw")
        with use_mesh(mesh):
            state, m = jax.jit(step, in_shardings=(
                sh, logical_batch_shardings(mesh, batch)),
                out_shardings=(sh, rep))(state, batch)
        out[shape].append(float(m["loss"]))
print(json.dumps(out))
"""


def _config(arch):
    return reduced(ARCHS[arch])


def _batches(cfg, shape):
    B, S = shape
    return [train_batch(cfg, S, B, "float32", step=i)[1] for i in (0, 1)]


def _train_meshless(cfg, params, batches, aux, microbatches=1,
                    impl="auto"):
    opt = OptimizerConfig(**OPT)
    step_fn, _ = make_train_step(cfg, TrainConfig(
        optimizer=opt, remat=False, aux_loss_weight=aux,
        microbatches=microbatches, attention_impl=impl), "cpu")
    state = {"params": params, "opt": build_optimizer(opt).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for batch in batches:
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


def _flat_jax(tree):
    import jax
    return [("/".join(k.key for k in path), v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 4) ranks and the reference, started together; the meshless
    port's runs while they work."""
    jcfg, scfg = configs("smollm-360m")
    jparams, smollm = both_params(numpy_params(jcfg), "float32")
    train = {}
    for arch in ARCHS_HERE:
        cfg = scfg if arch == "smollm-360m" else _config(arch)
        params = smollm if arch == "smollm-360m" else _float32_params(cfg)
        for shape_name, shape in SHAPES.items():
            train[f"{arch}/{shape_name}"] = {
                "cfg": cfg, "opt": OPT, "batches": _batches(cfg, shape),
                "params": params,
                "capacity": 8.0 if cfg.n_experts else 1.25,
                "aux": 0.0 if cfg.n_experts else 0.01}
    name, shape, k = MICRO
    train[name] = {"cfg": scfg, "opt": OPT, "params": smollm,
                   "batches": _batches(scfg, shape), "microbatches": k,
                   "capacity": 1.25, "aux": 0.01}
    name, arch, shape, impl = SCAN
    cfg = _config(arch)
    train[name] = {"cfg": cfg, "opt": OPT, "batches": _batches(cfg, shape),
                   "params": train[f"{arch}/1x64"]["params"], "impl": impl,
                   "capacity": 1.25, "aux": 0.01}
    prefill = {f"smollm-360m/{n}": {
        "cfg": scfg, "params": smollm, "impl": "auto",
        "tokens": train[f"smollm-360m/{n}"]["batches"][0]["tokens"]}
        for n in ("1x64", "3x15")}
    work = tmp_path_factory.mktemp("context_parallel")
    torch.save({"mesh": MESH, "train": train, "prefill": prefill},
               work / "tp_in.pt")
    started = start_ranks("tp", MESH[0] * MESH[1], work)
    ref_in = work / "ref_in.npz"
    flat = {"params/" + k: np.asarray(v) for k, v in _flat_jax(jparams)}
    ref_shapes = ("1x64", "3x15")
    for s in ref_shapes:
        for i, b in enumerate(train[f"smollm-360m/{s}"]["batches"]):
            flat.update({f"{s}/batch{i}/{k}": v.numpy()
                         for k, v in b.items()})
    np.savez(ref_in, **flat)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_in), ",".join(ref_shapes)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        want = {n: _train_meshless(r["cfg"], r["params"], r["batches"],
                                   r["aux"], r.get("microbatches", 1),
                                   r.get("impl", "auto"))
                for n, r in train.items()}
        old = {n: _flat(r["params"]) for n, r in train.items()}
        for n, r in prefill.items():
            fill, _, _ = make_serve_fns(r["cfg"], ServeConfig(
                max_len=r["tokens"].shape[1]), "cpu")
            want[f"prefill/{n}"] = fill(r["params"], {"tokens": r["tokens"]})
        got = finish(started, TIMEOUT_S)
    finally:
        for proc, _ in started[1]:
            if proc.poll() is None:
                proc.kill()
        out, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err[-3000:]
    return got, want, old, json.loads(out.strip().splitlines()[-1])


def _check_state(arch, state, want_state, bf16):
    assert state.keys() == want_state.keys()
    for name, w in want_state.items():
        g = state[name]
        if bf16:
            g, w = g.float(), w.float()
            atol = (4 * STEP_BOUND if name.startswith("params/")
                    else BF16_STATE * float(w.abs().max()))
            torch.testing.assert_close(
                g, w, rtol=BF16_RTOL if name.startswith("params/") else 0.0,
                atol=atol, msg=name)
            continue
        if name.startswith("opt/") or name == "step":
            atol = ILL_STATE * float(w.abs().max()) \
                if arch in ILL_CONDITIONED else STATE_ATOL
            torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)
            continue
        mu = want_state["opt/mu/" + name[len("params/"):]]
        settled = mu.abs() > 1e-3 * mu.abs().max()
        if arch not in ILL_CONDITIONED:
            torch.testing.assert_close(g[settled], w[settled], rtol=0,
                                       atol=PARAM_ATOL, msg=name)
        assert float((g - w).abs().max()) <= 2 * STEP_BOUND, name


def _check_run(runs, name, arch):
    got, want, old, _ = runs
    want_losses, want_state = want[name]
    want_state = _flat(want_state)
    bf16 = next(iter(old[name].values())).dtype == torch.bfloat16
    for rank in got:
        run = rank["train"][name]
        np.testing.assert_allclose(run["losses"], want_losses,
                                   rtol=BF16_LOSS_RTOL if bf16 else LOSS_RTOL)
        _check_state(arch, run["state"], want_state, bf16)
    assert any(not torch.equal(want_state["params/" + n], t)
               for n, t in old[name].items())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_steps_on_a_batch_the_data_axes_do_not_divide(runs, arch,
                                                            shape):
    _check_run(runs, f"{arch}/{shape}", arch)


def test_microbatches_smaller_than_the_data_axes(runs):
    _check_run(runs, MICRO[0], "smollm-360m")


def test_the_scans_final_state_carries_across_the_ranks(runs):
    _check_run(runs, SCAN[0], SCAN[1])


@pytest.mark.parametrize("shape", ["1x64", "3x15"])
def test_prefill_gives_the_last_position_of_the_whole_sequence(runs, shape):
    got, want, _, _ = runs
    for rank in got:
        torch.testing.assert_close(
            rank["prefill"][f"smollm-360m/{shape}"]["logits"],
            want[f"prefill/smollm-360m/{shape}"], rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("shape", ["1x64", "3x15"])
def test_losses_equal_the_references_sharded_step(runs, shape):
    got, want, _, ref = runs
    np.testing.assert_allclose(got[0]["train"][f"smollm-360m/{shape}"]
                               ["losses"], ref[shape], rtol=LOSS_RTOL)
    np.testing.assert_allclose(want[f"smollm-360m/{shape}"][0], ref[shape],
                               rtol=LOSS_RTOL)


def _train_count(cfg, mesh=None, shape=(1, 64)):
    from repro_torch.runtime.sharding import place, state_shardings
    step, init = make_train_step(cfg, TrainConfig(remat=False),
                                 device="cpu", mesh=mesh)
    with FakeTensorMode():
        state = init(torch.Generator().manual_seed(0))
        if mesh is not None:
            state = place(state, state_shardings(mesh, state, "adamw"))
        batch = {k: torch.zeros(shape, dtype=torch.int32)
                 for k in ("tokens", "labels")}
    return RL.count(step, state, batch)[0]


#: rank 0's collective bytes by op of reduced smollm's (1, 64) train
#: step on the fake (2, 4) group (32 positions a rank, bf16).  All-gather:
#: the weights of the 2 units gathered over 'data' at their 'model'
#: shard, 36864 B, as at (4, 64) (`test_torch_tensor_parallel.PINNED`);
#: the kv heads gathered over 'model' (2 kv heads on 4 ranks), k and v
#: of 32 positions x 32 columns, 4096 B a unit; and the context
#: parallelism's gathers over 'data', k and v of the rank's one kv head
#: after RoPE, 64 positions x 16, 4096 B a unit: 36864 + 8192 + 8192.
#: Reduce-scatter: the weights' gradients back to their shards, 18432 B,
#: as at (4, 64).  All-reduce: the row-parallel sums, the vocabulary's
#: and the 'model' gathers' adjoints at a quarter of the (4, 64) step's
#: tokens, with its scalars, and the two 'data' gathers' adjoints (each
#: all-reduces the gathered gradient, 2048 B), 8192 B.
PINNED = {"all-gather": 53248.0, "all-reduce": 67492.0,
          "reduce-scatter": 18432.0}
#: rank 0's FLOPs of that step: an eighth of the meshless step's
RANK_FLOPS = 5111808.0


def test_per_rank_counts_of_a_sequence_split_step():
    cfg = reduced(ARCHS["smollm-360m"])
    with RL.fake_group(8):
        mesh = make_auto_mesh(MESH, ("data", "model"), device="cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            rank = _train_count(cfg, mesh)
    assert rank.coll_per_op == PINNED
    assert rank.flops == RANK_FLOPS
    # each rank: half the queries (against every key) and a quarter of
    # the heads and of every other product
    assert _train_count(cfg).flops == 8 * rank.flops


class _Mesh:
    """A mesh as the rules see it: axis sizes, this rank's indices."""

    def __init__(self, index=None, **shape):
        self.shape, self._index = shape, index or {}

    def index(self, axis):
        return self._index.get(axis, 0)


@pytest.mark.parametrize("shape, path", [
    ((1, 64), "expert"), ((3, 32), "expert"), ((3, 15), "dropless")])
def test_dispatcher_reads_the_global_tokens_of_a_split_batch(shape, path):
    """Reduced mixtral on (2, 4): the expert-parallel path where the
    global tokens divide the 8 ranks, as the reference's dispatcher
    decides on the global batch, whatever part of it the rank holds."""
    from repro_torch.models.moe import moe_path
    from repro_torch.runtime.parallel import seq_split
    mesh = _Mesh(data=2, model=4)
    x = torch.zeros(shape + (8,))
    local, split = leaf_shard(mesh, x)
    with use_mesh(mesh), parallel_context(ParallelContext()), \
            seq_split(split):
        assert moe_path(reduced(ARCHS["mixtral-8x22b"]), local) == path
