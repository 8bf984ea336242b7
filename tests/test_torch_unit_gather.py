"""Each rank gathers its weights one unit at a time, and the MoE expert
stacks and the Mamba2 mixer compute from their 'model' shards: gloo
ranks on the CPU against the meshless port and the JAX package's
compiled sharded programs, and the step's memory on a fake (2, 4) group.

- On (2, 2), (1, 4) and (2, 4) meshes, two float32 AdamW train steps
  (remat on: each unit gathered in the forward and again in the
  recompute, which runs in the backward, outside the step's mesh and
  context) and a fed decode equal the meshless ones, under
  `test_torch_tensor_parallel.py`'s tolerances, for
  - reduced mixtral cut to 2 experts ("mixtral-tp", both for every
    token, weighted by the router): the
    TP-ff path on every mesh ('model' holds at least 2 ranks and the
    experts do not divide it, or the token count, 2 x 15 in training
    and 2 slots in decode, does not divide the data and expert ranks
    together), each rank on its slice of the expert hidden dim;
  - reduced kimi-k2 (8 experts, which every 'model' here divides): the
    expert-parallel path, each rank on its experts;
  both at capacity 8.0, so that no row drops, the aux loss off (the
  paths average it per shard; the dropless step does not), against the
  meshless dropless step;
  - reduced kimi-k2 at 2 x 15 tokens and 2 slots ("kimi-dropless"): the
    dropless path on every mesh (the tokens divide neither the data and
    expert ranks together nor, 8 experts being more than 'model' holds,
    does TP-ff apply), on the stacks as placed (experts on 'model', d
    on 'data': partial products summed), aux loss on;
  the MoE optimizer state within 1e-3 of each leaf's largest and params
  within two steps (the float32 MoE step is ill-conditioned, as
  `test_torch_tensor_parallel.py` shows for mixtral); and
  - reduced mamba2 and zamba2 (zamba2's float32 step is ill-conditioned
    as the MoE steps are: its state within 1e-3 of each leaf's largest,
    its params within two steps; a 1e-7 relative change of its
    embedding moves its meshless moments by 1.26e-4 of the largest, the
    mesh by 1.4e-4), whose mixers compute with `in_proj`
    column-parallel (296 columns, which 2 and 4 divide) and `out_proj`
    row-parallel, each rank running its heads (2 of 8 on a 'model' of
    4): it receives their columns of the fused output by one all-to-all
    and norms its columns of the gated output with the rows' squares
    summed over 'model'; their decode updates the rank's shard of the
    state (the rules put 'model' on its head dim, 16);
  - reduced smollm at d = 128 and ff = 256 ("smollm-adafactor"), two
    Adafactor steps (leaves factored; each rank updates its shards)
    against the meshless Adafactor steps;
  and a decode of reduced mamba2 with heads of 3 ("mamba2-heads": the
  rules put 'model' on the state's 32 heads, so the step updates its
  heads' shard of the state and gathers their y over 'model').
  The decodes' next tokens equal the meshless ones, and their logits
  are within 1e-3 (the bf16 cache, as there; zamba2's, with 26 bf16
  caches a slot, within 2.5e-3: 1.26e-3 seen).
- On (2, 4) the losses of mixtral-tp's and mamba2's train steps equal the
  reference's compiled sharded step on 8 host devices under the same
  context (1e-5 relative), and smollm-adafactor's losses and whole state
  equal the reference's compiled sharded Adafactor step (at least one
  factored leaf split on both of its last two dims); the reference's
  collective bytes by op of the (2, 4) programs beside `test_torch_tensor_parallel.py`'s pinned
  counts, of reduced zamba2's train step (the port's beside it) and of
  reduced kimi's 4-slot decode, are printed (`readings:` lines, run
  with -s).
- On a stub (2, 4) mesh the expert-parallel, TP-ff and dropless paths
  refuse whole stacks and take their shards as given.
- The structure of the step's memory, on a fake (2, 4) group under fake
  tensors (`launch/roofline.py: count`, MemTracker): in a remat train
  step of reduced chatglm3 no two units' gathered weights are alive at
  once (each gather finds every earlier gather's tensors freed), and a
  unit added grows the peak of its gradients (`compute_grads`: the
  forward, the recompute, the backward) by no more than the unit's
  params shards, their gradient and the input the unit's checkpoint
  saves.  The whole step's peak (the optimizer's update included) is
  lower than with DTensor's sharding propagation counted as the rank's
  memory (`roofline._propagation_apart` left out, in a fresh process);
  it and
  the reference's `memory_analysis()` (argument + temp) of the same
  cells on 8 host devices are printed beside it (`readings:` lines,
  run with -s):
  XLA's CPU buffer assignment is not the card's, so nothing bounds the
  ratio.
- Reduced mixtral at d = 1024 on a fake (16, 16) group: with AdamW and
  with Adafactor the train step's peak stays under a quarter of the
  whole model's bf16 params.
- Reduced zamba2's mixer forward on a fake (2, 4) group moves over
  'model' no more than its heads' z, x and dt columns, B and C, and one
  float32 a row for the norm's squares, and gathers nothing.
- A train step whose heads do not divide 'model' (reduced smollm, 6
  heads, 2 x 4096 tokens): the port's count has the reference's
  argument bytes, and its peak is printed beside the reference's
  `memory_analysis()` temp bytes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_auto_mesh, use_mesh
from repro_torch.runtime import parallel
from repro_torch.runtime.parallel import ParallelContext, parallel_context
from repro_torch.runtime.sharding import place, state_shardings
from repro_torch.runtime.train import TrainConfig, make_train_step
from repro_torch.tree import leaves

from _torch_dist import finish, start_ranks, tp_local
from test_torch_tensor_parallel import (LOGIT_ATOL, LOSS_RTOL, OPT,
                                        PARAM_ATOL, STATE_ATOL, STEP_BOUND,
                                        _decode_meshless, _flat,
                                        _float32_params, _train_meshless)

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4)}
ARCHS_HERE = ("mixtral-tp", "kimi-k2-1t-a32b", "kimi-dropless", "mamba2-130m",
              "zamba2-2.7b")
#: the ill-conditioned float32 steps, held as `test_torch_tensor_parallel`
#: holds mixtral's: the optimizer state within ILL_STATE of each leaf's
#: largest, params within two steps.  The MoE steps; and zamba2's (12
#: mixer layers and a shared block applied twice): a 1e-7 relative change
#: of its embedding alone moves its meshless moments by up to 1.26e-4 of
#: the largest, and the mesh's split sums moved them by up to 1.4e-4
#: (seen, (2, 2))
ILL_CONDITIONED = ("mixtral-tp", "kimi-k2-1t-a32b", "kimi-dropless",
                   "zamba2-2.7b")
ILL_STATE = 1e-3
DECODE_LEN, DECODE_STEPS = 16, 6
#: slots a decode: 2 keep mixtral-tp on TP-ff on (2, 2), 8 keep kimi on
#: the expert-parallel path on (2, 4)
SLOTS = {"mixtral-tp": 2, "kimi-k2-1t-a32b": 8, "kimi-dropless": 2,
         "mamba2-130m": 4, "zamba2-2.7b": 4, "mamba2-heads": 4}
#: reduced smollm at d = 128 and ff = 256, so that Adafactor factors
#: its MLP stacks and its table (a leaf's last two dims both >= 128;
#: reduced widths of 64 factor nothing); two Adafactor steps
ADAFACTOR_ARCH = "smollm-adafactor"
ADAFACTOR_OPT = dict(OPT, name="adafactor")
#: Adafactor's second moments, float32 means of squared gradients (1e-4
#: and under here, so STATE_ATOL's absolute 1e-6 says nothing), whose
#: gradients are summed over the ranks in another order: within this
#: share of each leaf's largest (1.14e-6 seen on (2, 4), `wv`'s)
ADAFACTOR_STATE = 1e-5
#: decode only: reduced mamba2 at d = 48 with heads of 3, 32 heads: the
#: rules put 'model' on the state's heads (3 a head does not divide it),
#: so the step updates a heads' shard and gathers y over them
DECODE_ONLY = ("mamba2-heads",)
TIMEOUT_S = 420
MEMORY_UNITS = (3, 5)
#: decode logits: a row-parallel sum that moves a float32 ulp can round
#: a cached value to the next bf16 one (`test_torch_tensor_parallel.py`:
#: 1e-3); zamba2 caches 12 conv windows, 12 states and 2 KV rings a
#: slot, and its flips moved later logits by up to 1.26e-3 (seen, on
#: (2, 2) at step 6 of 6; its first step within 7.5e-5)
DECODE_ATOL = {"zamba2-2.7b": 2.5e-3}

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_auto_mesh, use_mesh
from repro.optim.optimizers import OptimizerConfig, build_optimizer
from repro.runtime.parallel import ParallelContext, parallel_context
from repro.runtime.sharding import logical_batch_shardings, state_shardings
from repro.runtime.train import TrainConfig, make_train_step
from repro.models.model import build_model
d = np.load(sys.argv[1])
mesh = make_auto_mesh((2, 4), ("data", "model"))
rep = NamedSharding(mesh, P())
opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
# (config, optimizer) of each train run
cfgs = {"mixtral-tp": (dataclasses.replace(
            reduced(ARCHS["mixtral-8x22b"]), n_experts=2,
            experts_per_token=2, unit=()), "adamw"),
        "mamba2-130m": (reduced(ARCHS["mamba2-130m"]), "adamw"),
        "smollm-adafactor": (dataclasses.replace(
            reduced(ARCHS["smollm-360m"]), d_model=128, d_ff=256),
            "adafactor")}
out = {}

def tree(prefix):
    params = {}
    for key in d.files:
        if key.startswith(prefix):
            node, parts = params, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(d[key])
    return params

for name, (cfg, opt_name) in cfgs.items():
    params = tree(f"{name}/params/")
    o = dataclasses.replace(opt, name=opt_name)
    step, _ = make_train_step(cfg, TrainConfig(
        optimizer=o, remat=False, aux_loss_weight=0.0))
    state = {"params": params, "opt": build_optimizer(o).init(params),
             "step": jnp.zeros((), jnp.int32)}
    out[name] = []
    for i in (0, 1):
        batch = {k: jnp.asarray(d[f"{name}/batch{i}/{k}"])
                 for k in ("tokens", "labels")}
        sh = state_shardings(mesh, state, opt_name)
        with use_mesh(mesh), parallel_context(
                ParallelContext(capacity_factor=8.0)):
            state, m = jax.jit(step, in_shardings=(
                sh, logical_batch_shardings(mesh, batch)),
                out_shardings=(sh, rep))(state, batch)
        out[name].append(float(m["loss"]))
    if opt_name == "adafactor":
        # its whole state after the second step, for the port's to meet
        np.savez(sys.argv[3], **{
            "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                {"params": state["params"], "opt": state["opt"]})[0]})

# memory_analysis of the memory test's cells (remat, 4 x 64 tokens)
out["memory"] = {}
for units in json.loads(sys.argv[2]):
    cfg = dataclasses.replace(reduced(ARCHS["chatglm3-6b"]), n_layers=units,
                              unit=())
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    step, _ = make_train_step(cfg, TrainConfig(optimizer=opt, remat=True))
    state = {"params": params, "opt": build_optimizer(opt).init(params),
             "step": jnp.zeros((), jnp.int32)}
    state = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         state)
    batch = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32)
             for k in ("tokens", "labels")}
    sh = state_shardings(mesh, state, "adamw")
    with use_mesh(mesh):
        ma = jax.jit(step, in_shardings=(
            sh, logical_batch_shardings(mesh, batch)),
            out_shardings=(sh, rep)).lower(state, batch).compile(
            ).memory_analysis()
    out["memory"][str(units)] = [ma.argument_size_in_bytes,
                                 ma.temp_size_in_bytes]
# a train step whose 6 heads do not divide 'model' (4), at 2 x 4096
# tokens: the reference's "auto" attention streams keys in chunks above
# 2048 keys
cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), n_heads=6, unit=())
params = build_model(cfg).init(jax.random.PRNGKey(0))
step, _ = make_train_step(cfg, TrainConfig(optimizer=opt))
state = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), {
    "params": params, "opt": build_optimizer(opt).init(params),
    "step": jnp.zeros((), jnp.int32)})
batch = {k: jax.ShapeDtypeStruct((2, 4096), jnp.int32)
         for k in ("tokens", "labels")}
sh = state_shardings(mesh, state, "adamw")
with use_mesh(mesh):
    ma = jax.jit(step, in_shardings=(
        sh, logical_batch_shardings(mesh, batch)),
        out_shardings=(sh, rep)).lower(state, batch).compile(
        ).memory_analysis()
out["attention_memory"] = [ma.argument_size_in_bytes, ma.temp_size_in_bytes]
# the collectives of the (2, 4) programs beside the port's pinned counts
# (`test_torch_tensor_parallel.py: PINNED`): train at 4 x 64 tokens, and
# kimi's decode of 4 slots (its dropless path)
from repro.launch.roofline import collective_bytes
from repro.runtime.serve import ServeConfig, make_serve_fns
from repro.runtime.sharding import cache_shardings, params_shardings
shapes = lambda t: jax.tree.map(
    lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t)
out["collectives"] = {}
for arch, remat in (("smollm-360m", False), ("smollm-360m", True),
                    ("mixtral-8x22b", False), ("mamba2-130m", False),
                    ("zamba2-2.7b", False)):
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    step, _ = make_train_step(cfg, TrainConfig(optimizer=opt, remat=remat))
    state = shapes({"params": params, "opt": build_optimizer(opt).init(
        params), "step": jnp.zeros((), jnp.int32)})
    batch = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32)
             for k in ("tokens", "labels")}
    sh = state_shardings(mesh, state, "adamw")
    with use_mesh(mesh), parallel_context(ParallelContext()):
        hlo = jax.jit(step, in_shardings=(
            sh, logical_batch_shardings(mesh, batch)),
            out_shardings=(sh, rep)).lower(state, batch).compile().as_text()
    out["collectives"][f"{arch} train remat={remat}"] = \
        collective_bytes(hlo).per_op
cfg = reduced(ARCHS["kimi-k2-1t-a32b"])
_, dec, init_cache = make_serve_fns(cfg, ServeConfig(max_len=256))
params = shapes(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                             build_model(cfg).init(jax.random.PRNGKey(0))))
cache = shapes(init_cache(4))
tok = jax.ShapeDtypeStruct((4, 1), jnp.int32)
with use_mesh(mesh), parallel_context(ParallelContext()):
    hlo = jax.jit(dec, in_shardings=(
        params_shardings(mesh, params), cache_shardings(mesh, cache),
        logical_batch_shardings(mesh, tok), rep)).lower(
        params, cache, tok, jnp.int32(255)).compile().as_text()
out["collectives"]["kimi-k2-1t-a32b decode 4 slots"] = \
    collective_bytes(hlo).per_op
print(json.dumps(out))
"""


def _config(name):
    if name == ADAFACTOR_ARCH:
        return dataclasses.replace(reduced(ARCHS["smollm-360m"]),
                                   d_model=128, d_ff=256)
    if name == "mamba2-heads":
        return dataclasses.replace(reduced(ARCHS["mamba2-130m"]),
                                   d_model=48, ssm_head_dim=3)
    if name == "mixtral-tp":
        return dataclasses.replace(reduced(ARCHS["mixtral-8x22b"]),
                                   n_experts=2, experts_per_token=2, unit=())
    if name == "kimi-dropless":
        return reduced(ARCHS["kimi-k2-1t-a32b"])
    return reduced(ARCHS[name])


def _batches(cfg, name):
    """Two train batches: 2 x 15 tokens for mixtral-tp and kimi-dropless
    (30 tokens, which 2 data ranks divide and 2 x 2 or 2 x 4 do not),
    else 4 x 16."""
    from _torch_parity import train_batch
    B, S = (2, 15) if name in ("mixtral-tp", "kimi-dropless") else (4, 16)
    return [train_batch(cfg, S, B, "float32", step=i)[1] for i in (0, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    train, decode = {}, {}
    rng = np.random.default_rng(11)
    for name in ARCHS_HERE + (ADAFACTOR_ARCH,):
        cfg = _config(name)
        moe = bool(cfg.n_experts)
        bucketed = moe and name != "kimi-dropless"
        train[name] = {"cfg": cfg, "batches": _batches(cfg, name),
                       "opt": ADAFACTOR_OPT if name == ADAFACTOR_ARCH
                       else OPT,
                       "params": _float32_params(cfg, 5), "remat": True,
                       "capacity": 8.0 if bucketed else 1.25,
                       "aux": 0.0 if bucketed else 0.01}
    for name in ARCHS_HERE + DECODE_ONLY:
        cfg = _config(name)
        feed = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SLOTS[name], DECODE_STEPS)).astype(np.int32))
        decode[name] = {"cfg": cfg, "params": _float32_params(cfg, 6),
                        "feed": feed, "max_len": DECODE_LEN,
                        "capacity": 8.0}
    started = {}
    for mesh_name, shape in MESHES.items():
        work = tmp_path_factory.mktemp(f"unit_{mesh_name}")
        torch.save({"mesh": shape, "train": train, "decode": decode},
                   work / "tp_in.pt")
        started[mesh_name] = start_ranks("tp", shape[0] * shape[1], work)
    ref_dir = tmp_path_factory.mktemp("unit_ref")
    ref_in, ref_state = ref_dir / "in.npz", ref_dir / "adafactor_state.npz"
    flat = {}
    for name in ("mixtral-tp", "mamba2-130m", ADAFACTOR_ARCH):
        run = train[name]
        flat.update({f"{name}/params/{k}": v.numpy()
                     for k, v in _flat(run["params"]).items()})
        for i, b in enumerate(run["batches"]):
            flat.update({f"{name}/batch{i}/{k}": v.numpy()
                         for k, v in b.items()})
    np.savez(ref_in, **flat)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_in),
         json.dumps(MEMORY_UNITS), str(ref_state)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        want = {
            "train": {n: _train_meshless(r["cfg"], r["params"], r["batches"],
                                         r["aux"], opt=r["opt"])
                      for n, r in train.items()},
            "decode": {n: _decode_meshless(r["cfg"], r["params"], r["feed"])
                       for n, r in decode.items()},
            "params": {n: _flat(r["params"]) for n, r in train.items()}}
        got = {m: finish(s, TIMEOUT_S) for m, s in started.items()}
    finally:
        for s in started.values():
            for proc, _ in s[1]:
                if proc.poll() is None:
                    proc.kill()
        out, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err[-3000:]
    ref_out = json.loads(out.strip().splitlines()[-1])
    with np.load(ref_state) as saved:
        ref_out["adafactor_state"] = {k: torch.from_numpy(saved[k])
                                      for k in saved.files}
    return got, want, ref_out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_steps_equal_the_meshless_steps(runs, mesh, arch):
    got, want, _ = runs
    want_losses, want_state = want["train"][arch]
    want_state, old = _flat(want_state), want["params"][arch]
    ill = arch in ILL_CONDITIONED
    for rank in got[mesh]:
        run = rank["train"][arch]
        np.testing.assert_allclose(run["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        state = run["state"]
        assert state.keys() == want_state.keys()
        for name, w in want_state.items():
            g = state[name]
            if name.startswith("opt/") or name == "step":
                atol = ILL_STATE * float(w.abs().max()) if ill else \
                    STATE_ATOL
                torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)
                continue
            if not ill:
                mu = want_state["opt/mu/" + name[len("params/"):]]
                settled = mu.abs() > 1e-3 * mu.abs().max()
                torch.testing.assert_close(g[settled], w[settled], rtol=0,
                                           atol=PARAM_ATOL, msg=name)
            assert float((g - w).abs().max()) <= 2 * STEP_BOUND, name
    assert any(not torch.equal(want_state["params/" + n], t)
               for n, t in old.items())


def _adafactor_state_close(state, want, where):
    """The Adafactor run's whole state held to `want` (flat, the same
    keys): its factored and unfactored second moments within
    ADAFACTOR_STATE of each leaf's largest, params within PARAM_ATOL
    (each step moves a weight by at most about lr: the update is clipped
    to RMS 1)."""
    assert state.keys() >= want.keys() and want, where
    for name, w in want.items():
        g = state[name]
        top = float(w.abs().max()) if name.startswith("opt/") else 1.0
        atol = (ADAFACTOR_STATE if name.startswith("opt/") else
                PARAM_ATOL) * top
        torch.testing.assert_close(g, w, rtol=0, atol=atol,
                                   msg=f"{where} {name}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_adafactor_on_the_ranks_shards_equals_the_meshless_step(runs, mesh):
    got, want, _ = runs
    want_losses, want_state = want["train"][ADAFACTOR_ARCH]
    want_state = {k: v for k, v in _flat(want_state).items() if k != "step"}
    for r, rank in enumerate(got[mesh]):
        run = rank["train"][ADAFACTOR_ARCH]
        np.testing.assert_allclose(run["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        _adafactor_state_close(run["state"], want_state, f"{mesh} rank {r}")
    old = want["params"][ADAFACTOR_ARCH]
    assert any(not torch.equal(want_state["params/" + n], t)
               for n, t in old.items())


def test_2x4_adafactor_equals_the_references_sharded_step(runs):
    """Two Adafactor steps on (2, 4) against the reference's compiled
    sharded step, whose factored leaves GSPMD keeps at each device's
    shards: the losses within LOSS_RTOL, the whole state as
    `_adafactor_state_close` holds it.  At least one factored leaf (the
    MLP stacks) is split on each of its last two dims, so that both of
    its means are summed over the ranks."""
    from repro_torch.optim.optimizers import _factored
    from repro_torch.runtime.sharding import param_spec
    got, _, ref = runs
    losses = ref[ADAFACTOR_ARCH]
    want = ref["adafactor_state"]
    for r, rank in enumerate(got["2x4"]):
        run = rank["train"][ADAFACTOR_ARCH]
        np.testing.assert_allclose(run["losses"], losses, rtol=LOSS_RTOL)
        _adafactor_state_close(run["state"], want, f"2x4 rank {r}")
    params = {k[len("params/"):]: v for k, v in want.items()
              if k.startswith("params/")}
    both = [name for name, p in params.items() if _factored(p) and all(
        param_spec(_Stub(), name, tuple(p.shape))[-k] for k in (1, 2))]
    assert both, sorted(params)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS_HERE + DECODE_ONLY)
def test_decode_gives_the_meshless_tokens(runs, mesh, arch):
    got, want, _ = runs
    want_toks, want_logits = want["decode"][arch]
    for rank in got[mesh]:
        run = rank["decode"][arch]
        torch.testing.assert_close(run["logits"], want_logits, rtol=0,
                                   atol=DECODE_ATOL.get(arch, LOGIT_ATOL))
        assert torch.equal(run["tokens"], want_toks)


@pytest.mark.parametrize("arch", ["mixtral-tp", "mamba2-130m"])
def test_2x4_losses_equal_the_references_sharded_step(runs, arch):
    from test_torch_tensor_parallel import _fake_mesh_count, _train_count
    got, want, ref = runs
    for cell, per_op in ref["collectives"].items():
        print("readings:", json.dumps(dict(reference_collectives=cell,
                                           **per_op)))
    if arch == "mamba2-130m":
        # the port's zamba2 mix beside the reference's (the other cells'
        # are `test_torch_tensor_parallel.py: PINNED`)
        rank = _fake_mesh_count(
            lambda mesh: _train_count(reduced(ARCHS["zamba2-2.7b"]), mesh))
        print("readings:", json.dumps(dict(
            port_collectives="zamba2-2.7b train remat=False",
            **rank.coll_per_op)))
    np.testing.assert_allclose(got["2x4"][0]["train"][arch]["losses"],
                               ref[arch], rtol=LOSS_RTOL)
    np.testing.assert_allclose(want["train"][arch][0], ref[arch],
                               rtol=LOSS_RTOL)


#: the whole step's peak of `_memory_cell(units)` with DTensor's sharding
#: propagation counted as the rank's memory, in a fresh process: its
#: caches run an operation's propagation only the first time it meets
#: the operation's shapes
PROPAGATION_PROBE = r"""
import contextlib, sys
sys.path[:0] = ["src", "tests"]
import pytest
import test_torch_unit_gather as T
from repro_torch.launch import roofline as RL
RL._propagation_apart = contextlib.nullcontext
print("STEP_PEAK", T._memory_cell(int(sys.argv[1]), pytest.MonkeyPatch())[4])
"""


def _memory_cell(units, monkeypatch):
    """(peak, params shard bytes, saved input bytes, stale, the whole
    step's peak) of the gradients of a remat step of reduced chatglm3
    with `units` units on a fake (2, 4) group (`compute_grads` of the
    mesh's loss: the forward, the recompute and the backward, without
    the optimizer's update): `stale` counts, at each gather, the
    earlier gathers' tensors still alive."""
    from repro_torch.runtime.train import (compute_grads, make_loss_fn,
                                           mesh_loss_fn)
    cfg = dataclasses.replace(reduced(ARCHS["chatglm3-6b"]), n_layers=units,
                              unit=())
    real, refs, stale = parallel.gather_unit, [], []

    def spy(unit):
        stale.append(sum(r() is not None for r in refs))
        out = real(unit)
        refs.extend(weakref.ref(t) for t in leaves(out)
                    if isinstance(t, torch.Tensor))
        return out

    monkeypatch.setattr(parallel, "gather_unit", spy)
    tcfg = TrainConfig(remat=True)
    with RL.fake_group(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), device="cpu")
        loss = mesh_loss_fn(make_loss_fn(cfg, tcfg, "cpu"), mesh)
        with use_mesh(mesh), parallel_context(ParallelContext()):
            step, init = make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
            with FakeTensorMode():
                state = init(torch.Generator().manual_seed(0))
                placed = place(state, state_shardings(mesh, state, "adamw"))
                batch = {k: torch.zeros((4, 64), dtype=torch.int32)
                         for k in ("tokens", "labels")}
            _, ex = RL.count(lambda p, b: compute_grads(loss, p, b),
                             placed["params"], batch)
            monkeypatch.undo()
            _, whole = RL.count(step, placed, batch)
    x_bytes = 2 * 64 * cfg.d_model * 2      # 2 rows of 64, bf16
    return (ex.peak_bytes, RL.local_bytes(placed["params"]), x_bytes, stale,
            whole.peak_bytes)


def test_one_units_weights_at_a_time_and_the_peak_per_unit(runs,
                                                           monkeypatch):
    _, _, ref = runs
    cells = {u: _memory_cell(u, monkeypatch) for u in MEMORY_UNITS}
    for units, (_, _, _, stale, _) in cells.items():
        # the forward's gathers and the recompute's, each unit once
        assert len(stale) == 2 * units
        assert not any(stale), stale
    (p0, s0, x, *_), (p1, s1, *_) = (cells[u] for u in MEMORY_UNITS)
    added = MEMORY_UNITS[1] - MEMORY_UNITS[0]
    shards = (s1 - s0) / added
    # a unit's params shards, their gradient, and the input the unit's
    # checkpoint saves (gathering every unit up front, as the step did
    # before, grows it by 47104 B a unit here: the gathered weights of
    # each unit stay alive through the step)
    bound = 2 * shards + x
    grew = (p1 - p0) / added
    probe = subprocess.run(
        [sys.executable, "-c", PROPAGATION_PROBE, str(MEMORY_UNITS[0])],
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert "STEP_PEAK" in probe.stdout, probe.stdout + probe.stderr
    with_prop = int(probe.stdout.split("STEP_PEAK")[1].split()[0])
    # `count` leaves DTensor's propagation on whole-shape fakes out
    assert cells[MEMORY_UNITS[0]][4] < with_prop
    print("readings:", json.dumps(dict(
        units=MEMORY_UNITS[0], step_peak_with_propagation_counted=with_prop,
        port_step_peak_bytes=cells[MEMORY_UNITS[0]][4])))
    for units, (peak, held, _, _, step_peak) in cells.items():
        print("readings:", json.dumps(dict(
            cell=f"chatglm3 reduced, {units} units, (2, 4), remat",
            port_grads_peak_bytes=peak, port_step_peak_bytes=step_peak,
            port_params_shard_bytes=held,
            reference_argument_plus_temp=sum(ref["memory"][str(units)]),
            step_ratio=step_peak / sum(ref["memory"][str(units)]))))
    print("readings:", json.dumps(dict(peak_per_unit=grew, bound=bound,
                                       unit_params_shard=shards)))
    assert grew <= bound, (grew, bound)


class _Stub:
    """A mesh's shape and this rank's coordinates, for the rules."""
    shape = {"data": 2, "model": 4}

    def index(self, axis):
        return {"data": 1, "model": 2}[axis]


def test_an_expert_path_refuses_a_whole_stack_and_takes_its_shard():
    from repro_torch.models import moe
    cfg = reduced(ARCHS["kimi-k2-1t-a32b"])
    stacks = {k: torch.zeros(shape) for k, shape in moe._whole(cfg).items()}
    with use_mesh(_Stub()), parallel_context(ParallelContext()):
        for path in ("expert", "tp_ff", "dropless"):
            with pytest.raises(ValueError, match=path):
                moe._path_stacks(dict(stacks), cfg, path)
            shards = tp_local(_Stub(), {"moe": stacks}, path)["moe"]
            got = moe._path_stacks(dict(shards), cfg, path)
            assert all(got[k] is shards[k] for k in shards)


def test_no_whole_model_on_a_rank_and_the_adafactor_reading():
    """Reduced mixtral at d = 1024 (2 layers, 16 x 16 tokens) on a fake
    (16, 16) group: with AdamW and with Adafactor the train step's peak
    stays under a quarter of the whole model's bf16 params (each rank
    gathers one unit at a time, at its shards, and Adafactor's factored
    update runs on the rank's shards, its means summed over the axes
    that split them); both are printed (a `readings:` line, run with
    -s)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import OptimizerConfig
    cfg = dataclasses.replace(reduced(ARCHS["mixtral-8x22b"]), d_model=1024,
                              d_ff=4096, moe_d_ff=4096, vocab_size=4096,
                              n_heads=16, head_dim=64, unit=())
    whole = cfg.param_count() * 2
    peaks = {}
    for name in ("adamw", "adafactor"):
        with RL.fake_group(256):
            mesh = make_auto_mesh((16, 16), ("data", "model"), device="cpu")
            with use_mesh(mesh), parallel_context(ParallelContext()), \
                    pytest.MonkeyPatch.context() as mp:
                mp.setattr(dryrun, "optimizer_for",
                           lambda c, n=name: OptimizerConfig(name=n))
                peaks[name] = dryrun.count_train_cell(
                    cfg, ShapeConfig("t", 16, 16, "train"), mesh)[2][
                    "peak_bytes"]
    print("readings:", json.dumps(dict(whole_params_bf16=whole, **{
        f"{k}_step_peak": v for k, v in peaks.items()})))
    assert peaks["adamw"] < whole / 4
    assert peaks["adafactor"] < whole / 4


def test_the_mixer_moves_its_heads_columns_and_the_squares_over_model(
        monkeypatch):
    """Reduced zamba2's mixer forward (`mamba_block`, plain routes) on a
    fake (2, 4) group, rank 0's 2 x 64 rows: over 'model' it receives
    by all-to-all at most its 2 heads' columns of z and x (2 x 16
    each), dt (2) and B and C (2N = 32), and all-reduces one float32 a
    row (the gated norm's squares) beside `out_proj`'s row-parallel sum;
    it gathers nothing (the fused and the gated output stay at the
    rank's columns)."""
    from repro_torch.models.ssm import mamba_block, mamba_init
    cfg = reduced(ARCHS["zamba2-2.7b"])
    rows, L = 2, 64

    def no_gather(*args, **kwargs):
        raise AssertionError("the split-heads mixer gathered over 'model'")

    monkeypatch.setattr(parallel, "gather_model", no_gather)
    with RL.fake_group(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), device="cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            with FakeTensorMode():
                params = mamba_init(torch.Generator().manual_seed(0), cfg)
                local = tp_local(mesh, {"mamba": params})["mamba"]
                x = torch.zeros((rows, L, cfg.d_model), dtype=torch.bfloat16)
            heads = cfg.n_ssm_heads // mesh.shape["model"]
            with torch.no_grad():
                rl, _ = RL.count(lambda p, v: mamba_block(p, v, cfg, "naive"),
                                 local, x)
    cols = 2 * heads * cfg.ssm_head_dim + heads + 2 * cfg.ssm_state
    bound = rows * L * cols * 2                         # bf16
    squares = rows * L * 4
    out_sum = rows * L * cfg.d_model * 2
    print("readings:", json.dumps(dict(
        cell="zamba2 reduced mixer forward, fake (2, 4), rank 0",
        heads_columns_bound=bound, **rl.coll_per_op)))
    assert set(rl.coll_per_op) == {"all-to-all", "all-reduce"}, \
        rl.coll_per_op
    assert rl.coll_per_op["all-to-all"] <= bound
    assert rl.coll_per_op["all-reduce"] == squares + out_sum


def test_attention_memory_beside_the_references(runs):
    """A train step whose heads do not divide 'model' (reduced smollm
    with 6 heads on a (2, 4) mesh, 2 x 4096 tokens, remat): the port's
    count (`dryrun.count_train_cell` on a fake group) has rank 0's
    arguments equal to the reference's `memory_analysis()` of its
    compiled step, and its peak is printed beside the reference's
    argument + temp bytes (a `readings:` line, run with -s): every rank
    attends with all 6 heads, whose (2 / 2, 6, 4096, 4096) float32
    scores the port's plain attention keeps (24 MB a layer's
    probabilities) where the reference's chunked attention streams the
    keys."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from test_torch_tensor_parallel import _config as tp_config
    cfg = tp_config("smollm-split")
    with RL.fake_group(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), device="cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            memory = dryrun.count_train_cell(
                cfg, ShapeConfig("t", 4096, 2, "train"), mesh)[2]
    arg, temp = runs[2]["attention_memory"]
    print("readings:", json.dumps(dict(
        cell="smollm reduced, 6 heads, (2, 4), 2 x 4096, remat",
        port_argument_bytes=memory["argument_size_in_bytes"],
        port_peak_bytes=memory["peak_bytes"],
        reference_argument_bytes=arg, reference_temp_bytes=temp,
        port_peak_over_reference_argument_plus_temp=memory["peak_bytes"]
        / (arg + temp))))
    assert memory["argument_size_in_bytes"] == arg
