"""Tensor-parallel compute over 'model' and serving with the slots sharded
over the data axes, on gloo ranks on the CPU, against the meshless port
and the JAX package's compiled sharded programs.

- Two float32 AdamW train steps on (2, 2), (1, 4) and (2, 4) meshes
  equal the meshless steps, under `test_torch_distributed_train.py`'s
  tolerances (loss 1e-5 relative; optimizer state 1e-6; params 1e-4
  where the first moment is clear of zero, at most one step elsewhere),
  for reduced smollm (4 heads: whole heads a rank; 6 heads of 16,
  which a 'model' shard of 4 splits; and the "gather" cross-entropy,
  which gathers the vocab-parallel logits first), chatglm3 (2 kv heads, QKV bias,
  half RoPE), gemma2 (tied table, softcaps, GeGLU), mixtral (attention
  tensor-parallel beside the expert paths, at capacity 8.0 so that no
  row drops, and the aux loss off, whose per-shard means the dropless
  step does not take; the dropless step is the reference; its optimizer
  state within 1e-3 of each leaf's largest, since its float32 step is
  ill-conditioned on these weights: a 1e-7 relative change of the
  embedding alone moves its meshless moments by up to 2e-4 of the
  largest, the size of the mesh's differences; its params within two
  steps) and seamless
  (cross-attention; in bf16, as its encoder casts its input to bf16 like
  the reference's: loss 1e-3 relative (seen 1.6e-4); the optimizer
  moments within 0.1 of the leaf's largest (seen 0.04: bf16 gradients
  whose partial sums add in another order across ranks); params within
  four steps and two bf16 ulps, 2^-6 relative: a bf16 gradient near
  zero may take either sign at each step, and each step rounds).  On (2, 4) reduced smollm's losses also equal the
  reference's compiled sharded step on 8 host devices (1e-5 relative).
- The decode step on (2, 4) with 4 slots and with 1 slot (the cache's
  ring split over 'model': 2 kv heads do not divide 4), on smollm with
  an 8-token window over a 16-slot cache, 20 fed tokens (the ring wraps):
  the meshless port's next tokens, and its logits within 1e-3 (float32
  params; each step's own sums differ by ~1e-6, but the cache is bf16,
  as the reference's, and a key or value the row-parallel sums move by a
  float32 ulp can round to the next bf16 value, 2^-8 of it, which moves
  later logits by up to 2.6e-4 as seen).  With bf16 params (the
  reference's decode refuses float32 ones: its bf16 cache takes no
  float32 key) against the reference's decode compiled on (2, 4): logits
  within 0.15 and the tokens wherever the reference's top-2 margin
  exceeds 0.3, `test_torch_serve.py`'s bounds (the two packages round
  bf16 activations at different points).
- `serve_loop` on four gloo ranks, a (2, 2) mesh with 4 slots, gives
  the meshless loop's tokens for smollm and for mamba2.
- The per-rank FLOPs and collective bytes by op on a fake (2, 4) group
  are pinned (smollm's train step also under remat, whose recompute
  gathers each unit's weights again, mixtral's, whose expert stacks are
  gathered at the expert-parallel path's shard, mamba2's, whose mixer
  projections are column- and row-parallel, and kimi-k2's 4-slot
  decode, whose dropless path multiplies the stacks as placed); the
  meshless count
  over the per-rank count is 8 for the dense train steps and for
  smollm's 4-slot decode, at least the reference's `cost_analysis`
  ratio on the same cells.
- `decode_partial` over slices of a cache, combined by
  `combine_partials`, equals `sdpa_naive` over the whole cache (1e-6).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_auto_mesh, use_mesh
from repro_torch.launch.serve import make_requests, serve_loop
from repro_torch.models import build_model
from repro_torch.models.attention import (combine_partials, decode_partial,
                                          ring_positions, sdpa_naive)
from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
from repro_torch.runtime.parallel import ParallelContext, parallel_context
from repro_torch.runtime.serve import ServeConfig, make_serve_fns
from repro_torch.runtime.sharding import P, compute_spec, shard_slices
from repro_torch.runtime.train import TrainConfig, make_train_step
from repro_torch.tree import named_leaves, tree_map

from _torch_dist import finish, start_ranks, tp_local
from _torch_parity import both_params, configs, numpy_params, train_batch

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4)}
TRAIN_ARCHS = ("smollm-360m", "smollm-split", "smollm-gather", "chatglm3-6b",
               "gemma2-2b", "mixtral-8x22b", "seamless-m4t-large-v2")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 4, 16
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-6
PARAM_ATOL = 1e-4
STEP_BOUND = OPT["lr"] * 1.1
LOGIT_ATOL = 1e-3
BF16_STATE = 0.1
BF16_LOSS_RTOL = 1e-3
#: optimizer state bound relative to the leaf's largest, where the
#: meshless float32 step itself moves that much under a 1e-7 change
ILL_CONDITIONED = {"mixtral-8x22b": 1e-3}
REF_TOL = 0.15      # bf16 decode logits, port vs reference (test_torch_serve)
BF16_RTOL = 2.0 ** -6
DECODE_LEN, DECODE_STEPS = 16, 20
TIMEOUT_S = 420

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_auto_mesh, use_mesh
from repro.launch.roofline import cost_analysis
from repro.optim.optimizers import OptimizerConfig, build_optimizer
from repro.runtime.serve import ServeConfig, make_serve_fns
from repro.runtime.sharding import (cache_shardings,
                                    logical_batch_shardings,
                                    params_shardings, state_shardings)
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
flops = lambda c: float(cost_analysis(c)["flops"])
opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
step, _ = make_train_step(cfg, TrainConfig(optimizer=opt, remat=False))
state = {"params": params, "opt": build_optimizer(opt).init(params),
         "step": jnp.zeros((), jnp.int32)}
out = {"losses": []}
for i in (0, 1):
    batch = {k: jnp.asarray(d[f"batch{i}/{k}"]) for k in ("tokens", "labels")}
    sh = state_shardings(mesh, state, "adamw")
    with use_mesh(mesh):
        jstep = jax.jit(step, in_shardings=(
            sh, logical_batch_shardings(mesh, batch)), out_shardings=(sh, rep))
        if i == 0:      # the cost at the pinned count's 4 x 64 tokens
            cost = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32)
                    for k in batch}
            out["train_flops"] = [
                flops(jax.jit(step, in_shardings=(
                    sh, logical_batch_shardings(mesh, cost)),
                    out_shardings=(sh, rep)).lower(state, cost).compile()),
                flops(jax.jit(step).lower(state, cost).compile())]
        state, m = jstep(state, batch)
    out["losses"].append(float(m["loss"]))

def decoder(dcfg, max_len):
    _, dec, init_cache = make_serve_fns(dcfg, ServeConfig(max_len=max_len))
    return dec, init_cache

def sharded(dec, cache, tok):
    return jax.jit(dec, in_shardings=(
        params_shardings(mesh, params), cache_shardings(mesh, cache),
        logical_batch_shardings(mesh, tok), rep))

wcfg = dataclasses.replace(cfg, sliding_window=8, unit=())
dec, init_cache = decoder(wcfg, int(sys.argv[2]))
bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
for slots in (4, 1):
    feed = d[f"feed{slots}"]
    cache = init_cache(slots)
    tok = jnp.asarray(feed[:, :1])
    toks, logits = [], []
    with use_mesh(mesh):
        jd = sharded(dec, cache, tok)
        for pos in range(feed.shape[1]):
            nxt, lg, cache = jd(bf16, cache,
                                jnp.asarray(feed[:, pos:pos + 1]),
                                jnp.int32(pos))
            toks.append(np.asarray(nxt))
            logits.append(np.asarray(lg, np.float32))
    np.save(sys.argv[3] + f"/tokens{slots}.npy", np.concatenate(toks, 1))
    np.save(sys.argv[3] + f"/logits{slots}.npy", np.concatenate(logits, 1))

dec, init_cache = decoder(cfg, 256)
cache = init_cache(4)
tok = jnp.zeros((4, 1), jnp.int32)
with use_mesh(mesh):
    mesh_c = sharded(dec, cache, tok).lower(bf16, cache, tok,
                                            jnp.int32(255)).compile()
out["decode_flops"] = [flops(mesh_c), flops(jax.jit(dec).lower(
    bf16, cache, tok, jnp.int32(255)).compile())]
print(json.dumps(out))
"""


def _config(name):
    if name == "smollm-split":     # 6 heads of 16: a shard of 4 splits one
        return dataclasses.replace(reduced(ARCHS["smollm-360m"]), n_heads=6,
                                   unit=())
    return reduced(ARCHS[name])


def _float32_params(cfg, seed=0):
    """The port's initial params, in float32 (bf16 for an encoder-decoder:
    its encoder casts its input to bf16, as the reference's does)."""
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    return params if cfg.is_encdec else tree_map(lambda t: t.float(), params)


def _batches(cfg):
    return [train_batch(cfg, S, B, "float32", step=i)[1] for i in (0, 1)]


def _train_meshless(cfg, params, batches, aux=0.01, loss_impl="onehot",
                    opt=OPT):
    step_fn, _ = make_train_step(cfg, TrainConfig(
        optimizer=OptimizerConfig(**opt), remat=False, aux_loss_weight=aux,
        loss_impl=loss_impl), "cpu")
    state = {"params": params,
             "opt": build_optimizer(OptimizerConfig(**opt)).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for batch in batches:
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


def _decode_meshless(cfg, params, feed):
    _, step, init_cache = make_serve_fns(
        cfg, ServeConfig(max_len=DECODE_LEN), "cpu")
    cache = init_cache(feed.shape[0])
    toks, logits = [], []
    for pos in range(feed.shape[1]):
        nxt, lg, cache = step(params, cache, feed[:, pos:pos + 1], pos)
        toks.append(nxt)
        logits.append(lg[:, -1:])
    return torch.cat(toks, 1), torch.cat(logits, 1)


def _serve_runs():
    out = {}
    for arch in ("smollm-360m", "mamba2-130m"):
        cfg = reduced(ARCHS[arch])
        out[arch] = {"cfg": cfg, "params": _float32_params(cfg, 3),
                     "queue": make_requests(7, cfg.vocab_size), "slots": 4,
                     "max_new": 5, "max_len": 32}
    return out


def _flat(tree):
    return {"/".join(p): t for p, t in named_leaves(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh and the reference, started together; the
    meshless port's runs while they work."""
    jcfg, scfg = configs("smollm-360m")
    jparams, smollm = both_params(numpy_params(jcfg), "float32")
    train = {}
    for name in TRAIN_ARCHS:
        whole = name in ("smollm-360m", "smollm-gather")
        cfg = scfg if whole else _config(name)
        train[name] = {"cfg": cfg, "opt": OPT, "batches": _batches(cfg),
                       "params": smollm if whole else _float32_params(cfg),
                       "capacity": 8.0 if cfg.n_experts else 1.25,
                       "aux": 0.0 if cfg.n_experts else 0.01,
                       "loss_impl": ("gather" if name == "smollm-gather"
                                     else "onehot")}
    wcfg = dataclasses.replace(scfg, sliding_window=8, unit=())
    rng = np.random.default_rng(7)
    feeds = {s: torch.from_numpy(rng.integers(
        0, wcfg.vocab_size, (s, DECODE_STEPS)).astype(np.int32))
        for s in (4, 1)}
    decode = {f"slots{s}": {"cfg": wcfg, "params": smollm, "feed": f,
                            "max_len": DECODE_LEN} for s, f in feeds.items()}
    bf16 = tree_map(lambda t: t.bfloat16(), smollm)
    decode.update({f"{name}_bf16": dict(run, params=bf16)
                   for name, run in list(decode.items())})
    serve = _serve_runs()

    started = {}
    for mesh_name, shape in MESHES.items():
        work = tmp_path_factory.mktemp(f"tp_{mesh_name}")
        spec = {"mesh": shape, "train": train}
        if mesh_name == "2x4":
            spec["decode"] = decode
        if mesh_name == "2x2":
            spec["serve"] = serve
        torch.save(spec, work / "tp_in.pt")
        started[mesh_name] = start_ranks("tp", shape[0] * shape[1], work)
    ref_in = tmp_path_factory.mktemp("tp_ref") / "in.npz"
    flat = {"params/" + k: np.asarray(v) for k, v in _flat_jax(jparams)}
    for i, b in enumerate(train["smollm-360m"]["batches"]):
        flat.update({f"batch{i}/{k}": v.numpy() for k, v in b.items()})
    flat.update({f"feed{s}": f.numpy() for s, f in feeds.items()})
    np.savez(ref_in, **flat)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_in), str(DECODE_LEN),
         str(ref_in.parent)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        want = {
            "train": {n: _train_meshless(r["cfg"], r["params"],
                                         r["batches"], r["aux"],
                                         r["loss_impl"])
                      for n, r in train.items()},
            "decode": {n: _decode_meshless(r["cfg"], r["params"], r["feed"])
                       for n, r in decode.items() if "bf16" not in n},
            "serve": {n: serve_loop(r["params"], r["cfg"],
                                    ServeConfig(max_len=r["max_len"]),
                                    [list(q) for q in r["queue"]],
                                    r["slots"], r["max_new"], "cpu")[0]
                      for n, r in serve.items()},
            "params": {n: _flat(r["params"]) for n, r in train.items()}}
        got = {m: finish(s, TIMEOUT_S) for m, s in started.items()}
    finally:
        for m, s in started.items():
            for proc, _ in s[1]:
                if proc.poll() is None:
                    proc.kill()
        out, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    for name in ("tokens", "logits"):
        for slots in (4, 1):
            ref[f"{name}{slots}"] = np.load(ref_in.parent /
                                            f"{name}{slots}.npy")
    return got, want, ref


def _flat_jax(tree):
    import jax
    return [("/".join(k.key for k in path), v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_equal_the_meshless_steps(runs, mesh, arch):
    got, want, _ = runs
    want_losses, want_state = want["train"][arch]
    want_state, old = _flat(want_state), want["params"][arch]
    bf16 = next(iter(old.values())).dtype == torch.bfloat16
    for rank in got[mesh]:
        run = rank["train"][arch]
        np.testing.assert_allclose(run["losses"], want_losses,
                                   rtol=BF16_LOSS_RTOL if bf16 else LOSS_RTOL)
        state = run["state"]
        assert state.keys() == want_state.keys()
        for name, w in want_state.items():
            g = state[name]
            if bf16:
                g, w = g.float(), w.float()
                atol = (4 * STEP_BOUND if name.startswith("params/")
                        else BF16_STATE * float(w.abs().max()))
                torch.testing.assert_close(
                    g, w, rtol=BF16_RTOL if name.startswith("params/")
                    else 0.0, atol=atol, msg=name)
                continue
            if name.startswith("opt/") or name == "step":
                atol = STATE_ATOL if arch not in ILL_CONDITIONED else \
                    ILL_CONDITIONED[arch] * float(w.abs().max())
                torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)
                continue
            mu = want_state["opt/mu/" + name[len("params/"):]]
            settled = mu.abs() > 1e-3 * mu.abs().max()
            if arch not in ILL_CONDITIONED:
                torch.testing.assert_close(g[settled], w[settled], rtol=0,
                                           atol=PARAM_ATOL, msg=name)
            assert float((g - w).abs().max()) <= 2 * STEP_BOUND, name
    assert any(not torch.equal(want_state["params/" + n], t)
               for n, t in old.items())


def test_2x4_losses_equal_the_references_sharded_step(runs):
    got, want, ref = runs
    np.testing.assert_allclose(got["2x4"][0]["train"]["smollm-360m"]
                               ["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(want["train"]["smollm-360m"][0],
                               ref["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("slots", [4, 1])
def test_decode_on_2x4_gives_the_meshless_and_the_references_tokens(
        runs, slots):
    got, want, ref = runs
    want_toks, want_logits = want["decode"][f"slots{slots}"]
    for rank in got["2x4"]:
        run = rank["decode"][f"slots{slots}"]
        torch.testing.assert_close(run["logits"], want_logits, rtol=0,
                                   atol=LOGIT_ATOL)
        assert torch.equal(run["tokens"], want_toks)
    # bf16 against the reference's (2, 4) program: logits within its
    # decode tolerance, tokens where its top-2 margin is over twice that
    run = got["2x4"][0]["decode"][f"slots{slots}_bf16"]
    logits = run["logits"].float().numpy()
    np.testing.assert_allclose(logits, ref[f"logits{slots}"], rtol=0,
                               atol=REF_TOL)
    top2 = np.sort(ref[f"logits{slots}"], axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * REF_TOL
    assert sure.mean() > 0.5
    assert np.array_equal(run["tokens"].numpy()[sure],
                          ref[f"tokens{slots}"][sure])


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_serve_loop_on_four_ranks_gives_the_meshless_tokens(runs, arch):
    got, want, _ = runs
    assert len(want["serve"][arch]) == 7
    for rank in got["2x2"]:
        assert rank["serve"][arch] == want["serve"][arch]


def _fake_mesh_count(fn):
    with RL.fake_group(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), device="cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            return fn(mesh)


def _train_count(cfg, mesh=None, remat=False):
    from repro_torch.runtime.sharding import place, state_shardings
    step, init = make_train_step(cfg, TrainConfig(remat=remat),
                                 device="cpu", mesh=mesh)
    with FakeTensorMode():
        state = init(torch.Generator().manual_seed(0))
        if mesh is not None:
            state = place(state, state_shardings(mesh, state, "adamw"))
        batch = {k: torch.zeros((4, 64), dtype=torch.int32)
                 for k in ("tokens", "labels")}
    return RL.count(step, state, batch)[0]


def _decode_count(cfg, mesh=None):
    from repro_torch.launch.dryrun import count_decode_cell
    if mesh is not None:
        return count_decode_cell(cfg, ShapeConfig("d", 256, 4, "decode"),
                                 mesh)[0]
    _, step, init_cache = make_serve_fns(cfg, ServeConfig(max_len=256),
                                         "cpu")
    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        cache = init_cache(4)
        tok = torch.zeros((4, 1), dtype=torch.int32)
    return RL.count(step, params, cache, tok, 255)[0]


#: rank 0's collective bytes by op on the fake (2, 4) group.  The
#: weights of reduced smollm's 2 units, gathered over 'data' at their
#: 'model' shard (bf16): per unit wq and wo 64 x 16 (2048 B each), wk
#: and wv 64 x 8 (1024 B each), w_up, w_gate and w_down 64 x 32 (4096 B
#: each), 18432 B; 36864 B for both, and the forward's gathers of
#: activations 32768 B more; the gradients reduce-scattered back to the
#: halves, 18432 B.  Under remat the recompute gathers the weights and
#: the activations again (2 x (36864 + 32768)); the reduce-scatter runs
#: once.  Reduced mixtral's expert stacks (2 units, 8 experts of
#: 64 x 32, 'model' on the experts, 'data' on d) take the
#: expert-parallel path at 4 x 64 tokens: each rank gathers its 2
#: experts of each stack over 'data', 2 x 64 x 32 x 2 B = 8192 B, 49152
#: B for the 6 stacks (whole stacks gathered over both axes moved 294912
#: B), and reduce-scatters 24576 B of their gradients.  Reduced mamba2's
#: mixers (2 units; 2 x 64 tokens a rank, bf16): `in_proj`'s 74 of 296
#: columns and `out_proj`'s 32 of 128 rows gathered over 'data', 9472 +
#: 4096 B a unit (27136 B; 13568 B reduce-scattered back); the rank's
#: columns of the fused output moved over 'model' by one all-to-all
#: (`parallel.move_model_columns`): rank 0 receives its 2 heads' z and
#: x (32 + 32), B and C (32) and dt (2), 98 columns of 128 rows, 25088
#: B, and the adjoint sends back the gradients of the 74 columns it
#: computed, 18944 B, 44032 B a unit; all-reduce a unit: `out_proj`'s
#: row-parallel sum forward and back (2 x 16384 B) and the gated norm's
#: squares, one float32 a row forward and back (2 x 512 B), 67584 B for
#: both, beside the vocabulary's 52132 B.  Reduced kimi-k2's 4-slot
#: decode takes the dropless path on the stacks as placed (2 of 8
#: experts a rank on 'model', 32 of d = 64 on 'data'; its 8 routed rows
#: gathered whole): gate's and up's partial products (8 x 32 bf16, 512
#: B) summed over 'model' and 'data', down's over 'model', 2560 B of
#: all-reduce a unit, and down's output gathered over 'data' (8 x 64,
#: 1024 B a unit); whole stacks gathered moved 316000 B of all-gather.
PINNED = {
    ("smollm-360m", "train"): {"all-gather": 69632.0,
                               "all-reduce": 208676.0,
                               "reduce-scatter": 18432.0},
    ("smollm-360m", "train-remat"): {"all-gather": 139264.0,
                                     "all-reduce": 241444.0,
                                     "reduce-scatter": 18432.0},
    ("mamba2-130m", "train"): {"all-gather": 27136.0,
                               "all-reduce": 119716.0,
                               "all-to-all": 88064.0,
                               "reduce-scatter": 13568.0},
    ("mixtral-8x22b", "train"): {"all-gather": 129024.0,
                                 "all-reduce": 185156.0,
                                 "all-to-all": 83200.0,
                                 "reduce-scatter": 31744.0},
    ("chatglm3-6b", "train"): {"all-gather": 69632.0,
                               "all-reduce": 217892.0,
                               "reduce-scatter": 18432.0},
    ("smollm-360m", "decode"): {"all-gather": 42592.0, "all-reduce": 1280.0},
    ("kimi-k2-1t-a32b", "decode"): {"all-gather": 23136.0,
                                    "all-reduce": 5888.0},
}


@pytest.mark.parametrize("arch, mode", list(PINNED))
def test_per_rank_counts_on_2x4(runs, arch, mode):
    cfg = reduced(ARCHS[arch])
    counter = {"train": _train_count, "decode": _decode_count,
               "train-remat": lambda c, m=None: _train_count(c, m, True)}[mode]
    rank = _fake_mesh_count(lambda mesh: counter(cfg, mesh))
    assert rank.coll_per_op == PINNED[(arch, mode)]
    if cfg.n_experts or cfg.ssm_state:
        return      # expert buckets; the mixers' conv and scan run whole
    whole = counter(cfg)
    assert whole.flops == 8 * rank.flops
    if arch == "smollm-360m" and mode in ("train", "decode"):
        mesh_flops, meshless = runs[2][f"{mode}_flops"]
        assert whole.flops / rank.flops >= meshless / mesh_flops > 5


def test_split_decode_combines_to_the_whole_cache():
    rng = np.random.default_rng(3)
    Bq, L, H, K, D = 2, 16, 4, 2, 8
    q = torch.from_numpy(rng.standard_normal((Bq, 1, H, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((Bq, L, K, D)).astype(
        np.float32)) for _ in range(2))
    pos = 21                        # the ring has wrapped
    k_pos = ring_positions(pos, L)
    q_pos = torch.full((1,), pos, dtype=torch.int32)
    want = sdpa_naive(q, k, v, q_pos, k_pos, 9, 30.0, D ** -0.5)
    parts = [decode_partial(q, k[:, i:i + 4], v[:, i:i + 4], q_pos,
                            k_pos[i:i + 4], 9, 30.0, D ** -0.5)
             for i in range(0, L, 4)]
    got = combine_partials(*(torch.stack(t) for t in zip(*parts)),
                           torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_compute_spec_keeps_model_on_the_tensor_parallel_dims():
    class Mesh:
        shape = {"data": 2, "model": 4}

        def index(self, axis):
            return {"data": 1, "model": 2}[axis]

    m = Mesh()
    assert compute_spec(m, "units/b0/attn/wq", (2, 64, 96)) == \
        P(None, None, "model")
    assert compute_spec(m, "units/b0/attn/wo", (2, 96, 64)) == \
        P(None, "model", None)
    assert compute_spec(m, "embed/table", (256, 64)) == P("model", None)
    # the rules put 'model' on 4 stacked units: gathered whole
    assert compute_spec(m, "units/b1/mlp/w_up", (4, 64, 128)) == \
        P(None, None, None)
    assert compute_spec(m, "units/b1/mlp/w_up", (2, 64, 128)) == \
        P(None, None, "model")
    # an MoE block's stacks: their path's spec, 'model' on the experts
    # (expert-parallel) or on the hidden dim (TP-ff), as placed for the
    # dropless path, and none without a path; norms stay whole
    assert compute_spec(m, "units/b1/moe/w_up", (2, 8, 64, 32),
                        "expert") == P(None, "model", None, None)
    assert compute_spec(m, "units/b1/moe/w_up", (2, 8, 64, 32),
                        "tp_ff") == P(None, None, None, "model")
    assert compute_spec(m, "units/b1/moe/w_down", (2, 8, 32, 64),
                        "tp_ff") == P(None, None, "model", None)
    assert compute_spec(m, "units/b1/moe/w_up", (2, 8, 64, 32),
                        "dropless") == P(None, "model", "data", None)
    with pytest.raises(ValueError):
        compute_spec(m, "units/b1/moe/w_up", (2, 8, 64, 32))
    # the Mamba2 mixer: column-parallel in_proj, row-parallel out_proj
    assert compute_spec(m, "units/b0/mamba/in_proj", (2, 64, 296)) == \
        P(None, None, "model")
    assert compute_spec(m, "units/b0/mamba/out_proj", (2, 128, 64)) == \
        P(None, "model", None)
    assert compute_spec(m, "units/b0/norm/scale", (2, 64)) == P(None, None)
    assert shard_slices(m, P(("data", "model"), None), (16, 3)) == \
        (slice(12, 14), slice(0, 3))
    local = tp_local(m, {"attn": {"wq": torch.arange(64 * 96).reshape(
        64, 96)}})
    assert torch.equal(local["attn"]["wq"],
                       torch.arange(64 * 96).reshape(64, 96)[:, 48:72])
