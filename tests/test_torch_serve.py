"""The port's serving path against the JAX package, on reduced smollm-360m,
mamba2-130m, mixtral-8x22b and seamless-m4t-large-v2 with bf16 params
(the JAX decode path needs them).

Greedy tokens must equal the reference's wherever the reference's top-2
logit gap exceeds MARGIN = 0.3: logits that agree within 0.15 (the bf16
decode tolerance of `tests/test_models.py`) cannot swap two candidates
more than 2 x 0.15 apart.  At every step, fed the reference's tokens, the
port's logits must agree within 0.15.  On mamba2 the loop carries each
slot's recurrent state through all ~25 steps, and the state drifts by
O(ulp) a step between the two frameworks' roundings (the reference's
own reasoning for its SSM decode tolerances, `tests/test_models.py`), so
there the tolerance is 0.3 and the margin 0.6.  On mixtral a row whose
experts differ between the two packages at a step (a route flipped by
rounding, `test_torch_model.py`) is left out of that step's logit
comparison, and its request's tokens are compared up to that step.

The continuous-batching loops run as the launchers run them: the
reference's under `use_mesh(make_host_mesh())` and the default
ParallelContext (`repro/launch/serve.py:40-44`), the port's `serve_loop`
under its own, on the host mesh (1, 1) of a 1-rank gloo group.  So
mixtral takes the expert-parallel path on both sides, and its capacity
buckets drop rows (at decode with 4 slots each expert's bucket holds
one row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.mesh import use_mesh as jax_use_mesh
from repro.runtime.parallel import ParallelContext as JaxContext
from repro.runtime.parallel import parallel_context as jax_context
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import generate as jax_generate
from repro.runtime.serve import make_serve_fns as jax_make_serve_fns
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.launch.serve import make_requests, serve_loop
from repro_torch.runtime.parallel import ParallelContext, parallel_context
from repro_torch.runtime.serve import ServeConfig, generate, make_serve_fns

from _torch_dist import local_group

from _torch_parity import (both_params, configs, numpy_params,
                           recorded_routes, route_flips)

TOL, MARGIN = 0.15, 0.3
SSM_TOL = 0.3
_STATE = {}


def _setup(arch="smollm-360m"):
    if arch not in _STATE:
        jcfg, tcfg = configs(arch)
        jparams, tparams = both_params(numpy_params(jcfg, seed=3),
                                       "bfloat16")
        _STATE[arch] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                            tparams=tparams)
    return _STATE[arch]


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _check_teacher_forced(port_dec, tparams, tcache, feeds, jlogits,
                          tol=TOL, jroutes=None):
    """Feed the port the reference's inputs step by step; compare logits
    (within `tol`) and argmax where the reference's margin exceeds
    2 x tol, on every row whose routes agree with `jroutes` (the
    reference's, one list of per-layer (rows, K) arrays a step; None for
    a model without MoE).  Returns the (steps, rows) flip mask."""
    flips = np.zeros((len(feeds), len(feeds[0])), bool)
    for t, (feed, want) in enumerate(zip(feeds, jlogits)):
        with recorded_routes() as (_, troutes):
            nxt, got, tcache = port_dec(tparams, tcache, torch.tensor(feed),
                                        t)
        if jroutes is not None:
            flips[t] = route_flips(jroutes[t], troutes, (len(feed),))
        keep = ~flips[t]
        got = got[:, -1].numpy()[keep]
        want = want[:, -1][keep]
        np.testing.assert_allclose(got, want, atol=tol)
        sure = _margin(want) > 2 * tol
        np.testing.assert_array_equal(nxt[:, 0].numpy()[keep][sure],
                                      np.argmax(want, -1)[sure])
    assert flips.mean() <= 0.1, int(flips.sum())
    return flips


def _prefix_equal(got, want, margins, margin=MARGIN, flipped=None):
    """Equal up to (and including) the first low-margin choice, or up to
    the first choice made on a flipped route (`flipped`, one bool a
    token)."""
    flipped = flipped if flipped is not None else [False] * len(want)
    for g, w, m, f in zip(got, want, margins, flipped):
        if f:
            return
        if g != w:
            assert m <= margin, (got, want, margins)
            return
        if m <= margin:
            return


def _check_generate(arch, tol=TOL):
    st = _setup(arch)
    prompt = np.random.default_rng(4).integers(
        1, st["jcfg"].vocab_size, (2, 4)).astype(np.int32)
    n_new = 8
    want = np.asarray(jax_generate(st["jparams"], st["jcfg"],
                                   jnp.asarray(prompt), n_new))
    # the reference's per-step logits, fed its own tokens
    _, jdec, jinit = jax_make_serve_fns(st["jcfg"], JaxServeConfig())
    jdec = jax.jit(jdec)
    jcache = jinit(2, 4 + n_new + 1)
    feeds, jlogits = [], []
    for i in range(4 + n_new - 1):
        feeds.append(want[:, i:i + 1])
        _, lg, jcache = jdec(st["jparams"], jcache, jnp.asarray(feeds[-1]),
                             jnp.int32(i))
        jlogits.append(np.asarray(lg))
    _, tdec, tinit = make_serve_fns(st["tcfg"], ServeConfig(), "cpu")
    _check_teacher_forced(tdec, st["tparams"], tinit(2, 4 + n_new + 1),
                          feeds, jlogits, tol)

    got = generate(st["tparams"], st["tcfg"], torch.from_numpy(prompt),
                   n_new).numpy()
    assert got.shape == want.shape == (2, 4 + n_new)
    np.testing.assert_array_equal(got[:, :4], prompt)
    margins = np.stack([_margin(lg[:, -1]) for lg in jlogits], 1)
    for b in range(2):       # token i+1 is chosen at step i
        _prefix_equal(got[b, 4:], want[b, 4:], margins[b, 3:], 2 * tol)


def test_generate_matches_jax():
    _check_generate("smollm-360m")


def test_generate_matches_jax_on_mamba2():
    _check_generate("mamba2-130m", SSM_TOL)


def _jax_serve_loop(jparams, jcfg, queue, slots, max_new, max_len):
    """The scheduler of `repro/launch/serve.py` (lines 50-91) on given
    params, under the launcher's mesh and context (lines 40-44),
    recording each step's feed, logits and MoE routes, and for each
    chosen token its request, margin, step and slot."""
    with jax_use_mesh(jax_host_mesh()), jax_context(JaxContext()):
        return _jax_loop_body(jparams, jcfg, queue, slots, max_new, max_len)


def _jax_loop_body(jparams, jcfg, queue, slots, max_new, max_len):
    _, decode_step, init_cache = jax_make_serve_fns(
        jcfg, JaxServeConfig(max_len=max_len))
    dec = jax.jit(decode_step)
    cache = init_cache(slots, max_len)
    active = [None] * slots
    results, feeds, logits, chosen, routes = {}, [], [], [], []
    served = pos = 0
    with recorded_routes() as (jlog, _):
        while (queue or any(active)) and pos < max_len - 1:
            for s in range(slots):
                if active[s] is None and queue:
                    active[s] = [served, queue.pop(0), []]
                    served += 1
            feed = np.zeros((slots, 1), np.int32)
            for s, a in enumerate(active):
                if a is None:
                    continue
                _, prompt, out = a
                feed[s, 0] = prompt.pop(0) if prompt else out[-1]
            n_before = len(jlog)
            nxt, lg, cache = dec(jparams, cache, jnp.asarray(feed),
                                 jnp.int32(pos))
            jax.effects_barrier()
            routes.append(jlog[n_before:])
            nxt = np.asarray(nxt)
            feeds.append(feed)
            logits.append(np.asarray(lg))
            for s, a in enumerate(active):
                if a is None:
                    continue
                rid, prompt, out = a
                if not prompt:
                    out.append(int(nxt[s, 0]))
                    chosen.append((rid, float(_margin(logits[-1][s, -1])), pos,
                                   s))
                    if len(out) >= max_new:
                        results[rid] = out
                        active[s] = None
            pos += 1
    return results, feeds, logits, chosen, routes


def _check_loop(arch, tol=TOL):
    st = _setup(arch)
    slots, max_new, max_len = 4, 8, 96
    queue = make_requests(8, st["jcfg"].vocab_size)
    want, feeds, jlogits, chosen, jroutes = _jax_serve_loop(
        st["jparams"], st["jcfg"], [list(p) for p in queue], slots, max_new,
        max_len)
    _, tdec, tinit = make_serve_fns(st["tcfg"], ServeConfig(max_len), "cpu")
    with local_group():
        mesh = make_host_mesh("cpu")
        with use_mesh(mesh), parallel_context(ParallelContext()):
            flips = _check_teacher_forced(
                tdec, st["tparams"], tinit(slots, max_len), feeds, jlogits,
                tol, jroutes if st["jcfg"].n_experts else None)
        got, stats = serve_loop(st["tparams"], st["tcfg"],
                                ServeConfig(max_len=max_len), queue, slots,
                                max_new, "cpu", mesh)
    assert sorted(got) == sorted(want) == list(range(8))
    assert stats["served"] == 8 and stats["steps"] == len(feeds)
    for rid in want:
        mine = [c for c in chosen if c[0] == rid]
        _prefix_equal(got[rid], want[rid], [m for _, m, _, _ in mine],
                      2 * tol, [flips[t, s] for _, _, t, s in mine])


def test_continuous_batching_loop_matches_jax():
    _check_loop("smollm-360m")


def test_continuous_batching_loop_matches_jax_on_mamba2():
    """As above on the SSM: a request admitted into a freed slot inherits
    the previous request's conv window and state, in both loops."""
    _check_loop("mamba2-130m", SSM_TOL)


def test_continuous_batching_loop_matches_jax_on_mixtral():
    """The MoE decode: each step routes the slots' tokens (top 2 of 8)."""
    _check_loop("mixtral-8x22b")


def test_mixtral_decode_step_under_the_launchers_context_matches_jax():
    """One decode step of 4 slots (the launcher's first: each slot's
    first prompt token) on reduced mixtral, bf16 weights from seed 0,
    under the launchers' mesh and context in both packages.  Each
    expert's bucket holds one row here (cap_e = int(1 x 1.25)), so the
    reference's tokens are not the dropless path's; the port's must be
    the reference's."""
    jcfg, tcfg = configs("mixtral-8x22b")
    jparams, tparams = both_params(numpy_params(jcfg, seed=0), "bfloat16")
    feed = np.array([[p[0]] for p in make_requests(4, jcfg.vocab_size)],
                    np.int32)
    scfg = JaxServeConfig(max_len=8)
    _, jdec, jinit = jax_make_serve_fns(jcfg, scfg)
    dropless = np.asarray(jax.jit(jdec)(jparams, jinit(4, 8),
                                        jnp.asarray(feed), 0)[1])
    with jax_use_mesh(jax_host_mesh()), jax_context(JaxContext()):
        with recorded_routes() as (jroutes, _):
            _, want, _ = jax.jit(jdec)(jparams, jinit(4, 8),
                                       jnp.asarray(feed), jnp.int32(0))
            jax.effects_barrier()
    want = np.asarray(want)
    _, tdec, tinit = make_serve_fns(tcfg, ServeConfig(max_len=8), "cpu")
    with local_group():
        with use_mesh(make_host_mesh("cpu")), \
                parallel_context(ParallelContext()):
            _check_teacher_forced(tdec, tparams, tinit(4, 8), [feed],
                                  [want], TOL, [jroutes])
    # the drops move this step's logits far past the tolerance
    assert np.abs(dropless - want).max() > 10 * TOL


def test_continuous_batching_loop_matches_jax_on_seamless():
    """The encoder-decoder decodes against the cross cache that
    `init_cache` leaves (zeros, no source encoded), in both loops."""
    _check_loop("seamless-m4t-large-v2")


def test_profile_prefill_on_cpu_reports_operators_and_no_device_numbers():
    from repro_torch.launch.profile import _busy_us, profile_prefill
    res = profile_prefill("smollm-360m", batch=1, seq=16, calls=2,
                          device="cpu", use_reduced=True)
    assert res["device"] == "cpu" and res["host_ms_per_prefill"] > 0
    assert res["kernels_us"] and all(v >= 0 for v in res["kernels_us"].values())
    assert "device_idle_share" not in res
    assert _busy_us([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7
