"""Serving: batched prefill + single-token decode steps.

The same three functions as the reference's `make_serve_fns`; the
continuous-batching driver in `launch/serve.py` runs `decode_step`.

On a mesh (`make_serve_fns(..., mesh=...)`) they run what the reference's
sharded serving program runs, every rank the same functions on its
shards:

- the params are DTensors placed by `params_shardings`; the model
  gathers them over the data axes where it uses them, each unit's as the
  call reaches it, and keeps the 'model' shards it computes
  tensor-parallel with (`runtime/parallel.py`: `gather_params`,
  `gather_unit`);
- the cache is made and placed by `cache_shardings`: this rank's slots
  over the data axes (every slot when they do not divide, as for a
  single long-context slot), and its kv heads on 'model', or its part of
  the sequence when the kv heads do not divide there (the attention
  then combines partial results over 'model', `models/attention.py`);
  each SSM conv window is gathered to the rank's slots, whole width,
  and the rank's shard written back after the step; an SSM state is
  used as placed where the rules put 'model' on its heads or head dim
  (the step updates that shard), else gathered as the conv window is;
- `decode_step` takes this rank's rows of the tokens (`slot_rows`) and
  returns its rows of the next tokens, each found from the vocabulary's
  shards (the local maximum and its index, then compared across 'model');
  `gather_slots` puts the rows of every rank back together.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import use_mesh
from ..models import build_model
from ..models.attention import SeqShard
from .parallel import all_gather, gather_model, leaf_split, model_slice
from .sharding import (P, _axes_of, _map_named, batch_spec, cache_spec,
                       shard_slices, slot_rows, spec_to_placements)
from .train import mesh_apply


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    attention_impl: str = "auto"
    temperature: float = 0.0          # 0 => greedy


def make_serve_fns(cfg: ModelConfig, scfg: ServeConfig, device="cuda",
                   mesh=None):
    model = build_model(cfg, impl=scfg.attention_impl, remat=False,
                        device=device)
    # sampling draws from a generator seeded 0, as the reference samples
    # with PRNGKey(0); greedy decoding never touches it
    gen = torch.Generator(device=device).manual_seed(0)

    def pick(last):
        if scfg.temperature == 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last / scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    if mesh is not None:
        return _mesh_serve_fns(cfg, scfg, model, pick, device, mesh)

    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        """Full-sequence forward; returns the last position's logits."""
        logits, _ = model.apply(params, batch)
        return logits[:, -1]

    @torch.no_grad()
    def decode_step(params, cache, token, pos):
        logits, cache = model.decode(params, cache, token, pos)
        return pick(logits[:, -1]).to(torch.int32)[:, None], logits, cache

    def init_cache(batch_size: int, max_len: Optional[int] = None,
                   src_len: int = 1024):
        return model.init_cache(batch_size, max_len or scfg.max_len, src_len)

    return prefill, decode_step, init_cache


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             scfg: Optional[ServeConfig] = None) -> torch.Tensor:
    """Greedy generation loop: the prompt goes through decode steps too
    (simple and cache-exact), then n_tokens new ones.  prompt: (B, P)."""
    scfg = scfg if scfg is not None else ServeConfig()
    _, decode_step, init_cache = make_serve_fns(cfg, scfg, prompt.device)
    B, P = prompt.shape
    cache = init_cache(B, P + n_tokens + 1)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(P + n_tokens - 1):
        nxt, _, cache = decode_step(params, cache, tok, i)
        tok = prompt[:, i + 1:i + 2] if i + 1 < P else nxt
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)


def gather_slots(mesh, rows: torch.Tensor, slots: int) -> torch.Tensor:
    """Every slot's rows from each rank's `slot_rows` of them."""
    axes = _axes_of(batch_spec(mesh, (slots, 1))[0])
    return all_gather(rows, mesh, axes) if axes else rows


def _mesh_serve_fns(cfg: ModelConfig, scfg: ServeConfig, model, pick,
                    device, mesh):
    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        """This rank's rows of the last position's logits (its columns of
        a vocab-parallel unembedding); every row's, where the data axes
        do not divide the rows, from the rank holding the last position
        when they split the sequence."""
        def last(p, b):
            logits = model.apply(p, b)[0][:, -1]
            split = leaf_split("embeds" if "embeds" in b else "tokens")
            if split is None or not split.axes:
                return logits
            return all_gather(logits[None], mesh, split.axes)[-1]

        return mesh_apply(last, mesh)(params, batch)

    @torch.no_grad()
    def decode_step(params, cache, token, pos):
        """token: this rank's rows (`slot_rows`).  Returns its rows of the
        next tokens, its rows (and vocabulary columns) of the logits, and
        the cache, updated in place."""
        with use_mesh(mesh):
            views, commit = cache_views(mesh, cache)
            logits, _ = model.decode(params, views, token, pos)
            commit()
            last = logits[:, -1]
            cols = model_slice("unembed", last.shape, cfg.vocab_size)
            if cols is None:
                nxt = pick(last)
            elif scfg.temperature != 0.0:
                nxt = pick(gather_model(last, -1))
            else:
                idx = torch.argmax(last, dim=-1)
                val = last.gather(-1, idx[:, None])[:, 0]
                vals = all_gather(val[None], mesh, ("model",))
                idxs = all_gather((idx + cols.start)[None], mesh, ("model",))
                # the first shard's on a tie: the lowest index, as argmax
                nxt = idxs.gather(0, vals.argmax(dim=0)[None])[0]
        return nxt.to(torch.int32)[:, None], logits, cache

    def init_cache(batch_size: int, max_len: Optional[int] = None,
                   src_len: int = 1024):
        """The cache placed by `cache_shardings`: DTensors whose shards
        each rank allocates alone."""
        from torch.distributed.tensor import DTensor
        shapes = build_model(cfg, remat=False, device="meta").init_cache(
            batch_size, max_len or scfg.max_len, src_len)

        def place(_, t):
            spec = cache_spec(mesh, tuple(t.shape))
            local = torch.zeros(
                [s.stop - s.start for s in shard_slices(mesh, spec,
                                                        tuple(t.shape))],
                dtype=t.dtype, device=device)
            return DTensor.from_local(
                local, mesh.device_mesh, spec_to_placements(mesh, spec),
                run_check=False, shape=t.shape, stride=t.stride())

        return _map_named(place, shapes)

    return prefill, decode_step, init_cache


def cache_views(mesh, cache):
    """(views, commit): the cache's leaves (DTensors) as the decode step
    computes with them, and a function that writes the SSM leaves' new
    values back into this rank's shards.

    A KV leaf (units..., B, L, K, hd) is used as it is placed (the rank's
    slots, and its kv heads or its slots of the ring); a ring split over
    mesh axes puts a `SeqShard` beside it.  An SSM leaf, conv window
    (units..., B, K-1, C) or state (units..., B, H, P, N), is gathered
    over every axis the rules put on it bar its slots' own, then cut to
    the rank's slots; `commit` puts the slots back together and copies
    the rank's shard of them in.  A state whose heads or head dim the
    rules put on 'model' keeps that shard: the Mamba2 step updates it
    alone (`models/ssm.py: decode_mamba`)."""
    later = []

    def leaf(name, t):
        spec = cache_spec(mesh, tuple(t.shape))
        local = t.to_local()
        key = name.split("/")[-1]
        bdim = t.ndim - (3 if key == "conv" else 4)
        rows = _axes_of(batch_spec(mesh, (t.shape[bdim], 1))[0])
        if key in ("k", "v"):
            if any(spec[:bdim]) or _axes_of(spec[bdim]) != rows or \
                    spec[bdim + 2] not in (None, "model"):
                raise ValueError(f"cache leaf {name} placed {spec}: not a "
                                 f"layout the decode step computes on")
            return local
        view, kept = local, set()
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if (d == bdim and _axes_of(entry) == rows) or (
                    key == "state" and entry == "model"
                    and d in (bdim + 1, bdim + 2)):
                kept.add(d)     # the rank's slots, its heads or head dim
                continue
            view = all_gather(view, mesh, _axes_of(entry), d)
        cut = bool(rows) and _axes_of(spec[bdim]) != rows
        if cut:
            view = view[(slice(None),) * bdim + shard_slices(
                mesh, P(rows), (t.shape[bdim],))]
        if view is not local:
            later.append((local, view, spec, bdim, cut, rows, kept,
                          tuple(t.shape)))
        return view

    views = _map_named(leaf, cache)
    _mark_split_rings(mesh, cache, views)

    def commit():
        for local, view, spec, bdim, cut, rows, kept, shape in later:
            if cut:
                view = all_gather(view, mesh, rows, bdim)
            sl = list(shard_slices(mesh, spec, shape))
            for d in kept:
                sl[d] = slice(None)         # already the rank's part
            local.copy_(view[tuple(sl)])

    return views, commit


def _mark_split_rings(mesh, cache, views):
    """A `SeqShard` beside each KV cache whose ring the rules split."""
    for key, sub in cache.items():
        if not isinstance(sub, dict):
            continue
        if "k" in sub and not isinstance(sub["k"], dict):
            t = sub["k"]
            spec = cache_spec(mesh, tuple(t.shape))
            ldim = t.ndim - 3
            if spec[ldim] is not None:
                views[key]["seq"] = SeqShard(
                    t.shape[ldim],
                    shard_slices(mesh, spec, tuple(t.shape))[ldim].start,
                    _axes_of(spec[ldim]))
        else:
            _mark_split_rings(mesh, sub, views[key])
