"""Step functions over the unified model API (port of
``repro/launch/steps.py``): the training step of the dense and MoE
families, and the prefill and decode steps that serve the recurrent
families, which ``ExpertServer`` does not, as the reference serves them.

    train_step = make_train_step(cfg, opt)
    state, metrics = train_step(state, batch)           # state: train_state
    prefill_step = make_prefill_step(cfg, max_len)
    logits, cache = prefill_step(params, tokens)        # tokens (B, T)
    decode_step = make_decode_step(cfg)
    logits, cache = decode_step(params, cache, token)   # token (B,)

On CUDA every step is a CUDA graph, as the reference jits them.  The
training step's first call runs eagerly on a side stream (the warm-up a
backward needs before capture) and captures the step on a static copy of
its batch; every later call copies the batch in and replays.  One step is
``model.lm_loss``'s gradient and the optimizer's update, in place on the
parameters, the optimizer's state and its device step; with
``cfg.microbatches = M > 1`` the batch is (M, B/M, S) and the step loops
over the M slices inside the graph, summing their gradients in
``cfg.grad_accum_dtype`` before dividing by M, and averages their
metrics.  A replayed step is bit-equal to the same step run eagerly
(``graphs=False``).

The prefill step captures ``model.prefill`` once per (params, token
shape) over a static token buffer: its first call for a shape runs the
prefill eagerly (which makes what a capture cannot: loaded libraries,
lazily made constants) and captures it, and every later call copies the
prompt in and replays.  It returns copies of the graph's logits and
cache, so no replay overwrites a cache a caller holds, and its captures
share one memory pool (each replay's outputs are copied before the next
replay).  A recurrent prompt cannot be padded to a bucket without
changing its state, so each new length costs a capture; the step holds
the ``MAX_PREFILL_GRAPHS`` shapes used last and drops the least recently
used beyond them.  The decode step keeps a cache of its own for each cache
shape: its first call clones the cache it is given into it, captures the
step on it with a static token buffer, and replays.  A later call copies
the cache it is given into that one, unless it is that one (the cache the
step returned), and replays.  So one capture serves every prompt of a
batch shape, and a new prompt costs one copy of its cache; the caller
goes on from the cache the step returns.  On the CPU the steps are the
model's (the decode updates the cache in place).

The reference wraps each step in a ``MeshPolicy``.  The port's process
group and meshes exist (``launch/mesh.py``), but the LM's sharding rules
and the ``MeshPolicy`` wrapping belong to the LM model mesh, ROADMAP queue
A item 5, so the steps take no policy yet.  The spec functions
(``param_specs`` through ``make_step``) are tooling, item 6.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.graphs import StepGraph, capture
from repro_torch.models import io as model_io, model as model_lib

# prompt shapes whose prefill graphs a prefill step holds
MAX_PREFILL_GRAPHS = 8


def train_state(cfg, params, opt_factory) -> dict:
    """``{"params": the model, "opt": the optimizer (``opt_factory``, as
    ``train.optimizer.make_optimizer`` returns it) over the model's
    reference leaves (``models.io.reference_groups``), "step": the
    optimizer's int32 device step}``; the parameters are set to take
    gradients."""
    for p in params.parameters():
        p.requires_grad_(True)
    opt = opt_factory(model_io.reference_groups(params, cfg))
    return {"params": params, "opt": opt, "step": opt.step}


def _grads(loss, params) -> list:
    out = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, out)]


def make_train_step(cfg, *, graphs: bool = True) -> Callable:
    """The training step (module docstring): ``train_step(state, batch)``
    with ``state`` from ``train_state`` (whose optimizer it uses) and
    ``batch["tokens"]`` (B, S), or (M, B/M, S) with ``cfg.microbatches = M
    > 1``; returns (the same state, updated in place, and the metrics
    ``loss``, ``aux_loss``, ``perplexity``, ``grad_norm`` and ``lr`` as
    device scalars that a later step does not overwrite).  Its ``graphs``
    maps (optimizer, batch shape) to (state, batch buffer, ``StepGraph``)
    for each capture."""
    M = max(1, cfg.microbatches)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def grad_one(params, opt, tokens):
        with torch.enable_grad():
            total, metrics = model_lib.lm_loss(params, cfg,
                                               {"tokens": tokens})
            grads = _grads(total, opt.tensors())
        return grads, {k: v.detach() for k, v in metrics.items()}

    def body(state, tokens):
        params, opt = state["params"], state["opt"]
        if M == 1:
            grads, metrics = grad_one(params, opt, tokens)
        else:
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                   for p in opt.tensors()]
            ms = []
            for i in range(M):
                g, m = grad_one(params, opt, tokens[i])
                for a, x in zip(acc, g):
                    a.add_(x.to(acc_dtype))
                del g
                ms.append(m)
            grads = [a.div_(M) for a in acc]
            del acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        stats = opt.update(grads)
        del grads
        opt.step.add_(1)
        return {**metrics, **stats}

    held = {}

    def train_step(state, batch):
        tokens = batch["tokens"]
        if not (graphs and tokens.is_cuda):
            return state, body(state, tokens)
        key = (id(state["opt"]), tuple(tokens.shape))
        if key not in held:
            buf = tokens.clone()
            fn = lambda: body(state, buf)
            graph, metrics = capture(fn)
            held[key] = (state, buf, graph)
            return state, metrics
        _, buf, graph = held[key]
        buf.copy_(tokens)
        out = graph.replay()
        return state, {k: v.clone() for k, v in out.items()}

    train_step.graphs = held
    return train_step


def clone_cache(cache):
    """A copy of a cache (dicts and lists of tensors)."""
    if isinstance(cache, dict):
        return {k: clone_cache(x) for k, x in cache.items()}
    if isinstance(cache, list):
        return [clone_cache(x) for x in cache]
    return cache.clone()


def copy_cache_(dst, src) -> None:
    """``src`` into ``dst``, a cache of the same shapes, in place."""
    if isinstance(dst, dict):
        for k in dst:
            copy_cache_(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            copy_cache_(a, b)
    else:
        dst.copy_(src)


def _shapes(cache):
    if isinstance(cache, dict):
        return tuple((k, _shapes(x)) for k, x in cache.items())
    if isinstance(cache, list):
        return tuple(_shapes(x) for x in cache)
    return tuple(cache.shape), cache.dtype, cache.device


def make_prefill_step(cfg, max_len: int) -> Callable:
    """The prefill step; its ``graphs`` maps each of the last
    ``MAX_PREFILL_GRAPHS`` token shapes seen on CUDA, least recently used
    first, to (params, token buffer, ``StepGraph``)."""
    held = {}
    pool = []

    def prefill_step(params, batch):
        if batch.device.type != "cuda":
            return model_lib.prefill(params, cfg, batch, max_len)
        key = (tuple(batch.shape), batch.dtype, batch.device)
        entry = held.pop(key, None)
        if entry is None or entry[0] is not params:
            out = model_lib.prefill(params, cfg, batch, max_len)
            if not pool:
                pool.append(torch.cuda.graph_pool_handle())
            buf = batch.clone()
            graph = StepGraph(lambda: model_lib.prefill(params, cfg, buf,
                                                        max_len), pool=pool[0])
            held[key] = (params, buf, graph)
            while len(held) > MAX_PREFILL_GRAPHS:
                del held[next(iter(held))]
            return out
        held[key] = entry                               # now the most recent
        _, buf, graph = entry
        buf.copy_(batch)
        logits, cache = graph.replay()
        # copies: the graph's outputs are overwritten by its next replay
        return logits.clone(), clone_cache(cache)

    prefill_step.graphs = held
    return prefill_step


def make_decode_step(cfg) -> Callable:
    """The decode step; its ``graphs`` maps each cache shape seen on CUDA
    to (params, the step's cache, token buffer, ``StepGraph``)."""
    held = {}

    def decode_step(params, cache, token):
        if token.device.type != "cuda":
            return model_lib.decode_step(params, cfg, cache, token)
        key = (_shapes(cache), tuple(token.shape))
        entry = held.get(key)
        if entry is None or entry[0] is not params:
            own, buf = clone_cache(cache), torch.empty_like(token)
            graph = StepGraph(lambda: model_lib.decode_step(
                params, cfg, own, buf)[0])
            entry = held[key] = (params, own, buf, graph)
        elif cache is not entry[1]:
            copy_cache_(entry[1], cache)
        _, own, buf, graph = entry
        buf.copy_(token)
        # a copy: the graph's output is overwritten by its next replay
        return graph.replay().clone(), own

    decode_step.graphs = held
    return decode_step
