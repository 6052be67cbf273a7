"""Step functions over the unified model API (port of the serving half of
``repro/launch/steps.py``): the prefill and decode steps that serve the
recurrent families, which ``ExpertServer`` does not, as the reference
serves them.

    prefill_step = make_prefill_step(cfg, max_len)
    logits, cache = prefill_step(params, tokens)        # tokens (B, T)
    decode_step = make_decode_step(cfg)
    logits, cache = decode_step(params, cache, token)   # token (B,)

On CUDA both steps are CUDA graphs, as the reference jits them.  The
prefill step captures ``model.prefill`` once per (params, token shape)
over a static token buffer: its first call for a shape runs the prefill
eagerly (which makes what a capture cannot: loaded libraries, lazily made
constants) and captures it, and every later call copies the prompt in and
replays.  It returns copies of the graph's logits and cache, so no replay
overwrites a cache a caller holds, and its captures share one memory pool
(each replay's outputs are copied before the next replay).  A recurrent
prompt cannot be padded to a bucket without changing its state, so each
new length costs a capture; the step holds the ``MAX_PREFILL_GRAPHS``
shapes used last and drops the least recently used beyond them.  The
decode step keeps a cache of its own for each cache shape: its first call
clones the cache it is given into it, captures the step on it with a
static token buffer, and replays.  A later call copies the cache it is
given into that one, unless it is that one (the cache the step returned),
and replays.  So one capture serves every prompt of a batch shape, and a
new prompt costs one copy of its cache; the caller goes on from the cache
the step returns.  On the CPU the steps are the model's (the decode
updates the cache in place).  The reference wraps each call in a
``MeshPolicy``; the port has no mesh yet (ROADMAP queue A, item 3), so it
takes none.  The training step and the spec functions wait for training
and the mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.graphs import StepGraph
from repro_torch.models import model as model_lib

# prompt shapes whose prefill graphs a prefill step holds
MAX_PREFILL_GRAPHS = 8


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
