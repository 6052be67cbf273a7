"""Step functions over the unified model API (port of the serving half of
``repro/launch/steps.py``): the prefill and decode steps that serve the
recurrent families, which ``ExpertServer`` does not, as the reference
serves them.

    prefill_step = make_prefill_step(cfg, max_len)
    logits, cache = prefill_step(params, tokens)        # tokens (B, T)
    decode_step = make_decode_step(cfg)
    logits, cache = decode_step(params, cache, token)   # token (B,)

On CUDA the decode step is a CUDA graph, as the reference jits it.  The
step keeps a cache of its own for each cache shape: its first call clones
the cache it is given into it, captures the step on it with a static
token buffer, and replays.  A later call copies the cache it is given into
that one, unless it is that one (the cache the step returned), and
replays.  So one capture serves every prompt of a batch shape, and a new
prompt costs one copy of its cache; the caller goes on from the cache the
step returns.  On the CPU the step is the model's, which updates the cache
in place.  The prefill step runs eagerly: its cache is an output, made
anew by each call.  The reference wraps each call in a ``MeshPolicy``; the
port has no mesh yet (ROADMAP queue A, item 3), so it takes none.  The
training step and the spec functions wait for training and the mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.graphs import StepGraph
from repro_torch.models import model as model_lib


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
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch, max_len)
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
