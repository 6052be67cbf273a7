"""Step functions over the unified model API (port of
``repro/launch/steps.py``): the training step of every family, and the
prefill and decode steps that serve the recurrent and enc-dec families,
which ``ExpertServer`` does not, as the reference serves them.

    train_step = make_train_step(cfg, opt)
    state, metrics = train_step(state, batch)           # state: train_state
    prefill_step = make_prefill_step(cfg, max_len)
    logits, cache = prefill_step(params, tokens)        # tokens (B, T)
    cache = prefill_step(params, {"frames": frames})    # enc-dec
    decode_step = make_decode_step(cfg)
    logits, cache = decode_step(params, cache, token)   # token (B,)

A training batch is ``{"tokens"}``, and enc-dec's ``{"frames",
"tokens"}``, as the reference's ``lm_loss`` reads them.

On CUDA every step is a CUDA graph, as the reference jits them.  The
training step's first call runs eagerly on a side stream (the warm-up a
backward needs before capture) and captures the step on a static copy of
its batch; every later call copies the batch in and replays.  One step is
``model.lm_loss``'s gradient and the optimizer's update, in place on the
parameters, the optimizer's state and its device step; with
``cfg.microbatches = M > 1`` each of the batch's tensors has M slices on
its leading dim ((M, B/M, S) tokens, (M, B/M, S_enc, d) frames) and the
step loops over the M slices inside the graph, summing their gradients in
``cfg.grad_accum_dtype`` before dividing by M, and averages their
metrics.  A replayed step is bit-equal to the same step run eagerly
(``graphs=False``).

The prefill step captures ``model.prefill`` once per (params, prompt
shape) over a static buffer of the prompt (tokens, or enc-dec's frames):
its first call for a shape runs the prefill eagerly (which makes what a
capture cannot: loaded libraries, lazily made constants) and captures
it, and every later call copies the prompt in and replays.  It returns
copies of the graph's outputs (logits and cache, or enc-dec's cache
alone), so no replay overwrites a cache a caller holds, and its captures
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

Each step takes an optional ``MeshPolicy`` (``distributed/api.py``) and
runs under ``use_mesh_policy(policy)``, as the reference's do.  Under one,
``params`` is a ``models.io.ShardedLM`` (or a whole model) and the batch,
tokens and caches are this rank's rows by ``sharding.batch_axes`` (with
``M > 1`` microbatches, dim 1 of (M, B/M, S), as
``data.pipeline.SyntheticLM(mesh=)`` gives them).  The layers compute
Megatron-style on the rank's blocks (``models/transformer.py``): the
heads, ff and vocab over ``model``, each ending in an all-reduce over
``model``, an MoE layer expert-parallel (``models/moe.py``), and in
training every block split over the data axes gathered at its use and
freed after (``ShardedLM.regathered``), its gradient reduce-scattered to
the block in the backward.  The training step then sums the gradients of
the blocks the data axes do not split over them
(``ShardedLM.sum_replicated_grads``) and the optimizer updates the blocks
(``train_state`` builds it with the ``ShardedLM`` as its layout); the
microbatches' accumulators take the blocks' shapes.  The loss keeps the
global normaliser (``model.lm_loss``).  The recurrent families (RWKV6,
RecurrentGemma) are trained and served so too: RWKV6's time mix on the
rank's heads and RecurrentGemma's recurrent blocks on its channels
(``models/rwkv6.py``, ``models/rglru.py``).

The serving caches follow ``sharding.serve_cache_spec`` (the reference's
``cache_spec`` splits every K/V by sequence; the port splits by head
where it can, so that a step reshards nothing): a rank holds its rows
and, over ``model``,

  * K/V: the rank's ``KV/m`` heads where the KV heads divide ``model``
    (its ``wk``/``wv`` blocks give them); else its ``S/m`` slots of the
    sequence where the length divides (granite-34b's one KV head,
    RecurrentGemma's ring of 2,048), whose decode writes the token's K/V
    on the owning rank, gathers the query heads over ``model`` (reader
    ``"kv_query"``), runs the decode-attention kernel over the rank's
    slots with its log-sum-exp and merges the ranks' partial softmaxes
    (``collectives.softmax_merge``, reader ``"kv_merge"``); else whole;
    ``kv_pos`` whole;
  * RWKV6's ``S``: the rank's ``H/m`` heads; ``tm_prev``, ``cm_prev``
    whole;
  * RecurrentGemma's ``h`` and ``conv``: the rank's ``rnn/m`` channels.

Prefill and decode return whole logits, the vocab slices gathered over
``model`` (one all-gather, reader ``"lm_logits"``), as the reference's
steps return global arrays.  Every collective runs inside the step's
CUDA graph.

The spec functions (``param_specs`` through ``make_step``, the
reference's ``ShapeDtypeStruct`` builders) give one rank's inputs of a
(architecture x shape) cell on a mesh as meta tensors, which allocate
nothing: each is the rank's block (its shape cut by
``sharding.block_spec``, ``data_spec`` or ``serve_cache_spec``) and
carries its ``spec`` and the whole ``global_shape`` as attributes, as a
``models.io.ShardedLM`` carries ``specs`` and ``shapes`` for its leaves.
``param_specs`` is such a ``ShardedLM`` over the model built on the meta
device; ``state_specs`` the training state over it, with the optimizer
built on its meta blocks in its real layout (Adafactor's factored moments
by ``param_spec`` of their own shape, which drops to no split where a
factored moment loses the dim a rule names, as the reference recomputes
its spec).  Batches follow the reference's shapes: (B, S) tokens, or (M,
B/M, S) with ``cfg.microbatches = M > 1``, enc-dec's ``frames`` beside
them, each the rank's rows.  ``make_step`` returns the step and its
arguments; run on meta tensors (``launch/dryrun.py``) it computes
nothing.  A mesh here may be a stand-in with a ``.shape`` dict alone
(the specs are then rank 0's), but a step runs only on a ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.configs import SHAPES
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import MeshPolicy, use_mesh_policy
from repro_torch.graphs import StepGraph, capture
from repro_torch.models import io as model_io, model as model_lib
from repro_torch.train import optimizer as opt_lib

# prompt shapes whose prefill graphs a prefill step holds
MAX_PREFILL_GRAPHS = 8


def train_state(cfg, params, opt_factory) -> dict:
    """``{"params": the model, "opt": the optimizer (``opt_factory``, as
    ``train.optimizer.make_optimizer`` returns it) over the model's
    reference leaves (``models.io.reference_groups``), "step": the
    optimizer's int32 device step}``; the parameters are set to take
    gradients.  ``params`` may be a ``models.io.ShardedLM``: the optimizer
    then updates its blocks, with it as the layout."""
    if isinstance(params, model_io.ShardedLM):
        for p in params.compute_tensors():
            p.requires_grad_(True)
        opt = opt_factory(params.leaves, params)
        return {"params": params, "opt": opt, "step": opt.step}
    for p in params.parameters():
        p.requires_grad_(True)
    opt = opt_factory(model_io.reference_groups(params, cfg))
    return {"params": params, "opt": opt, "step": opt.step}


def _model(params):
    """The module a step computes with (a ``ShardedLM``'s holds its
    blocks)."""
    return params.model if isinstance(params, model_io.ShardedLM) else params


def _whole_logits(logits, cfg, policy):
    """Logits whole over the vocab: a rank's vocab slices gathered over
    ``model``."""
    if policy is None or logits.shape[-1] == cfg.vocab_padded:
        return logits
    return collectives.gather_cat(logits, policy.mesh.get_group("model"),
                                  dim=logits.dim() - 1, reader="lm_logits")


def _grads(loss, params) -> list:
    out = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, out)]


def make_train_step(cfg, policy=None, *, graphs: bool = True) -> Callable:
    """The training step (module docstring): ``train_step(state, batch)``
    with ``state`` from ``train_state`` (whose optimizer it uses) and
    ``batch["tokens"]`` (B, S), or (M, B/M, S) with ``cfg.microbatches = M
    > 1`` (enc-dec's ``batch["frames"]`` likewise, (B, S_enc, d) or (M,
    B/M, S_enc, d)); returns (the same state, updated in place, and the
    metrics ``loss``, ``aux_loss``, ``perplexity``, ``grad_norm`` and
    ``lr`` as device scalars that a later step does not overwrite).  Under
    ``policy`` the state's params are a ``ShardedLM`` and the batch this
    rank's rows.  Its ``graphs`` maps (optimizer, batch shapes) to (state,
    batch buffers, ``StepGraph``) for each capture."""
    M = max(1, cfg.microbatches)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def grad_one(params, wrt, batch):
        sharded = isinstance(params, model_io.ShardedLM)
        with torch.enable_grad(), (params.regathered() if sharded
                                   else contextlib.nullcontext()):
            total, metrics = model_lib.lm_loss(_model(params), cfg, batch)
            grads = _grads(total, wrt)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def body(state, batch):
        with use_mesh_policy(policy):
            return _body(state, batch)

    def _body(state, batch):
        params, opt = state["params"], state["opt"]
        sharded = isinstance(params, model_io.ShardedLM)
        if sharded != (policy is not None):
            raise ValueError("a training step under a mesh policy takes a "
                             "ShardedLM's state, and only then")
        wrt = params.compute_tensors() if sharded else opt.tensors()
        if M == 1:
            grads, metrics = grad_one(params, wrt, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                   for p in wrt]
            ms = []
            for i in range(M):
                g, m = grad_one(params, wrt,
                                {k: x[i] for k, x in batch.items()})
                for a, x in zip(acc, g):
                    a.add_(x.to(acc_dtype))
                del g
                ms.append(m)
            grads = [a.div_(M) for a in acc]
            del acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        if sharded:
            grads = params.sum_replicated_grads(grads)
        stats = opt.update(grads)
        del grads
        opt.step.add_(1)
        return {**metrics, **stats}

    held = {}

    def train_step(state, batch):
        if not (graphs and batch["tokens"].is_cuda):
            return state, body(state, batch)
        key = (id(state["opt"]),) + tuple(
            (k, tuple(x.shape)) for k, x in sorted(batch.items()))
        if key not in held:
            buf = {k: x.clone() for k, x in batch.items()}
            fn = lambda: body(state, buf)
            graph, metrics = capture(fn)
            held[key] = (state, buf, graph)
            return state, metrics
        _, buf, graph = held[key]
        for k, x in batch.items():
            buf[k].copy_(x)
        out = graph.replay()
        return state, {k: v.clone() for k, v in out.items()}

    train_step.graphs = held
    return train_step


def clone_cache(cache):
    """A copy of a cache (dicts, lists and tuples of tensors)."""
    if isinstance(cache, dict):
        return {k: clone_cache(x) for k, x in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(clone_cache(x) for x in cache)
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


def make_prefill_step(cfg, max_len: int, policy=None) -> Callable:
    """The prefill step, under ``policy`` when given (module docstring):
    ``prefill_step(params, batch)`` with tokens (B, T), or enc-dec's
    ``{"frames": (B, S, d)}``.  Its ``graphs`` maps each of the last
    ``MAX_PREFILL_GRAPHS`` prompt shapes seen on CUDA, least recently used
    first, to (params, prompt buffer, ``StepGraph``)."""
    held = {}
    pool = []

    def run(params, prompt):
        with use_mesh_policy(policy):
            out = model_lib.prefill(_model(params), cfg, prompt, max_len)
            if isinstance(out, tuple):
                return _whole_logits(out[0], cfg, policy), out[1]
            return out

    def prefill_step(params, batch):
        prompt = batch["frames"] if isinstance(batch, dict) else batch
        if prompt.device.type != "cuda":
            return run(params, prompt)
        key = (tuple(prompt.shape), prompt.dtype, prompt.device)
        entry = held.pop(key, None)
        if entry is None or entry[0] is not params:
            out = run(params, prompt)
            if not pool:
                pool.append(torch.cuda.graph_pool_handle())
            buf = prompt.clone()
            graph = StepGraph(lambda: run(params, buf), pool=pool[0])
            held[key] = (params, buf, graph)
            while len(held) > MAX_PREFILL_GRAPHS:
                del held[next(iter(held))]
            return out
        held[key] = entry                               # now the most recent
        _, buf, graph = entry
        buf.copy_(prompt)
        # copies: the graph's outputs are overwritten by its next replay
        return clone_cache(graph.replay())

    prefill_step.graphs = held
    return prefill_step


def make_decode_step(cfg, policy=None) -> Callable:
    """The decode step, under ``policy`` when given (module docstring);
    its ``graphs`` maps each cache shape seen on CUDA to (params, the
    step's cache, token buffer, ``StepGraph``)."""
    held = {}

    def run(params, cache, token):
        with use_mesh_policy(policy):
            logits, cache = model_lib.decode_step(_model(params), cfg, cache,
                                                  token)
            return _whole_logits(logits, cfg, policy), cache

    def decode_step(params, cache, token):
        if token.device.type != "cuda":
            return run(params, cache, token)
        key = (_shapes(cache), tuple(token.shape))
        entry = held.get(key)
        if entry is None or entry[0] is not params:
            own, buf = clone_cache(cache), torch.empty_like(token)
            graph = StepGraph(lambda: run(params, own, buf)[0])
            entry = held[key] = (params, own, buf, graph)
        elif cache is not entry[1]:
            copy_cache_(entry[1], cache)
        _, own, buf, graph = entry
        buf.copy_(token)
        # a copy: the graph's output is overwritten by its next replay
        return graph.replay().clone(), own

    decode_step.graphs = held
    return decode_step


# ---------------------------------------------------------------------------
# Specs (meta tensors of a rank's blocks: nothing is allocated)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _spec(shape, dtype, spec, mesh) -> torch.Tensor:
    """A meta tensor of a rank's block of a tensor of ``shape`` split by
    ``spec``, carrying ``spec`` and ``global_shape``."""
    shape = tuple(shape)
    t = torch.empty(sharding.local_shape(shape, spec, mesh), dtype=dtype,
                    device=META)
    t.spec, t.global_shape = tuple(spec), shape
    return t


def param_specs(cfg, mesh, *, train: bool) -> model_io.ShardedLM:
    """The rank's parameter blocks: a ``ShardedLM`` over the model built on
    the meta device (``leaves``, ``specs``, ``shapes``)."""
    return model_io.ShardedLM(model_io.empty_model(cfg, META), cfg, mesh,
                              train)


def state_specs(cfg, opt, mesh) -> dict:
    """The training state over ``param_specs(..., train=True)``, with
    ``opt`` (``train.optimizer.make_optimizer``'s factory) built on its
    blocks: ``{"params", "opt", "step"}`` as ``train_state`` gives it."""
    return train_state(cfg, param_specs(cfg, mesh, train=True), opt)


def batch_specs(cfg, shape, mesh) -> dict:
    """A training batch's rank rows: ``{"tokens"}`` (B, S) int32, or (M,
    B/M, S) with ``M = cfg.microbatches > 1`` and dim 1 over the data axes;
    enc-dec's ``frames`` (..., S, d) in the compute dtype beside them."""
    b, s = shape.global_batch, shape.seq_len
    m = max(1, cfg.microbatches)

    def spec(tail, dtype):
        if m == 1:
            return _spec((b,) + tail, dtype,
                         sharding.data_spec(mesh, b, 1 + len(tail)), mesh)
        base = sharding.data_spec(mesh, b // m, 1 + len(tail))
        return _spec((m, b // m) + tail, dtype, (None,) + base, mesh)

    out = {"tokens": spec((s,), torch.int32)}
    if cfg.family == "encdec":
        out = {"frames": spec((s, cfg.d_model),
                              getattr(torch, cfg.compute_dtype)), **out}
    return out


def prefill_input_specs(cfg, shape, mesh):
    """A prefill's rank rows: tokens (B, S) int32, or enc-dec's
    ``{"frames": (B, S, d)}``."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _spec((b, s, cfg.d_model),
                                getattr(torch, cfg.compute_dtype),
                                sharding.data_spec(mesh, b, 3), mesh)}
    return _spec((b, s), torch.int32, sharding.data_spec(mesh, b, 2), mesh)


def _cache_paths(cache, path=()):
    if isinstance(cache, dict):
        for k, x in cache.items():
            yield from _cache_paths(x, path + (k,))
    elif isinstance(cache, (list, tuple)):
        for x in cache:
            yield from _cache_paths(x, path)
    else:
        yield path, cache


def cache_specs(cfg, shape, mesh):
    """A serving cache's rank share: ``models.model.init_cache`` of the
    rank's rows under a policy on ``mesh`` (``sharding.serve_cache_spec``
    over ``model``), on the meta device; each tensor carries its spec
    and whole shape."""
    b, s = shape.global_batch, shape.seq_len
    rows = sharding.local_shape((b,), sharding.data_spec(mesh, b, 1), mesh)[0]
    whole = model_lib.init_cache(cfg, b, s, device=META)
    with use_mesh_policy(MeshPolicy(mesh, {})):
        cache = model_lib.init_cache(cfg, rows, s, device=META)
    for (path, x), (_, w) in zip(_cache_paths(cache), _cache_paths(whole)):
        spec = sharding.serve_cache_spec(path, tuple(w.shape), mesh, b)
        if tuple(x.shape) != sharding.local_shape(w.shape, spec, mesh):
            raise AssertionError(f"{cfg.name} cache {'/'.join(path)}: the "
                                 f"rank holds {tuple(x.shape)}, its spec "
                                 f"{spec} of {tuple(w.shape)} says otherwise")
        x.spec, x.global_shape = spec, tuple(w.shape)
    return cache


def decode_token_specs(cfg, shape, mesh) -> torch.Tensor:
    """A decode step's tokens: the rank's rows of (B,) int32."""
    b = shape.global_batch
    return _spec((b,), torch.int32, sharding.data_spec(mesh, b, 1), mesh)


def input_specs(cfg, shape_name: str, mesh, opt=None) -> tuple:
    """Every input of one (arch x shape) cell's step on ``mesh``: (state,
    batch) to train, (params, prompt) to prefill, (params, cache, token)
    to decode."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        opt = opt or opt_lib.make_optimizer(cfg.optimizer)
        return state_specs(cfg, opt, mesh), batch_specs(cfg, shape, mesh)
    params = param_specs(cfg, mesh, train=False)
    if shape.kind == "prefill":
        return params, prefill_input_specs(cfg, shape, mesh)
    if shape.kind == "decode":
        return (params, cache_specs(cfg, shape, mesh),
                decode_token_specs(cfg, shape, mesh))
    raise ValueError(shape.kind)


def arg_tensors(args) -> list:
    """The tensors of a step's arguments, each once: a ``ShardedLM``'s
    blocks and its model's buffers, an optimizer's state and step, the
    tensors in dicts, lists and tuples."""
    out = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            out[id(x)] = x
        elif isinstance(x, model_io.ShardedLM):
            for t in x.compute_tensors() + list(x.model.buffers()):
                walk(t)
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, opt_lib._Optimizer):
            for t in list(x.state().values()) + [x.step]:
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(args)
    return list(out.values())


def make_step(cfg, shape_name: str, mesh, opt=None) -> tuple:
    """(the step, its arguments from ``input_specs``) of a cell, under a
    policy of the reference's activation rules on ``mesh`` whose
    ``"batch"`` names the axes that split the cell's rows (none where
    they do not divide: the data ranks then hold the same rows)."""
    shape = SHAPES[shape_name]
    train = shape.kind == "train"
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=train))
    rows = (shape.global_batch // max(1, cfg.microbatches) if train
            else shape.global_batch)
    policy.rules["batch"] = sharding.batch_axes(mesh, rows)
    args = input_specs(cfg, shape_name, mesh, opt)
    if train:
        return make_train_step(cfg, policy), args
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape.seq_len, policy), args
    return make_decode_step(cfg, policy), args
