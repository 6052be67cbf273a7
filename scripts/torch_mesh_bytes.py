"""Per-rank bytes of an LM on a ``("data", "model")`` mesh, by the port's
specs (arithmetic from the shapes, not a measurement).

    PYTHONPATH=src python scripts/torch_mesh_bytes.py

For each case it builds the port's model of the published config on the
meta device (nothing is allocated), takes every leaf's spec
(``distributed.sharding.block_spec``: ``param_spec``'s, RWKV6's
``wk``/``wv``/``wo`` split by head) and what a layer computes with
(``compute_spec``), and prints one JSON line: the bytes a rank holds in
the parameter dtype for its parameter blocks, its gradient blocks, its
AdamW moments (two float32 tensors split as their leaves), the largest
layer's weights gathered at their use (the transient), and the same
figures in the layout before the split (a whole compute copy but for the
experts' dim over ``model``, beside the blocks of the leaves the mesh
splits, and whole gradients).
Training cases are AdamW's, with the whole model's state beside them
(parameters, gradients and moments on one device); no activation is
counted.  The recurrent families' training (rwkv6-7b at all 32 layers,
recurrentgemma-2b) is given on 1 x 4, 2 x 2 and 4 x 1.  A serving case
counts the parameters alone, split into the experts' and the rest.

Then the serving caches: for each cache case, the bytes a ``model`` rank
holds of ``streams`` caches of ``tokens`` (``models.model.init_cache``
under a policy on the meta device, by ``sharding.serve_cache_spec``) for
a ``model`` axis of 1, 2 and 4, and the bytes per reader of one decode
step of ``streams`` rows (``sharding.serve_step_bytes``).

Then the sequence split (``cfg.seq_parallel``): for each case, training
``global batch`` sequences of ``seq`` tokens with the flag off and on,
per layer, the bytes of the residual stream and of the two norms'
inputs a rank holds, and the bytes the layer's ``model`` collectives
bring a rank, forward, backward and in the recompute under ``cfg.remat``
(by reader: ``tp_sum``/``tp_grads`` the all-reduces without the split,
``sharding.seq_split_bytes`` with it).  The data axes' FSDP gathers are
the same either way and are left out.
"""
from __future__ import annotations

import dataclasses
import json
import math

import torch

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.api import MeshPolicy, use_mesh_policy
from repro_torch.models import io, model as model_lib

# (arch, data, model, train)
CASES = [("starcoder2-15b", 4, 1, True), ("starcoder2-15b", 2, 2, True),
         ("dbrx-132b", 1, 4, False), ("qwen1.5-0.5b", 4, 1, True)] + [
    (arch, data, model, True) for arch in ("rwkv6-7b", "recurrentgemma-2b")
    for data, model in ((1, 4), (2, 2), (4, 1))]


# (arch, streams, tokens a stream) of the serving caches
CACHE_CASES = [("granite-34b", 32, 8192), ("recurrentgemma-2b", 32, 8192),
               ("rwkv6-7b", 32, 8192)]
CACHE_MS = (1, 2, 4)

# (arch, data, model, global batch, tokens a sequence) of the sequence split
SEQ_CASES = [("starcoder2-15b", 1, 4, 8, 4096),
             ("starcoder2-15b", 4, 1, 8, 4096)]


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


def _numel(shape) -> int:
    return math.prod(shape)


def rank_bytes(arch: str, data: int, model: int, train: bool) -> dict:
    cfg = get_config(arch)
    mesh = FakeMesh({"data": data, "model": model})
    elt = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    m = io.empty_model(cfg, "meta")
    out = {"arch": arch, "mesh": [data, model], "train": train,
           "param_dtype": cfg.param_dtype}
    whole = block = compute_old = split_block = 0
    expert_block = expert_whole = 0
    layer = {}
    for path, leaf in io.reference_groups(m, cfg).items():
        stacked = not isinstance(leaf, torch.Tensor)
        members = list(leaf) if stacked else [leaf]
        shape = (((len(members),) if stacked else ())
                 + tuple(members[0].shape))
        spec = sharding.block_spec(path, shape, mesh, train=train)
        comp = sharding.compute_spec(path, shape, mesh, train=train)
        n_whole = _numel(shape)
        n_block = _numel(sharding.local_shape(shape, spec, mesh))
        whole += n_whole
        block += n_block
        expert = sharding.is_expert_weight(path)
        keep = ("model",) if expert else ()
        old = [e if any(a in keep for a in sharding.spec_axes(e)) else None
               for e in spec]
        compute_old += _numel(sharding.local_shape(shape, old, mesh))
        if sharding.is_split(spec, keep):
            split_block += n_block
        if expert:
            expert_block += n_block
            expert_whole += n_whole
        per = _numel(sharding.local_shape(shape[1:] if stacked else shape,
                                          comp[1:] if stacked else comp,
                                          mesh))
        gathered = any(a != "model" for e in spec
                       for a in sharding.spec_axes(e))
        if gathered:
            for i in range(len(members)):
                key = f"{path.split('/')[0]}.{i}" if stacked else path
                layer[key] = layer.get(key, 0) + per
    gb = lambda n, size=elt: n * size / 1e9
    out.update(params_whole_gb=gb(whole), params_block_gb=gb(block))
    if train:
        out.update(
            grads_block_gb=gb(block), adamw_moments_gb=gb(2 * block, 4),
            largest_layer_gathered_gb=gb(max(layer.values(), default=0)),
            split_total_gb=gb(2 * block) + gb(2 * block, 4),
            whole_total_gb=gb(2 * whole) + gb(2 * whole, 4),
            before_compute_copy_gb=gb(compute_old),
            before_whole_grads_gb=gb(compute_old),
            before_blocks_gb=gb(split_block),
            before_total_gb=(gb(2 * compute_old) + gb(split_block)
                             + gb(2 * block, 4)))
    else:
        out.update(non_expert_block_gb=gb(block - expert_block),
                   non_expert_whole_gb=gb(whole - expert_whole),
                   experts_block_gb=gb(expert_block))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for item in items for x in _leaves(item)]


def cache_bytes(arch: str, streams: int, tokens: int) -> dict:
    cfg = get_config(arch)
    out = {"arch": arch, "streams": streams, "tokens": tokens,
           "dtype": cfg.compute_dtype}
    for m in CACHE_MS:
        mesh = FakeMesh({"data": 1, "model": m})
        with use_mesh_policy(MeshPolicy(mesh, {}) if m > 1 else None):
            cache = model_lib.init_cache(cfg, streams, tokens, device="meta")
        held = sum(x.numel() * x.element_size() for x in _leaves(cache))
        out[f"m{m}_cache_gb"] = held / 1e9
        if m > 1:
            slots = (min(cfg.window, tokens) if cfg.family == "hybrid"
                     else tokens)
            out[f"m{m}_decode_bytes"] = sharding.serve_step_bytes(
                cfg, m, streams, 1, slots, True)
    return out


def _minus(a: dict, b: dict) -> dict:
    keys = sorted(set(a) | set(b))
    return {k: a.get(k, 0) - b.get(k, 0) for k in keys
            if a.get(k, 0) != b.get(k, 0)}


def layer_collectives(cfg, m: int, rows: int, seq: int) -> dict:
    """One layer's ``model`` collectives' bytes a rank receives:
    forward, backward and the recompute's."""
    if m == 1:
        return {"forward": {}, "backward": {}, "recompute": {}}
    if not cfg.seq_parallel:
        # a split layer's all-reduce of its output, and of its input's
        # gradient; the recompute repeats the attention's (the FFN's
        # all-reduce is the layer's last op, which nothing saved needs)
        e = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                        ).element_size()
        whole = rows * seq * cfg.d_model * e
        attn, ffn = cfg.n_heads % m == 0, cfg.d_ff % m == 0
        return {"forward": {"tp_sum": (attn + ffn) * whole},
                "backward": {"tp_grads": (attn + ffn) * whole},
                "recompute": {"tp_sum": attn * whole}}

    def count(layers: int, train: bool, remat: bool = False) -> dict:
        c = dataclasses.replace(cfg, n_layers=layers, remat=remat)
        return sharding.seq_split_bytes(c, m, rows, seq, train)

    fwd = _minus(count(1, False), count(0, False))
    return {"forward": fwd,
            "backward": _minus(_minus(count(1, True), count(0, True)), fwd),
            "recompute": _minus(count(1, True, True), count(1, True))}


def seq_bytes(arch: str, data: int, model: int, batch: int, seq: int
              ) -> dict:
    cfg = get_config(arch)
    rows = batch // data
    e = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                    ).element_size()
    out = {"arch": arch, "mesh": [data, model], "global_batch": batch,
           "seq": seq, "dtype": cfg.compute_dtype}
    for flag in (False, True):
        c = dataclasses.replace(cfg, seq_parallel=flag)
        held = -(-seq // model) if flag and model > 1 else seq
        resid = rows * held * cfg.d_model * e
        out[f"seq_parallel_{str(flag).lower()}"] = {
            "residual_bytes_per_layer": resid,
            "norm_inputs_bytes_per_layer": 2 * resid,
            "collectives_bytes_per_layer": layer_collectives(c, model, rows,
                                                             seq)}
    return out


def main() -> None:
    for case in CASES:
        print(json.dumps(rank_bytes(*case)))
    for case in CACHE_CASES:
        print(json.dumps(cache_bytes(*case)))
    for case in SEQ_CASES:
        print(json.dumps(seq_bytes(*case)))


if __name__ == "__main__":
    main()
