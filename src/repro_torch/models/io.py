"""Carry LM weights across from the reference.

The reference keeps a model's layers stacked on a leading axis; the port
has one module per layer in execution order, with the same names and
shapes, so carrying them across is a copy:

- transformer (``params["layers"]["attn"]["wq"]`` is ``(n_layers, d, H,
  dh)``; an MoE model has a ``dense_layers`` stack of ``n_dense_layers``
  and a ``moe_layers`` stack of the rest): ``layers[i]`` and
  ``dense_layers[i]`` go to ``layers.i``, ``moe_layers[j]`` to
  ``layers.(n_dense + j)``;
- rwkv6: ``layers[i]`` to ``layers.i``;
- rglru: superblock i's ``super.rec1``, ``super.rec2`` and ``super.attn``
  to ``layers.3i``, ``layers.(3i+1)`` and ``layers.(3i+2)``, ``tail[j]`` to
  ``layers.(3 n_super + j)``;
- enc-dec: ``enc_layers[i]`` to ``enc_layers.i``, ``dec_layers[i]`` to
  ``dec_layers.i``.

Each leaf takes its parameter's dtype, so rglru's ``lam`` stays float32 in
a bf16 model.

``reference_groups`` is the other way: the port's tensors by the
reference's leaf paths.  On a mesh (``launch/mesh.py``) a model is a
``ShardedLM``: a model whose parameters are this rank's block of every
leaf by ``distributed.sharding.block_spec``, served or trained
(``param_spec``'s but for RWKV6's ``wk``/``wv``/``wo``, split by head)
(``sharded_params_from_numpy`` carries the reference's tree onto a mesh,
``sharded_params_to_numpy`` gathers it back).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn

from repro_torch.device import resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.models import encdec, rglru, rwkv6
from repro_torch.models.transformer import Transformer

# the port's per-layer module lists (names start ``<list>.<i>.``)
LAYER_LISTS = ("layers", "enc_layers", "dec_layers")


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _model_and_offsets(cfg, device):
    """The port's empty model and, per stacked name of the reference's tree,
    the port's layer list it goes to, the index there of its first entry
    and the stride between entries."""
    if cfg.family == "ssm":
        return rwkv6.RWKV6(cfg, device), {"layers": ("layers", 0, 1)}
    if cfg.family == "hybrid":
        model = rglru.RecurrentGemma(cfg, device)
        n_super = cfg.n_layers // len(rglru.PATTERN)
        return model, {"super.rec1": ("layers", 0, 3),
                       "super.rec2": ("layers", 1, 3),
                       "super.attn": ("layers", 2, 3),
                       "tail": ("layers", 3 * n_super, 1)}
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, device), {
            "enc_layers": ("enc_layers", 0, 1),
            "dec_layers": ("dec_layers", 0, 1)}
    model = Transformer(cfg, device)
    return model, {"layers": ("layers", 0, 1),
                   "dense_layers": ("layers", 0, 1),
                   "moe_layers": ("layers", model.n_dense, 1)}


def _stack_of(model, cfg, lst: str, i: int):
    """(the reference's stack of layer ``i`` of the port's list ``lst``,
    its index there)."""
    if lst != "layers":                         # enc-dec: the same names
        return lst, i
    if cfg.family == "dense":
        return "layers", i
    if cfg.family == "moe":
        return (("dense_layers", i) if i < model.n_dense
                else ("moe_layers", i - model.n_dense))
    if cfg.family == "ssm":
        return "layers", i
    n_super = cfg.n_layers // len(rglru.PATTERN)
    if i < 3 * n_super:
        return f"super.{('rec1', 'rec2', 'attn')[i % 3]}", i // 3
    return "tail", i - 3 * n_super


def reference_groups(model, cfg) -> dict:
    """A model's parameters by the reference's leaf paths (keys joined by
    ``/``): a leaf the reference stacks over layers (``layers/...``; an MoE
    model's ``dense_layers/...`` and ``moe_layers/...``; RecurrentGemma's
    ``super/rec1/...``, ``super/rec2/...``, ``super/attn/...`` and
    ``tail/...``; enc-dec's ``enc_layers/...`` and ``dec_layers/...``) is
    the list of the port's per-layer tensors in stack order, every other
    leaf its tensor.  The optimizers, the checkpoints and the mesh's
    shards work on this view, so their state and files take the
    reference's shapes and names."""
    groups = {}
    for name, p in model.named_parameters():
        lst, _, rest = name.partition(".")
        if lst not in LAYER_LISTS:
            groups[name.replace(".", "/")] = p
            continue
        i, leaf = rest.split(".", 1)
        stack, _ = _stack_of(model, cfg, lst, int(i))
        groups.setdefault(f"{stack.replace('.', '/')}/"
                          f"{leaf.replace('.', '/')}", []).append(p)
    return groups


class ShardedLM:
    """This rank's part of an LM on a mesh (``ShardedLM(model, cfg, mesh,
    train)`` takes it from the whole ``model``, whose tensors it
    replaces).

    ``leaves``: reference path -> this rank's block of the leaf by
    ``block_spec(..., train=train)`` (a tensor, or the list of its
    per-layer blocks for a stacked leaf): what the optimizer updates and
    the checkpoint saves.  ``specs``: path -> the (stacked) leaf's spec;
    ``shapes``: path -> its whole shape.  ``model``: the port's module,
    whose parameters are those blocks and nothing else: a rank holds no
    whole tensor of a split leaf between steps.  The layers compute on
    them Megatron-style (``models/transformer.py``, ``models/encdec.py``,
    ``models/moe.py``, ``models/rwkv6.py``, ``models/rglru.py``): a block
    split over ``model`` is what the layer
    computes with (``sharding.compute_spec``), and a block that training
    splits over the data axes carries its spec as ``gather_spec``, so the
    layer gathers it at its use and frees it after, and its gradient
    comes back reduce-scattered to the block (``collectives.at_use``;
    ``regathered`` keeps the gathered weight out of the saved tensors).
    ``sum_replicated_grads`` sums the gradients of the blocks that the
    data axes do not split (norms, the router, a dim that does not
    divide) over those axes.  Every family trains and serves so; RWKV6's
    ``wk``/``wv``/``wo`` split by head (``sharding.block_spec``) where
    ``param_spec`` would split the stacked ``wo`` by its layer axis."""

    def __init__(self, model, cfg, mesh, train: bool):
        self.model, self.cfg, self.mesh, self.train = model, cfg, mesh, train
        owner = {id(p): (mod, attr) for mod in model.modules()
                 for attr, p in mod.named_parameters(recurse=False)}
        daxes = sharding.data_axes(mesh)
        self.leaves, self.specs, self.shapes = {}, {}, {}
        self._blocks = []                        # per member tensor
        self._replicated = []                    # (index, data axes)
        for path, leaf in reference_groups(model, cfg).items():
            stacked = not isinstance(leaf, torch.Tensor)
            members = list(leaf) if stacked else [leaf]
            shape = (((len(members),) if stacked else ())
                     + tuple(members[0].shape))
            spec = sharding.block_spec(path, shape, mesh, train=train)
            mspec = spec[1:] if stacked else spec
            assert not stacked or spec[0] is None, (path, spec)
            used = {a for e in mspec for a in sharding.spec_axes(e)}
            blocks = []
            for p in members:
                if used:
                    mod, attr = owner[id(p)]
                    p = nn.Parameter(
                        sharding.local_shard(p, mspec, mesh).clone(),
                        requires_grad=p.requires_grad)
                    if used - {"model"}:
                        p.gather_spec = mspec
                    setattr(mod, attr, p)
                rest = tuple(a for a in daxes if a not in used
                             and sharding.axis_size(mesh, a) > 1)
                if rest:
                    self._replicated.append((len(self._blocks), rest))
                self._blocks.append(p)
                blocks.append(p)
            self.leaves[path] = blocks if stacked else blocks[0]
            self.specs[path], self.shapes[path] = spec, shape
        self.gathers = any(hasattr(p, "gather_spec") for p in self._blocks)

    def compute_tensors(self) -> list:
        """The model's tensors: the blocks, in the order of the leaves."""
        return list(self._blocks)

    def regathered(self):
        """The context a training forward and backward run in:
        ``collectives.regathered`` where a block is gathered at its use,
        else nothing."""
        return (collectives.regathered() if self.gathers
                else contextlib.nullcontext())

    @torch.no_grad()
    def sum_replicated_grads(self, grads: list) -> list:
        """Gradients of ``compute_tensors()``, each summed in place over
        the data axes that do not split its block (reader
        ``"lm_grads"``); the others came back reduce-scattered."""
        for i, axes in self._replicated:
            g = grads[i]
            if g.is_contiguous():
                collectives.sum_over(g, self.mesh, axes, reader="lm_grads")
            else:
                # a collective takes contiguous storage (an einsum's
                # gradient may come back strided); the sum goes back into
                # the gradient's own layout, whose reductions (the norm)
                # then run in the order they run without a mesh
                g.copy_(collectives.sum_over(g.contiguous(), self.mesh,
                                             axes, reader="lm_grads"))
        return grads


def sharded_params_from_numpy(tree: dict, cfg, mesh, *, train: bool,
                              device=None) -> ShardedLM:
    """The reference's param tree carried onto ``mesh``: this rank's
    blocks by ``block_spec(..., train=train)``, the parameters of the
    model it computes with, on ``device`` (CUDA by default)."""
    return ShardedLM(lm_params_from_numpy(tree, cfg, device), cfg, mesh,
                     train)


def sharded_params_to_numpy(sp: ShardedLM) -> dict:
    """The inverse: every leaf gathered whole (a collective: every rank of
    the mesh calls it), as the reference's nested tree of float32 numpy
    arrays, stacked leaves stacked."""
    out = {}
    for path, leaf in sp.leaves.items():
        spec = sp.specs[path]
        if isinstance(leaf, torch.Tensor):
            full = collectives.gather_spec(leaf, spec, sp.mesh)
        else:
            full = torch.stack([collectives.gather_spec(b, spec[1:], sp.mesh)
                                for b in leaf])
        node = out
        *head, name = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[name] = full.detach().float().cpu().numpy()
    return out


def lm_params_from_numpy(tree: dict, cfg, device=None):
    """The reference's param tree (``init_params`` of its transformer,
    rwkv6, rglru or encdec module, leaves as numpy arrays) as the port's
    model on ``device`` (CUDA by default), in ``cfg.param_dtype``.  Raises
    on a missing, extra or misshapen leaf."""
    model, offsets = _model_and_offsets(cfg, resolve(device))
    state = {}
    for name, value in _flatten(tree):
        value = torch.from_numpy(np.array(value, np.float32))
        stack = next((s for s in offsets if name.startswith(s + ".")), None)
        if stack is None:
            state[name] = value
            continue
        lst, first, step = offsets[stack]
        leaf = name[len(stack) + 1:]
        for i in range(value.shape[0]):
            state[f"{lst}.{first + step * i}.{leaf}"] = value[i]
    model.load_state_dict(state, strict=True)
    return model
