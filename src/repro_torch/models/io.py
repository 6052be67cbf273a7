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
  ``layers.(3 n_super + j)``.

Each leaf takes its parameter's dtype, so rglru's ``lam`` stays float32 in
a bf16 model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import rglru, rwkv6
from repro_torch.models.transformer import Transformer


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _model_and_offsets(cfg, device):
    """The port's empty model and, per stacked name of the reference's tree,
    the layer index of its first entry and the stride between entries."""
    if cfg.family == "ssm":
        return rwkv6.RWKV6(cfg, device), {"layers": (0, 1)}
    if cfg.family == "hybrid":
        model = rglru.RecurrentGemma(cfg, device)
        n_super = cfg.n_layers // len(rglru.PATTERN)
        return model, {"super.rec1": (0, 3), "super.rec2": (1, 3),
                       "super.attn": (2, 3), "tail": (3 * n_super, 1)}
    model = Transformer(cfg, device)
    return model, {"layers": (0, 1), "dense_layers": (0, 1),
                   "moe_layers": (model.n_dense, 1)}


def reference_groups(model, cfg) -> dict:
    """A dense or MoE model's parameters by the reference's leaf paths
    (keys joined by ``/``): a leaf the reference stacks over layers
    (``layers/...``, or an MoE model's ``dense_layers/...`` and
    ``moe_layers/...``) is the list of the port's per-layer tensors in
    stack order, every other leaf its tensor.  The optimizers and the
    checkpoints work on this view, so their state and files take the
    reference's shapes and names."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE families train (ROADMAP "
            "queue A item 5)")
    groups = {}
    for name, p in model.named_parameters():
        if not name.startswith("layers."):
            groups[name.replace(".", "/")] = p
            continue
        _, i, leaf = name.split(".", 2)
        stack = ("layers" if cfg.family == "dense" else
                 "dense_layers" if int(i) < model.n_dense else "moe_layers")
        groups.setdefault(f"{stack}/{leaf.replace('.', '/')}", []).append(p)
    return groups


def lm_params_from_numpy(tree: dict, cfg, device=None):
    """The reference's param tree (``init_params`` of its transformer,
    rwkv6 or rglru module, leaves as numpy arrays) as the port's model on
    ``device`` (CUDA by default), in ``cfg.param_dtype``.  Raises on a
    missing, extra or misshapen leaf."""
    model, offsets = _model_and_offsets(cfg, resolve(device))
    state = {}
    for name, value in _flatten(tree):
        value = torch.from_numpy(np.array(value, np.float32))
        stack = next((s for s in offsets if name.startswith(s + ".")), None)
        if stack is None:
            state[name] = value
            continue
        first, step = offsets[stack]
        leaf = name[len(stack) + 1:]
        for i in range(value.shape[0]):
            state[f"layers.{first + step * i}.{leaf}"] = value[i]
    model.load_state_dict(state, strict=True)
    return model
