"""Carry LM weights across from the reference.

The reference keeps a model's layers stacked on a leading axis
(``params["layers"]["attn"]["wq"]`` is ``(n_layers, d, H, dh)``; an MoE
model has a ``dense_layers`` stack of ``n_dense_layers`` and a
``moe_layers`` stack of the rest); the port has one ``Block`` per layer in
execution order, with the same names and shapes, so carrying them across
is a copy: ``layers[i]`` and ``dense_layers[i]`` go to ``layers.i``,
``moe_layers[j]`` to ``layers.(n_dense + j)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.transformer import Transformer


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def lm_params_from_numpy(tree: dict, cfg, device=None) -> Transformer:
    """The reference's param tree (``repro.models.transformer.init_params``,
    leaves as numpy arrays) as the port's model on ``device`` (CUDA by
    default), in ``cfg.param_dtype``.  Raises on a missing, extra or
    misshapen leaf."""
    model = Transformer(cfg, resolve(device))
    offsets = {"layers": 0, "dense_layers": 0, "moe_layers": model.n_dense}
    state = {}
    for name, value in _flatten(tree):
        value = torch.from_numpy(np.array(value, np.float32))
        stack, _, leaf = name.partition(".")
        if stack in offsets:
            for i in range(value.shape[0]):
                state[f"layers.{offsets[stack] + i}.{leaf}"] = value[i]
        else:
            state[name] = value
    model.load_state_dict(state, strict=True)
    return model
