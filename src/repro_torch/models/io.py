"""Carry LM weights across from the reference.

The reference keeps a dense model's layers stacked on a leading axis
(``params["layers"]["attn"]["wq"]`` is ``(n_layers, d, H, dh)``); the port
has one ``Block`` per layer with the same names and shapes, so carrying
them across is a copy.
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
    state = {}
    for name, value in _flatten(tree):
        value = torch.from_numpy(np.array(value, np.float32))
        if name.startswith("layers."):
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{name[len('layers.'):]}"] = value[i]
        else:
            state[name] = value
    model.load_state_dict(state, strict=True)
    return model
