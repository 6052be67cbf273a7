"""Step functions over the unified model API (port of the serving half of
``repro/launch/steps.py``): the prefill and decode steps that serve the
recurrent families, which ``ExpertServer`` does not, as the reference
serves them.

    prefill_step = make_prefill_step(cfg, max_len)
    logits, cache = prefill_step(params, tokens)        # tokens (B, T)
    decode_step = make_decode_step(cfg)
    logits, cache = decode_step(params, cache, token)   # token (B,)

The reference wraps each call in a ``MeshPolicy``; the port has no mesh
yet (ROADMAP queue A, item 3), so it takes none.  The training step and
the spec functions wait for training and the mesh.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import model as model_lib


def make_prefill_step(cfg, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(params, cache, token):
        return model_lib.decode_step(params, cfg, cache, token)
    return decode_step
