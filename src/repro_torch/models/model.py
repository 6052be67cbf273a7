"""Unified model API: family dispatch (port of ``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params (nn.Module)
    forward(params, cfg, tokens)                    -> (logits, aux_loss)
    init_cache(cfg, batch, max_len, device)         -> serving cache
    prefill(params, cfg, tokens, max_len, **kw)     -> (logits, cache)
    decode_step(params, cfg, cache, token)          -> (logits, cache)

The dense and MoE families (``transformer``), RWKV6 (``ssm``) and
RecurrentGemma (``hybrid``) are ported; enc-dec raises (ROADMAP queue A,
item 5).  Only the transformer's prefill takes ``lengths``: the recurrent
families' caches share one position across the batch.  ``lm_loss`` waits
for training.
"""
from __future__ import annotations

from repro_torch.models import rglru, rwkv6, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": rwkv6,
             "hybrid": rglru}


def _family_mod(cfg):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the port serves "
            "the dense, MoE, RWKV6 and RG-LRU families (enc-dec is ROADMAP "
            "queue A)")
    return _FAMILIES[cfg.family]


def init_params(cfg, seed: int = 0, device=None):
    return _family_mod(cfg).init_params(cfg, seed=seed, device=device)


def forward(params, cfg, tokens):
    return _family_mod(cfg).forward(params, cfg, tokens)


def init_cache(cfg, batch: int, max_len: int, device=None):
    return _family_mod(cfg).init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg, tokens, max_len: int, **kw):
    return _family_mod(cfg).prefill(params, cfg, tokens, max_len, **kw)


def decode_step(params, cfg, cache, token):
    return _family_mod(cfg).decode_step(params, cfg, cache, token)
