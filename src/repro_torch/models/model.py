"""Unified model API: family dispatch (port of ``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params (nn.Module)
    forward(params, cfg, tokens)                    -> (logits, aux_loss)
    init_cache(cfg, batch, max_len, device)         -> serving cache
    prefill(params, cfg, tokens, max_len, lengths=) -> (logits, cache)
    decode_step(params, cfg, cache, token)          -> (logits, cache)

The dense and MoE families (both ``transformer``) are ported; the others
raise (ROADMAP queue A, item 5).  ``lm_loss`` waits for training.
"""
from __future__ import annotations

from repro_torch.models import transformer


def _family_mod(cfg):
    if cfg.family in ("dense", "moe"):
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported; the port serves the "
        "dense and MoE families (RWKV6, RG-LRU and enc-dec are ROADMAP queue A)")


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
