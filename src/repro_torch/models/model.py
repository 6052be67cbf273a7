"""Unified model API: family dispatch (port of ``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params (nn.Module)
    forward(params, cfg, batch, train=False)        -> (logits, aux_loss)
    lm_loss(params, cfg, batch)                     -> (loss, metrics)
    init_cache(cfg, batch, max_len, device)         -> serving cache
    prefill(params, cfg, batch, max_len, **kw)      -> (logits, cache) | cache
    decode_step(params, cfg, cache, token)          -> (logits, cache)

``batch`` is (B, S) int tokens for the LM families, and for enc-dec the
reference's dict: ``{"frames" (B, S, d), "tokens" (B, T)}`` for
``forward`` and ``lm_loss``, ``{"frames"}`` for ``prefill``, which then
returns the cache alone, as the reference's does.

Every family of the reference is ported: the dense and MoE families
(``transformer``), RWKV6 (``ssm``), RecurrentGemma (``hybrid``) and
whisper's enc-dec (``encdec``).  Only the transformer's prefill takes
``lengths``: the other families' caches share one position across the
batch.

``lm_loss`` is the training loss of every family, through its training
forward (``forward(..., train=True)``): the transformer's and enc-dec's
attention through ``layers.blockwise_attention``, RWKV6's chunk
algorithm ``rwkv6.wkv_chunked`` and RecurrentGemma's log-depth scan
``rglru.rg_lru_scan_train``, all plain PyTorch under autograd, as the
reference differentiates plain algorithms and never its kernels.  Under a
mesh policy (the dense, MoE and enc-dec families) the tokens are this
rank's rows, and the loss keeps the reference's global normaliser: the mask
counts are summed over the data axes before the division; where
``model`` splits the vocab, the logits are this rank's slice and the
cross entropy is vocab-parallel (``lm_loss``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.api import (batch_axes, current_policy,
                                         model_parallel, replicas)
from repro_torch.models import encdec, rglru, rwkv6, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": rwkv6,
             "hybrid": rglru, "encdec": encdec}


def _family_mod(cfg):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port has "
            f"{sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def init_params(cfg, seed: int = 0, device=None):
    return _family_mod(cfg).init_params(cfg, seed=seed, device=device)


def forward(params, cfg, batch, train: bool = False):
    """``train`` asks for the family's training forward."""
    kw = {"train": True} if train else {}
    return _family_mod(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg, batch: int, max_len: int, device=None):
    return _family_mod(cfg).init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg, batch, max_len: int, **kw):
    return _family_mod(cfg).prefill(params, cfg, batch, max_len, **kw)


def decode_step(params, cfg, cache, token):
    return _family_mod(cfg).decode_step(params, cfg, cache, token)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy_parts(logits, targets, m, lo: int = 0):
    """A model rank's terms of the vocab-parallel cross entropy from its
    vocab slice ``logits`` (..., V/m) of ids ``lo ..``, given ``m`` (...),
    the maximum over the whole vocab: (the sum of ``exp(logit - m)`` over
    its ids, in float32; the label's logit where the rank holds
    ``targets``, else 0), each of which the model ranks sum."""
    e = torch.exp(logits.float() - m[..., None])
    s = e.sum(-1)
    del e
    local = targets.clamp(min=0) - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    label = logits.float().gather(
        -1, torch.where(inside, local, 0)[..., None])[..., 0]
    return s, torch.where(inside, label, 0.0)


def lm_loss(params, cfg, batch: dict):
    """Next-token cross entropy over positions [0, S-2] predicting [1,
    S-1] of ``batch["tokens"]`` (B, S), targets below 0 masked, through
    the training forward (enc-dec's over ``batch["frames"]`` too);
    returns (loss + 0.01 * aux, {"loss", "aux_loss", "perplexity"}), as
    the reference's ``lm_loss``.  The log-sum-exp is in float32 from the
    logits' own max; padded vocab ids carry -1e9 logits
    (``transformer.unembed``), so they add nothing to it.  Every family,
    on one device or a mesh.

    Under a mesh policy ``batch`` is this rank's rows: the returned total
    is its share, ``sum(nll * mask)`` over its rows divided by the mask
    count summed over the axes that split the rows (``api.batch_axes``)
    and by the number of data ranks that hold the same rows
    (``api.replicas``), plus ``0.01 * aux`` (whose gradient the MoE
    divides among the data ranks), so the gradients summed over the data
    ranks are the whole batch's; ``loss`` is the shares summed over the
    axes that split the rows (reader ``"lm_loss"``).  Where ``model``
    splits the vocab the logits are this rank's slice and the cross
    entropy is vocab-parallel, term for term the reference's: the maximum
    over the vocab (a MAX over ``model``), the sum of exponentials and
    the label's logit from the rank that holds it, both summed over
    ``model`` (``cross_entropy_parts``)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, batch if cfg.family == "encdec"
                          else tokens, train=True)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    policy = current_policy()
    tp = (model_parallel(policy) if logits.shape[-1] != cfg.vocab_padded
          else None)
    if tp is None:
        m = logits.amax(-1).float()
        e = torch.exp(logits.float() - m[..., None])
        lse = m + torch.log(e.sum(-1))
        del e
        # the label's logit, one element per row (the reference sums a
        # one-hot mask over the vocabulary, which adds zeros to it)
        label = logits.float().gather(
            -1, targets.clamp(min=0)[..., None])[..., 0]
    else:
        mesh, _, idx = tp
        # the maximum only steadies the exponentials: no gradient
        m = collectives.max_over(logits.detach().amax(-1).float(), mesh,
                                 ("model",), reader="lm_loss")
        s, label = cross_entropy_parts(logits, targets, m,
                                       idx * logits.shape[-1])
        lse = m + torch.log(collectives.sum_forward(s, mesh, ("model",),
                                                    reader="lm_loss"))
        label = collectives.sum_forward(label, mesh, ("model",),
                                        reader="lm_loss")
    nll = lse - label
    mask = (targets >= 0).float()
    # without a policy the sums over no axes are the tensors themselves
    mesh = policy.mesh if policy is not None else None
    axes = batch_axes(policy)
    count = collectives.sum_over(mask.sum(), mesh, axes, reader="lm_loss")
    share = (nll * mask).sum() / torch.clamp(count, min=1.0)
    n_rep = replicas(policy)
    total = (share if n_rep == 1 else share / n_rep) + 0.01 * aux
    loss = collectives.sum_over(share.detach().clone(), mesh, axes,
                                reader="lm_loss")
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
