"""Shared model layers (port of ``repro/models/layers.py``): RMS norm,
layer norm, per-head group norm, RoPE, local and decode attention, SwiGLU,
GeGLU and the initialisers.

The transformer's prefill attention is the flash-attention kernel
(``repro_torch.kernels.flash_attn``).  Decode attention and the local
attention of RecurrentGemma stay plain PyTorch here, as the reference
computes both in XLA and not in Pallas (the flash kernel also takes head
dims up to 128, and RecurrentGemma's is 256).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def param(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that takes no gradient (the port serves;
    ``init_params`` or ``io`` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``, in float32, returned in
    ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * w + b`` over the last dim, in
    float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(dtype)


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Group norm with one group per head over the last dim (RWKV6's output
    norm), in float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, n_heads, d // n_heads)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (x * w.float() + b.float()).to(dtype)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, d_head); positions: (..., S) int.  Rotates the two halves
    of the head (so d_head 120 splits 60|60), in float32."""
    dtype = x.dtype
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs              # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One query token per sequence against a slot cache, GQA, in float32.

    q (B, H, dh); k_cache, v_cache (B, S, KV, dh); kv_positions (B, S)
    absolute positions with -1 for an empty slot; pos (B,) the query's
    position.  A slot takes part when ``0 <= kv_pos <= pos``."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    qh = q.reshape(b, kv, h // kv, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float()) / math.sqrt(dh)
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device), (b,))
    valid = (kv_positions >= 0) & (kv_positions <= pos[:, None])   # (B, S)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, h, dh).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, block_q: int = 512) -> torch.Tensor:
    """Causal attention over whole sequences within a window, GQA/MQA, the
    softmax in float32 (the function of the reference's XLA
    ``blockwise_attention`` with ``causal=True``).

    q (B, S, H, dh); k, v (B, S, KV, dh) -> (B, S, H, dh) in q's dtype.
    Query i sees key j when ``j <= i`` and, for ``window > 0``, ``j > i -
    window``.  Queries go in blocks of ``block_q``, each against only the
    keys its window can reach, so the scores of a long prompt never exist
    at once."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qf = q.float().reshape(b, s, kv, h // kv, dh)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, kv, h // kv, dh), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, s, block_q):
        hi = min(lo + block_q, s)
        k_lo = max(0, lo - window + 1) if window > 0 else 0
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf[:, lo:hi],
                          kf[:, k_lo:hi]) / math.sqrt(dh)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(k_lo, hi, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, lo:hi] = torch.einsum("bkgqs,bskd->bqkgd", p, vf[:, k_lo:hi])
    return out.reshape(b, s, h, dh).to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


def geglu(x, w_gate, w_up, w_down):
    """``gelu(x @ w_gate) * (x @ w_up) @ w_down`` with the tanh GELU, which
    is ``jax.nn.gelu``'s default (``approximate=True``)."""
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.gelu(g, approximate="tanh") * u,
                        w_down)


def dense_init(shape, gen: torch.Generator, scale: Optional[float] = None
               ) -> torch.Tensor:
    """float32 normal with std ``scale / sqrt(shape[0])`` (the reference's
    fan-in is the leading axis, also for 3-D weights), drawn on the
    generator's device."""
    std = (scale if scale is not None else 1.0) / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=gen.device) * std


def embed_init(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * 0.02
