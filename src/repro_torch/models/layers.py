"""Shared model layers (port of ``repro/models/layers.py``): RMS norm,
layer norm, per-head group norm, RoPE, local attention, SwiGLU, GeGLU and
the initialisers.

The transformer's prefill attention is the flash-attention kernel
(``repro_torch.kernels.flash_attn``), and every model's decode attention
the decode-attention kernel (``repro_torch.kernels.decode_attn``, whose
plain versions, the reference's ``decode_attention`` among them, live in
its ``ref.py``).  ``local_attention`` stays plain PyTorch, as the
reference computes it in XLA and not in Pallas: it is RecurrentGemma's
over whole sequences (the flash kernel takes head dims up to 128, and
RecurrentGemma's is 256).
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
