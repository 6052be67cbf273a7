"""Shared model layers (port of ``repro/models/layers.py``, the part the
dense LM path uses): RMS norm, RoPE, decode attention, SwiGLU and the
initialisers.

Prefill attention is the flash-attention kernel
(``repro_torch.kernels.flash_attn``); decode attention stays plain PyTorch
here, as the reference computes it in XLA and not in Pallas.  Layer norm,
group norm, GeGLU and the blockwise XLA attention wait for the families and
paths that use them (ROADMAP queue A).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``, in float32, returned in
    ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dtype)


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


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


def dense_init(shape, gen: torch.Generator, scale: Optional[float] = None
               ) -> torch.Tensor:
    """float32 normal with std ``scale / sqrt(shape[0])`` (the reference's
    fan-in is the leading axis, also for 3-D weights), drawn on the
    generator's device."""
    std = (scale if scale is not None else 1.0) / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=gen.device) * std


def embed_init(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * 0.02
