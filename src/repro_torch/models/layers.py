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
RecurrentGemma's is 256).  ``blockwise_attention`` is the reference's
``attn_impl="xla"`` attention, the one it trains with: plain PyTorch under
autograd, since neither package has a backward for the flash kernel.
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


def block_pairs(n_q: int, n_kv: int, block_q: int, block_kv: int,
                causal: bool, window: int, kv_offset: int) -> list:
    """The (q-block, kv-block) pairs that hold any unmasked entry, q-block
    major (the reference's ``_block_pairs``)."""
    pairs = []
    for i in range(n_q):
        q_lo, q_hi = i * block_q, (i + 1) * block_q - 1
        for j in range(n_kv):
            k_lo = j * block_kv + kv_offset
            k_hi = (j + 1) * block_kv - 1 + kv_offset
            if causal and k_lo > q_hi:
                continue                        # entirely in the future
            if window > 0 and k_hi < q_lo - window + 1:
                continue                        # entirely outside the window
            pairs.append((i, j))
    return pairs or [(0, 0)]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block_q: int = 512, block_kv: int = 1024,
                        kv_offset: int = 0) -> torch.Tensor:
    """Streaming-softmax GQA attention visiting only the block pairs that
    hold unmasked entries, accumulators in float32 (the reference's
    ``layers.blockwise_attention``), differentiable.

    q (B, Sq, H, dh); k, v (B, Skv, KV, dh) -> (B, Sq, H, dh) in q's dtype.
    KV heads are repeated to H.  Each q-block walks its kv-blocks in the
    reference's pair order with its own running max, sum and accumulator,
    so the arithmetic is the reference's; both products take the operands
    in float32 (exact for bf16 inputs), as its ``preferred_element_type``
    accumulates them."""
    out_dtype = q.dtype
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    assert h % kv == 0, (h, kv)
    g = h // kv
    block_q, block_kv = min(block_q, sq), min(block_kv, skv)
    pad_q, pad_kv = (-sq) % block_q, (-skv) % block_kv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    n_q, n_kv = (sq + pad_q) // block_q, (skv + pad_kv) // block_kv
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    q_in = torch.arange(block_q, dtype=torch.int32, device=dev)
    k_in = torch.arange(block_kv, dtype=torch.int32, device=dev)
    pairs = block_pairs(n_q, n_kv, block_q, block_kv, causal, window,
                        kv_offset)
    outs = []
    for i in range(n_q):
        m = torch.full((b, h, block_q), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, block_q, dh), dtype=torch.float32,
                          device=dev)
        qb = qh[:, :, i * block_q:(i + 1) * block_q].float()
        for j in (j for ii, j in pairs if ii == i):
            kb = kh[:, :, j * block_kv:(j + 1) * block_kv].float()
            vb = vh[:, :, j * block_kv:(j + 1) * block_kv]
            s = torch.einsum("bhqd,bhsd->bhqs", qb, kb) * scale
            qpos = i * block_q + q_in
            kpos = j * block_kv + k_in + kv_offset
            mask = (kpos[None, :] < skv + kv_offset).expand(block_q, -1)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            # fully masked rows (m_new = -inf) get p = 0
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = corr * l + p.sum(-1)
            pv = torch.einsum("bhqs,bhsd->bhqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = corr[..., None] * acc + pv
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)[:, :sq]
    return out.to(out_dtype)


def heads_out(o, wo):
    """The attention's output projection: o (..., H, dh) through wo (H,
    dh, d) -> (..., d), as one product over the flattened heads, so the
    backward saves ``wo`` as a view (an einsum over (h, e) saves a
    copy)."""
    return torch.einsum("...k,kd->...d", o.flatten(-2), wo.flatten(0, 1))


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
