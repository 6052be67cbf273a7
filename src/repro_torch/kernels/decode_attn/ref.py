"""Plain version of the decode-attention kernel: masked softmax attention of
one query token per sequence, in float32 (port of
``repro/kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, dh); k, v (B, KV, S, dh); lengths (B,) -> (B, H, dh) in q's
    dtype.  Query head h reads KV head h // (H / KV); key j takes part when
    ``j < lengths[b]``.  A sequence of length 0 gives 0, as the kernel's
    ``max(l, 1e-30)`` denominator does (the reference's plain version gives
    NaN there)."""
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) / math.sqrt(dh)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, :]          # (B, 1, S)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    o = torch.einsum("bhs,bhsd->bhd", p, v.float())
    return o.to(q.dtype)
