"""Plain version of the flash-attention kernel: exact masked softmax
attention in float32 (port of ``repro/kernels/flash_attn/ref.py``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, dh); k, v (B, KV, Skv, dh) -> (B, H, Sq, dh) in q's
    dtype.  Query head h reads KV head h // (H / KV); key j is seen by query
    i when ``j <= i`` (causal) and ``j > i - window`` (window > 0).  A row
    with no key left gives 0."""
    h, sq, dh = q.shape[1], q.shape[2], q.shape[3]
    kv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)  # fully masked rows -> 0
    o = torch.einsum("bhqs,bhsd->bhqd", p, v.float())
    return o.to(q.dtype)
