"""Plain version of the RG-LRU scan (B6): the serial recurrence in float32
(port of ``repro/kernels/rglru_scan/ref.py``)."""
from __future__ import annotations

import torch


def rglru_scan_ref(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                   ) -> torch.Tensor:
    """log_a, b (B, T, W); h0 (B, W) -> h (B, T, W) in b's dtype, with
    ``h_t = exp(log_a_t) * h_{t-1} + b_t`` and ``h_{-1} = h0``, the state in
    float32."""
    a = torch.exp(log_a.float())
    b32 = b.float()
    h = h0.float()
    out = torch.empty_like(b32)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(b.dtype)
