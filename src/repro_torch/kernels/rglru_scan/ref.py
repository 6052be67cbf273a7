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


def rglru_chunked_ref(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """The card's two-pass algorithm (``csrc/rglru_scan.cu``) in plain
    PyTorch, with its clamp ``log_a <= 0``: per chunk of ``chunk`` steps
    (the last one short), the walk from zero to the chunk's end value ``E``
    and its decay ``A``, the direct product of ``exp(min(log_a, 0))`` taken
    step by step; then h0 carried through the ``(A, E)`` of the chunks
    before each one (``h = A h + E``) and each chunk walked from its carry.
    Same shapes and dtypes as ``rglru_scan_ref``."""
    a = torch.exp(log_a.float().clamp(max=0.0))
    b32 = b.float()
    n = b.shape[1]
    starts = range(0, n, chunk)
    sums = []
    for t0 in starts:                               # pass 1
        prod = torch.ones_like(h0, dtype=torch.float32)
        end = torch.zeros_like(prod)
        for t in range(t0, min(t0 + chunk, n)):
            prod = prod * a[:, t]
            end = a[:, t] * end + b32[:, t]
        sums.append((prod, end))
    out = torch.empty_like(b32)
    for c, t0 in enumerate(starts):                 # pass 2
        h = h0.float()
        for prod, end in sums[:c]:
            h = prod * h + end
        for t in range(t0, min(t0 + chunk, n)):
            h = a[:, t] * h + b32[:, t]
            out[:, t] = h
    return out.to(b.dtype)
