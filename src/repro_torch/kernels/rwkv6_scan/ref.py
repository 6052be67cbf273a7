"""Plain versions of the chunked RWKV6 WKV scan (B5).

``rwkv6_scan_ref`` is the token-by-token recurrence of
``repro/kernels/rwkv6_scan/ref.py``, the oracle; ``wkv_chunked_ref`` is the
chunk algorithm of ``repro/models/rwkv6.py::wkv_chunked``, with its
rounding of the intra-chunk decay tensor ``D`` to ``d_dtype``, which the
model runs on the CPU so that it rounds as the reference model does.  Both
start from a zero state and return ``(y, state)``:

    r, k, dlog (B, H, T, K); v (B, H, T, V); u (H, K)
    -> y (B, H, T, V) in r's dtype, state (B, H, K, V) float32
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_scan_ref(r, k, v, dlog, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """``S_t = diag(exp(dlog_t)) S_{t-1} + k_tᵀ v_t``,
    ``y_t = r_t S_{t-1} + (r_t · (u ⊙ k_t)) v_t``, one token at a time in
    float32."""
    b, h, n, kd = r.shape
    r32, k32, v32, d32 = (a.float() for a in (r, k, v, dlog))
    u32 = u.float()
    state = torch.zeros((b, h, kd, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(n):
        rt, kt, vt = r32[:, :, t], k32[:, :, t], v32[:, :, t]
        y = torch.einsum("bhk,bhkv->bhv", rt, state)
        bonus = torch.einsum("bhk,hk,bhk->bh", rt, u32, kt)
        ys.append(y + bonus[..., None] * vt)
        state = (torch.exp(d32[:, :, t])[..., None] * state
                 + kt[..., None] * vt[..., None, :])
    y = torch.stack(ys, dim=2) if ys else torch.zeros_like(v32)
    return y.to(r.dtype), state


def wkv_chunked_ref(r, k, v, dlog, u, chunk: int = 32,
                    d_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk algorithm in chunks of ``L = min(chunk, T)``; T must be a
    multiple of L, as the reference asserts (``rwkv6.py:99``).  ``D`` and
    the ``r``, ``k`` it multiplies are rounded to ``d_dtype`` (float32 when
    None, as the kernel keeps it), the contraction in float32."""
    b, h, n, kd = r.shape
    vd = v.shape[-1]
    n_l = min(chunk, n)
    if n % n_l:
        raise ValueError(f"T={n} is not a multiple of the chunk {n_l}")
    d_dtype = d_dtype or torch.float32
    rc, kc, dc = (a.reshape(b, h, n // n_l, n_l, kd) for a in (r, k, dlog))
    vc = v.reshape(b, h, n // n_l, n_l, vd)
    u32 = u.float()
    mask = torch.tril(torch.ones((n_l, n_l), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    state = torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(n // n_l):
        rb, kb, vb = rc[:, :, c], kc[:, :, c], vc[:, :, c]
        db = dc[:, :, c].float()
        rb32, kb32, vb32 = rb.float(), kb.float(), vb.float()
        p = torch.cumsum(db, dim=2) - db          # exclusive: sum over j < i
        p_end = p[:, :, -1] + db[:, :, -1]
        y_inter = torch.einsum("bhlk,bhkv->bhlv", rb32 * torch.exp(p), state)
        dmat = torch.exp(p[:, :, :, None, :]
                         - (p + db)[:, :, None, :, :]).to(d_dtype)
        a = torch.einsum("bhik,bhsk,bhisk->bhis", rb.to(d_dtype).float(),
                         kb.to(d_dtype).float(), dmat.float())
        a = torch.where(mask, a, 0.0)
        y_intra = torch.einsum("bhis,bhsv->bhiv", a, vb32)
        diag = torch.einsum("bhik,hk,bhik->bhi", rb32, u32, kb32)
        ys.append(y_inter + y_intra + diag[..., None] * vb32)
        k_dec = kb32 * torch.exp(p_end[:, :, None, :] - (p + db))
        state = (torch.exp(p_end)[..., None] * state
                 + torch.einsum("bhsk,bhsv->bhkv", k_dec, vb32))
    return torch.cat(ys, dim=2).to(r.dtype), state
