"""Plain versions of the chunked RWKV6 WKV scan (B5).

``rwkv6_scan_ref`` is the token-by-token recurrence of
``repro/kernels/rwkv6_scan/ref.py``, the oracle; ``wkv_chunked_ref`` is the
chunk algorithm of ``repro/models/rwkv6.py::wkv_chunked``, with its
rounding of the intra-chunk decay tensor ``D`` to ``d_dtype``, which the
model runs on the CPU so that it rounds as the reference model does;
``wkv_groups_ref`` is the card's algorithm (``csrc/rwkv6_scan.cu``): the
decay factored in sub-blocks and the group passes.  All start from a zero
state and return ``(y, state)``:

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


def _excl(d):
    """Exclusive cumulative sums of d over rows (dim 2)."""
    return torch.cumsum(d, dim=2) - d


def _suffix(d):
    """For each row s, the sum of d over the rows after s (dim 2)."""
    return torch.flip(_excl(torch.flip(d, [2])), [2])


def _chunk_a(r, k, d, u, sub):
    """A (B, H, L, L) of one chunk as the card builds it, the bonus
    ``r_i . (u k_i)`` on its diagonal.  Block-row J (rows i0 = J*sub ..)
    against the columns before it is factored at row i0:
    ``(r_i e^{p_i - p_i0}) . (k_s e^{p_i0 - q_s})``, both factors <= 1 for
    dlog <= 0; pairs s < i inside a sub-block take one exponential each.
    Every exponent is a sum of dlog over the rows between its ends, never a
    difference of two long cumulative sums."""
    n_b, n_h, n_l, _ = r.shape
    a = torch.zeros((n_b, n_h, n_l, n_l), dtype=torch.float32, device=r.device)
    for i0 in range(0, n_l, sub):
        rows = slice(i0, min(i0 + sub, n_l))
        lp = _excl(d[:, :, rows])                    # p_i - p_i0
        if i0:
            r_hat = r[:, :, rows] * torch.exp(lp)
            k_hat = k[:, :, :i0] * torch.exp(_suffix(d[:, :, :i0]))
            a[:, :, rows, :i0] = torch.einsum("bhik,bhsk->bhis", r_hat, k_hat)
        dec = torch.exp(lp[:, :, :, None, :] - (lp + d[:, :, rows])[:, :, None])
        inner = torch.einsum("bhik,bhsk,bhisk->bhis", r[:, :, rows],
                             k[:, :, rows], dec)
        m = rows.stop - i0
        inner = torch.where(torch.ones((m, m), dtype=torch.bool,
                                       device=r.device).tril(-1), inner, 0.0)
        a[:, :, rows, rows] = inner + torch.diag_embed(
            torch.einsum("bhik,hk,bhik->bhi", r[:, :, rows], u, k[:, :, rows]))
    return a


def _walk(r, k, v, dlog, u, state, chunk, sub, want_y):
    """Chunks of ``chunk`` rows from ``state``: (y or None, state)."""
    ys = []
    for t0 in range(0, r.shape[2], chunk):
        cut = slice(t0, t0 + chunk)
        rb, kb, vb, db = r[:, :, cut], k[:, :, cut], v[:, :, cut], dlog[:, :, cut]
        if want_y:
            ys.append(torch.einsum("bhlk,bhkv->bhlv", rb * torch.exp(_excl(db)),
                                   state) + _chunk_a(rb, kb, db, u, sub) @ vb)
        k_dec = kb * torch.exp(_suffix(db))          # k e^{p_end - q}
        state = (torch.exp(db.sum(2))[..., None] * state
                 + torch.einsum("bhsk,bhsv->bhkv", k_dec, vb))
    return (torch.cat(ys, dim=2) if want_y else None), state


def wkv_groups_ref(r, k, v, dlog, u, chunk: int = 16, sub: int = 8,
                   group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card's algorithm in float32, any T (the tail padded with r = k =
    v = 0, dlog = 0, which leaves the state unchanged): chunks of ``chunk``
    rows, A factored in sub-blocks of ``sub`` (``_chunk_a``), and the
    prompt cut into groups of ``group`` tokens (a multiple of ``chunk``).
    One group: one walk from S = 0.  More: (a) per group, its increment
    dS_g (the walk from S = 0) and decay P_g = sum dlog; (b) serially,
    S_{g+1} = e^{P_g} S_g + dS_g; (c) per group, the walk from S_g for y."""
    n_b, n_h, n, kd = r.shape
    if group % chunk:
        raise ValueError(f"group {group} is not a multiple of the chunk {chunk}")
    pad = (-n) % chunk
    r32, k32, v32, d32 = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                          for x in (r, k, v, dlog))
    u32 = u.float()
    zero = torch.zeros((n_b, n_h, kd, v.shape[-1]), dtype=torch.float32,
                       device=r.device)
    cuts = [slice(t0, t0 + group) for t0 in range(0, n + pad, group)]
    if len(cuts) == 1:
        y, state = _walk(r32, k32, v32, d32, u32, zero, chunk, sub, True)
        return y[:, :, :n].to(r.dtype), state
    starts, state = [], zero
    for cut in cuts:                                        # (a) and (b)
        _, d_s = _walk(r32[:, :, cut], k32[:, :, cut], v32[:, :, cut],
                       d32[:, :, cut], u32, zero, chunk, sub, False)
        starts.append(state)
        state = torch.exp(d32[:, :, cut].sum(2))[..., None] * state + d_s
    y = torch.cat([_walk(r32[:, :, cut], k32[:, :, cut], v32[:, :, cut],
                         d32[:, :, cut], u32, s_g, chunk, sub, True)[0]
                   for cut, s_g in zip(cuts, starts)], dim=2)   # (c)
    return y[:, :, :n].to(r.dtype), state
