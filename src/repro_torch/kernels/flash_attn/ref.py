"""Plain versions of the flash-attention kernel: exact masked softmax
attention in float32 (port of ``repro/kernels/flash_attn/ref.py``), which
the wrapper runs on the CPU, and the bf16 kernel's tile algorithm, which
tests and the card check hold the kernel to."""
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


BLOCK_M = 64    # the bf16 kernel's packed query rows per tile (BM)
BLOCK_N = 64    # and keys per K/V tile (BN)


def attention_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """The bf16 CUDA kernel's tile algorithm in plain PyTorch, for tests and
    the card check (the model never calls it); same contract as
    ``attention_ref``.

    Per (b, KV head) the G = H / KV query heads are packed into rows, row
    r <-> (position r // G, head r % G), cut into tiles of ``BLOCK_M``.  A
    tile walks the key tiles of ``BLOCK_N`` from the first its first
    row's position can see to the last its last row's can (the others are
    skipped), with an online softmax in float32 on log2(e)-scaled scores.
    The row sum l is taken over the float32 p; p is rounded to q's dtype
    (bf16: the kernel's rounding before PV; float32: none) before PV."""
    b, h, sq, dh = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    rows = sq * g
    n_mt = -(-rows // BLOCK_M)
    dev = q.device
    qp = q.float().reshape(b, kv, g, sq, dh).transpose(2, 3).reshape(
        b, kv, rows, dh)
    qp = torch.nn.functional.pad(qp, (0, 0, 0, n_mt * BLOCK_M - rows))
    qp = qp.reshape(b, kv, n_mt, BLOCK_M, dh)
    pos = torch.arange(n_mt * BLOCK_M, device=dev).reshape(n_mt, BLOCK_M) // g
    first = torch.arange(n_mt, device=dev) * BLOCK_M
    p_lo = first // g
    p_last = (torch.clamp(first + BLOCK_M, max=rows) - 1) // g
    kv_end = torch.clamp(p_last + 1, max=skv) if causal \
        else torch.full_like(p_lo, skv)
    kv_begin = torch.clamp(p_lo - window + 1, min=0) if window > 0 \
        else torch.zeros_like(p_lo)
    t_first = kv_begin // BLOCK_N
    t_end = torch.where(kv_begin < kv_end, -(-kv_end // BLOCK_N), t_first)

    scale_log2 = math.log2(math.e) / math.sqrt(dh)
    m = torch.full((b, kv, n_mt, BLOCK_M), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, n_mt, BLOCK_M, dh), device=dev)
    for t in range(-(-skv // BLOCK_N)):
        active = (t_first <= t) & (t < t_end)               # (n_mt,)
        if not bool(active.any()):
            continue
        j0 = t * BLOCK_N
        pad = (0, 0, 0, j0 + BLOCK_N - min(skv, j0 + BLOCK_N))
        kt = torch.nn.functional.pad(k[:, :, j0:j0 + BLOCK_N].float(), pad)
        vt = torch.nn.functional.pad(v[:, :, j0:j0 + BLOCK_N].float(), pad)
        s = torch.einsum("bkmrd,bknd->bkmrn", qp, kt) * scale_log2
        key = torch.arange(j0, j0 + BLOCK_N, device=dev)
        seen = (key < skv).expand(n_mt, BLOCK_M, BLOCK_N)
        if causal:
            seen = seen & (key <= pos[..., None])
        if window > 0:
            seen = seen & (key > pos[..., None] - window)
        s = s.masked_fill(~seen, float("-inf"))
        new = torch.maximum(m, s.amax(dim=-1))
        use = torch.where(new == float("-inf"), torch.zeros_like(new), new)
        corr = torch.exp2(m - use)                          # -inf -> 0
        p = torch.exp2(s - use[..., None])
        pv = torch.einsum("bkmrn,bknd->bkmrd", p.to(q.dtype).float(), vt)
        on = active[:, None]
        m = torch.where(on, new, m)
        l = torch.where(on, l * corr + p.sum(dim=-1), l)
        acc = torch.where(on[..., None], acc * corr[..., None] + pv, acc)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = o.reshape(b, kv, n_mt * BLOCK_M, dh)[:, :, :rows]
    o = o.reshape(b, kv, sq, g, dh).transpose(2, 3).reshape(b, h, sq, dh)
    return o.to(q.dtype)
