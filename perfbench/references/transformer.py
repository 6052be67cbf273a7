"""The plain reference: the dense and MoE decoder in float32 PyTorch, over
a whole serving history at once, written from the model's equations and
the serving engine's stated behaviour, with no kernel, cache or batching
of the program.  It imports nothing of the program and takes only what
the benchmark made (the weights, the prompts) and the tokens the program
returned, which it judges.

The model (pre-norm, residual): ``x = embed[token]``; per layer
``x += wo(attn(rope(wq h), rope(wk h), wv h))`` with ``h = rms(x) (1 +
w_attn_norm)``, then ``x += ffn(rms(x) (1 + w_mlp_norm))``; logits
``rms(x) (1 + w_final_norm) @ lm_head``.  RoPE rotates the two halves of a
head; attention is causal with grouped KV heads; the FFN is SwiGLU, or an
MoE layer: softmax over the router's logits, the ``top_k`` experts by
probability (ties to the lower id), their gates renormalised, and GShard's
capacity: within the tokens routed together, assignments in token order
then choice order, an expert keeps its first ``capacity`` and drops the
rest.

The history (``history.py``) gives each token its segment and position;
a token attends to the positions its slot's cache holds: under a sliding
window the ring keeps the last ``min(window, cache_len)``; under full
attention a position past the cache is written into its last entry, so
it sees ``0 .. cache_len - 2`` and itself.  Tokens routed together are a prefill's prompt
(capacity from its padded length; the padding routes after every prompt
token, so it takes no capacity from them) or one decode's slots.

Routing decisions the reference cannot settle.  The program routes from
bf16 activations, so where two experts' router logits lie within
``margin`` of the top-k boundary it may pick either, and a different pick
changes the token's output outright; through the capacity it can also
change whether a later token's assignment is kept.  ``moe`` marks such a
token as unsettled at that layer: one with an expert within ``margin`` of
the boundary, or with an assignment whose keep or drop turns on earlier
unsettled picks in its group.  ``forward`` reports, for each judged
token, whether it was unsettled at any layer; the check judges the
others.

``precision="fp8"`` is the control, the reference computed in fp8 as an
fp8 matrix product on the card takes it: every bf16 weight rounded to
float8 e4m3 with a scale per output channel (per row for the embedding),
and each projection's input rounded to e4m3 with a scale per row; the
products accumulate in float32, and the router (float32 in the
configuration), attention's own products, the norms and the softmax
stay as above.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FP8_MAX = 448.0


def fp8_round(w: torch.Tensor, in_dims: int) -> torch.Tensor:
    """``w`` (float32) rounded to float8 e4m3 with one scale per output
    channel: the amax over its first ``in_dims`` dims, for each of the
    rest."""
    shape = w.shape
    flat = w.reshape(math.prod(shape[:in_dims]), -1)
    scale = flat.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / FP8_MAX
    q = (flat / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return q.reshape(shape)


class Weights:
    """The benchmark's weights by name, read in float32 (or, for the
    control, bf16 weights rounded to fp8 first)."""

    def __init__(self, tensors: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.t = tensors
        self.precision = precision

    def __call__(self, name: str, in_dims: int = 1,
                 index: Optional[int] = None) -> torch.Tensor:
        w = self.t[name]
        if index is not None:
            w = w[index]
        lowered = self.precision == "fp8" and w.dtype == torch.bfloat16
        w = w.float()
        return fp8_round(w, in_dims) if lowered and w.dim() > 1 else w

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """A projection's input (N, k) as the product takes it: rounded to
        e4m3 with a scale per row in the control."""
        if self.precision != "fp8":
            return x
        scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.a(self.t["embed"][tokens].float())


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, heads, dh), pos (N,): the two halves rotated."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                         device=x.device) / dh)
    ang = (pos.double()[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, pos, m: dict, cache_len: int, block: int = 512):
    """One segment: q (n, H, dh), k, v (n, KV, dh) at positions ``pos``
    (0 .. n-1) -> (n, H, dh); each query sees the positions its slot's
    cache holds (module docstring)."""
    n, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, n, dh)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kp = pos[None, :]
    for lo in range(0, n, block):
        qp = pos[lo:lo + block, None]
        allowed = kp <= qp
        if m.get("attention") == "swa":
            allowed &= kp > qp - min(m["window"], cache_len)
        else:
            allowed &= (qp < cache_len) | (kp <= cache_len - 2) | (kp == qp)
        s = torch.einsum("qhd,hkd->hqk", q[lo:lo + block], k) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        out[lo:lo + block] = torch.einsum("hqk,hkd->qhd", p, v)
    return out


def capacity(m: dict, tokens: int) -> int:
    """GShard's expert capacity for ``tokens`` routed together."""
    c = int(max(m["top_k"], tokens * m["top_k"] * m["capacity_factor"]
                / m["n_experts"]))
    return max(8, (c + 127) // 128 * 128) if tokens >= 1024 else c


def _exclusive_cumsum(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per row, the sum of the rows before it in its group; ``starts``
    (N,) the index of each row's group's first row."""
    c = torch.cumsum(x, dim=0)
    c0 = torch.cat([torch.zeros_like(c[:1]), c])           # c0[i] = sum[:i]
    return c0[:-1] - c0[starts]


def moe(h, W: Weights, pre: str, m: dict, groups, margin: float,
        block: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (N, d) -> (out (N, d), unsettled (N,) bool).  ``groups``: (flat
    token indices in order, tokens routed together) covering every token;
    router logits closer than ``margin`` to the top-k boundary count as
    the program's to pick either way."""
    e, k = m["n_experts"], m["top_k"]
    dev = h.device
    logits = h @ W(f"{pre}.router")
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    tok = torch.cat([torch.as_tensor(g, dtype=torch.long) for g, _ in groups])
    lens = torch.tensor([len(g) for g, _ in groups], dtype=torch.long)
    first = torch.cumsum(lens, 0) - lens
    starts = first.repeat_interleave(lens)                 # in ``tok`` order
    gid = torch.arange(len(groups)).repeat_interleave(lens)
    cap = torch.tensor([capacity(m, t) for _, t in groups], dtype=torch.long)
    tok, starts, gid, cap = (tok.to(dev), starts.to(dev), gid.to(dev),
                             cap.to(dev))

    # the reference's own assignment ranks: earlier assignments to the
    # same expert in the group (a token's choices are distinct experts)
    chosen = torch.zeros((h.shape[0], e), dtype=torch.long, device=dev)
    chosen.scatter_(1, ids, 1)
    ch = chosen[tok]                                       # (N', E)
    rank = _exclusive_cumsum(ch, starts)
    kept = (ch > 0) & (rank < cap[gid][:, None])

    # which picks the program could make otherwise
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth, nxt = srt[:, k - 1:k], srt[:, k:k + 1]
    mine = chosen > 0
    c = cap[gid][:, None]
    sure_in = (mine & (logits - nxt >= margin))[tok].long()
    maybe = ((mine & (logits - nxt < margin))
             | (~mine & (kth - logits < margin)))[tok].long()
    lo = _exclusive_cumsum(sure_in, starts)
    hi = lo + _exclusive_cumsum(maybe, starts)
    open_keep = (ch > 0) & (lo < c) & (hi >= c)
    unsettled = torch.zeros(h.shape[0], dtype=torch.bool, device=dev)
    unsettled[tok] = (maybe > 0).any(-1) | open_keep.any(-1)

    out = torch.zeros_like(h)
    for x in range(e):
        sel = kept[:, x]
        rows = tok[sel]
        if rows.numel() == 0:
            continue
        gw = (gates * (ids == x)).sum(-1)[rows]
        wg = W(f"{pre}.w_gate", index=x)
        wu = W(f"{pre}.w_up", index=x)
        wd = W(f"{pre}.w_down", index=x)
        for a in range(0, rows.numel(), block):
            r = rows[a:a + block]
            hx = W.a(h[r])
            y = W.a(torch.nn.functional.silu(hx @ wg) * (hx @ wu)) @ wd
            out.index_add_(0, r, y * gw[a:a + block, None])
        del wg, wu, wd
    return out, unsettled


def forward(W: Weights, m: dict, cache_len: int, segments: Sequence,
            judged: np.ndarray, groups=None, margin: float = 0.0,
            device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (len(judged), vocab), unsettled (len(judged),) bool) of the
    flat tokens ``judged``.  ``segments``: token-id arrays, each at
    positions 0 .., laid out one after another in the flat order;
    ``groups`` and ``margin`` (MoE): as ``moe``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens = [len(s) for s in segments]
    starts = np.concatenate([[0], np.cumsum(lens)])
    tokens = torch.as_tensor(np.concatenate(segments), dtype=torch.long,
                             device=device)
    pos = torch.as_tensor(np.concatenate([np.arange(n) for n in lens]),
                          dtype=torch.long, device=device)
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    x = W.embed_rows(tokens)
    unsettled = torch.zeros(len(tokens), dtype=torch.bool, device=device)
    for layer in range(m["n_layers"]):
        pre = f"layers.{layer}"
        y = W.a(rms(x, W(f"{pre}.attn_norm"), eps))
        q = rope((y @ W(f"{pre}.attn.wq").reshape(d, h * dh)).view(-1, h, dh),
                 pos, theta)
        kk = rope((y @ W(f"{pre}.attn.wk").reshape(d, kv * dh)).view(-1, kv, dh),
                  pos, theta)
        vv = (y @ W(f"{pre}.attn.wv").reshape(d, kv * dh)).view(-1, kv, dh)
        del y
        o = torch.empty_like(q)
        for a, b in zip(starts[:-1], starts[1:]):
            o[a:b] = attend(q[a:b], kk[a:b], vv[a:b], pos[a:b], m, cache_len)
        del q, kk, vv
        x = x + W.a(o.reshape(-1, h * dh)) @ W(f"{pre}.attn.wo", 2).reshape(
            h * dh, d)
        del o
        y = rms(x, W(f"{pre}.mlp_norm"), eps)
        if m["family"] == "moe":
            out, un = moe(y, W, f"{pre}.moe", m, groups, margin)
            x = x + out
            unsettled |= un
            del out
        else:
            ya = W.a(y)
            g = torch.nn.functional.silu(ya @ W(f"{pre}.mlp.w_gate"))
            x = x + W.a(g * (ya @ W(f"{pre}.mlp.w_up"))) @ W(f"{pre}.mlp.w_down")
            del ya
            del g
        del y
    sel = torch.as_tensor(judged, dtype=torch.long, device=device)
    xf = rms(x[sel], W("final_norm"), eps)
    return W.a(xf) @ W("lm_head")[:, :m["vocab"]], unsettled[sel]

