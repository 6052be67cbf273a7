"""Plain versions of the decode-attention kernel: masked softmax attention of
one query token per sequence, in float32 (port of
``repro/kernels/decode_attn/ref.py``), under either of the kernel's two
masks, and the kernel's own algorithm (packed rows, key splits, merges)
in plain PyTorch.

The two masks:

- ``lengths`` (B,): key j takes part when ``j < lengths[b]`` (the TPU
  kernel's contract; a full-attention cache filled in order);
- ``kv_pos`` (B, S) with ``pos`` (B,) or a scalar: slot j takes part when
  ``0 <= kv_pos[b, j] <= pos[b]`` (a ring cache, as the reference's
  ``models/layers.decode_attention`` masks it).

A row with no valid key gives 0 under both, as the kernel's ``max(l,
1e-30)`` denominator does (the reference's plain version gives NaN there).
With ``return_lse`` each also returns the rows' log-sum-exp of the scaled
scores over the valid keys, float32 (B, H), -inf for a row with none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# a split's keys are a multiple of this (the bf16 kernel's K/V tile)
SPLIT_KEYS = 64
# the query rows of one block: a KV head's G query heads, padded
BLOCK_ROWS = 16
# the H100's streaming multiprocessors
H100_SMS = 132
# the most splits the kernel's merge takes
MAX_SPLITS = 1024


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, return_lse: bool = False):
    """q (B, H, dh); k, v (B, KV, S, dh); lengths (B,) -> (B, H, dh) in q's
    dtype.  Query head h reads KV head h // (H / KV); key j takes part when
    ``j < lengths[b]``."""
    s = k.shape[2]
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                       # (B, S)
    return _masked(q, k, v, mask, return_lse)


def decode_attention_kv_pos_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, kv_pos: torch.Tensor,
                                pos: torch.Tensor, return_lse: bool = False):
    """q (B, H, dh); k, v (B, KV, S, dh); kv_pos (B, S) absolute positions,
    -1 for an empty slot; pos (B,) or a scalar, the query's position ->
    (B, H, dh) in q's dtype.  Slot j takes part when ``0 <= kv_pos[b, j]
    <= pos[b]``."""
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device),
                             (q.shape[0],))
    mask = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    return _masked(q, k, v, mask, return_lse)


def _masked(q, k, v, mask, return_lse=False):
    b, h, dh = q.shape
    kv = k.shape[1]
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) / math.sqrt(dh)
    mask = mask[:, None, :]                                        # (B, 1, S)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    o = torch.einsum("bhs,bhsd->bhd", p, v.float()).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(scores, dim=-1)         # -inf: no valid key


def decode_attn_plain(q, k, v, lengths=None, *, kv_pos=None, pos=None,
                      return_lse: bool = False):
    """The plain version behind ``ops.decode_attn``'s signature: one of the
    two masks."""
    if lengths is not None:
        return decode_attention_ref(q, k, v, lengths, return_lse)
    return decode_attention_kv_pos_ref(q, k, v, kv_pos, pos, return_lse)


def split_plan(s: int, blocks: int, n_sm: int = H100_SMS) -> Tuple[int, int]:
    """How the kernel cuts S keys across blocks: (splits, keys per split).

    ``blocks`` is B x KV x ceil(G/16), the blocks of one split, and
    ``n_sm`` the card's SM count.  As many splits as give two blocks per
    SM, each of at least two 64-key tiles, so the serving cache of 192
    takes one split (no merge launch).  The plan depends on shapes only,
    never on the lengths: a captured CUDA graph stays valid while they
    change.  Keys per split are whole tiles, and the last split is the
    shorter one; no split is empty."""
    tiles = max(1, -(-s // SPLIT_KEYS))
    splits = min(-(-2 * n_sm // max(blocks, 1)), tiles // 2, MAX_SPLITS)
    per = -(-tiles // max(1, splits)) * SPLIT_KEYS
    return max(1, -(-s // per)), per


def _online(sc, vf, chunk, streams, bf16):
    """One split's keys in order: sc (B, KV, G, n) scores in log2 units,
    -inf where masked; vf (B, KV, n, dh).  Chunk c of ``chunk`` keys goes to
    stream c % streams (the bf16 kernel's key groups); each stream runs its own
    online softmax; the streams are merged in order.  Returns (m, l, acc)."""
    n = sc.shape[-1]
    states = []
    for w in range(streams):
        m = sc.new_full(sc.shape[:-1], float("-inf"))
        l = sc.new_zeros(sc.shape[:-1])
        acc = sc.new_zeros(sc.shape[:-1] + vf.shape[-1:])
        for c0 in range(w * chunk, n, streams * chunk):
            s_c = sc[..., c0:c0 + chunk]
            m_new = torch.maximum(m, s_c.amax(dim=-1))
            base = torch.where(m_new == float("-inf"), 0.0, m_new)
            corr = torch.exp2(m - base)
            p = torch.exp2(s_c - base[..., None])
            l = l * corr + p.sum(dim=-1)
            if bf16:                      # P V on the tensor cores
                p = p.bfloat16().float()
            acc = acc * corr[..., None] + torch.einsum(
                "bkgj,bkjd->bkgd", p, vf[:, :, c0:c0 + chunk])
            m = m_new
        states.append((m, l, acc))
    return _merge(states)


def _merge(states):
    """(m, l, acc) states merged in order, as the kernel merges key groups and
    splits: a state with m = -inf adds nothing."""
    big = states[0][0]
    for m, _, _ in states[1:]:
        big = torch.maximum(big, m)
    l_sum = torch.zeros_like(big)
    acc_sum = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.where((m == float("-inf")) | (big == float("-inf")), 0.0,
                        torch.exp2(m - big))
        l_sum = l_sum + l * f
        acc_sum = acc_sum + acc * f[..., None]
    return big, l_sum, acc_sum


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None, *,
                               kv_pos: Optional[torch.Tensor] = None,
                               pos=None, n_sm: int = H100_SMS,
                               return_lse: bool = False):
    """The kernel's algorithm in plain PyTorch, under either mask: the G
    query heads of a KV head as one block's rows; the keys cut by
    ``split_plan`` for a card of ``n_sm`` SMs; per split, in bf16 four
    streams of 16-key chunks (the key groups, each with its own online
    softmax, P rounded to bf16 for P V, l over the float32 p) merged in
    order, in float32 one stream of 8-key steps; the splits merged in
    split order; scores in log2 units.  A split wholly past a length
    contributes m = -inf.  Returns (B, H, dh) in q's dtype; with
    ``return_lse``, also the rows' log-sum-exp (B, H) from the merged
    (m, l): ``m ln 2 + ln l``, -inf where l = 0."""
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    bf16 = q.dtype == torch.bfloat16
    n, per = split_plan(s, b * kv * -(-g // BLOCK_ROWS), n_sm)
    if lengths is not None:
        limit = lengths.long().clamp(0, s)
        valid = torch.arange(s, device=q.device)[None, :] < limit[:, None]
    else:
        pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device), (b,))
        valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    scale_log2 = math.log2(math.e) / math.sqrt(dh)
    qf = q.float().reshape(b, kv, g, dh)
    sc = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) * scale_log2
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    vf = v.float()
    chunk, streams = (16, 4) if bf16 else (8, 1)
    states = [_online(sc[..., j0:j0 + per], vf[:, :, j0:j0 + per], chunk,
                      streams, bf16)
              for j0 in range(0, n * per, per)]
    big, l_sum, acc_sum = _merge(states)
    out = acc_sum / l_sum.clamp(min=1e-30)[..., None]
    out = out.reshape(b, h, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l_sum > 0, big * math.log(2.0) + torch.log(l_sum),
                      float("-inf"))
    return out, lse.reshape(b, h)


def merge_partials(outs, lses) -> torch.Tensor:
    """Partial decode outputs over disjoint parts of one cache merged into
    the output over all of it (flash-decoding): ``outs`` (each (B, H, dh),
    normalised over its part) and their log-sum-exps ``lses`` (each (B,
    H)), merged with weights ``exp(lse - max)``, in float32, the result in
    the outputs' dtype.  A part with no valid key (lse -inf) adds nothing;
    where no part has one the result is 0, as a cache with no valid key
    gives.  ``distributed.collectives.softmax_merge`` is this over the
    ranks of ``model``."""
    big = torch.stack(lses).amax(0)
    base = torch.where(big == float("-inf"), 0.0, big)
    num = den = 0.0
    for o, lse in zip(outs, lses):
        w = torch.exp(lse - base)
        num = num + o.float() * w[..., None]
        den = den + w
    return merge_quotient(num, den).to(outs[0].dtype)


def merge_quotient(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The merged output from the weighted sums: ``num / den``, 0 where
    ``den`` is 0 (no part had a valid key)."""
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None], 0.0)
