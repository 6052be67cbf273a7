"""The chip's peaks and the operations and bytes of a step and of each
kernel, counted from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM (dense rates at 700 W):
989e12 bf16 FLOP/s on the tensor cores, 3.35e12 bytes/s of HBM3.  A least
time is the larger of operations over the FLOP rate and bytes over the
byte rate; a share is that least time over the measured time.

Counting rules (each input byte read once, each output byte written once,
nothing counted twice):

- a step: every weight read once (bf16; the MoE router in float32), the
  embedding rows of its tokens, the cache entries its attention reads and
  the ones it writes, and the logits it returns; operations are 2 per
  multiply-add of the projections each token needs (an MoE token its
  ``top_k`` experts), attention's two products, and the head for the rows
  whose logits are taken.  A prefill counts its prompt's tokens, not the
  bucket it is padded to; a decode its running rows.  An MoE step counts
  every expert's weights: a decode routes all slots' tokens, live and
  stale, and 16 tokens x 4 choices leave an expert of 16 empty with
  probability (15/16)^64 = 1.6%.
- B2 (prefill attention, one launch a layer): q, k, v and the output of
  the padded bucket it is given, causal pairs within the window.
- B3 (decode attention, one launch a layer): q and the output of every
  slot, and the valid cache entries of each slot (not ``max_len``).
- B4b + B4a (one of each a MoE layer): every expert's three weights, the
  capacity buffers in, the hidden buffer written and read, the output out;
  operations for the kept assignments, at most tokens x ``top_k``.
"""
from __future__ import annotations

from typing import Sequence

from perfbench.references.transformer import capacity

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def least(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _attn_params(m: dict) -> int:
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    return d * h * dh + 2 * d * kv * dh + h * dh * d


def _ffn_params(m: dict) -> int:
    return 3 * m["d_model"] * m["d_ff"]


def weight_bytes(m: dict) -> int:
    """Every weight but the embedding table, which a step reads by rows."""
    d, L = m["d_model"], m["n_layers"]
    layer = _attn_params(m) * BF16 + 2 * d * BF16
    if m["family"] == "moe":
        layer += m["n_experts"] * _ffn_params(m) * BF16 + d * m["n_experts"] * 4
    else:
        layer += _ffn_params(m) * BF16
    return L * layer + d * BF16 + d * m["vocab"] * BF16


def token_flops(m: dict) -> int:
    """Projection operations of one token through every layer."""
    ffn = _ffn_params(m) * (m["top_k"] if m["family"] == "moe" else 1)
    router = m["d_model"] * m["n_experts"] if m["family"] == "moe" else 0
    return 2 * m["n_layers"] * (_attn_params(m) + ffn + router)


def kv_entry_bytes(m: dict) -> int:
    """One position's K and V in every layer."""
    return m["n_layers"] * 2 * m["n_kv_heads"] * m["d_head"] * BF16


def attn_flops(m: dict, keys: int) -> int:
    """QK and PV of queries that see ``keys`` keys in total, every layer."""
    return 4 * m["n_layers"] * m["n_heads"] * m["d_head"] * keys


def prefill_step(m: dict, p: int):
    """(flops, bytes) of one prompt of ``p`` tokens."""
    flops = (p * token_flops(m) + attn_flops(m, p * (p + 1) // 2)
             + 2 * m["d_model"] * m["vocab"])
    nbytes = (weight_bytes(m) + p * m["d_model"] * BF16
              + p * kv_entry_bytes(m) + m["vocab"] * BF16)
    return flops, nbytes


def decode_step(m: dict, keys: Sequence[int]):
    """(flops, bytes) of one decode of the running rows, each seeing
    ``keys[i]`` cache entries (its own new one included)."""
    r, seen = len(keys), int(sum(keys))
    flops = (r * token_flops(m) + attn_flops(m, seen)
             + 2 * r * m["d_model"] * m["vocab"])
    nbytes = (weight_bytes(m) + r * m["d_model"] * BF16
              + seen * kv_entry_bytes(m) + r * m["vocab"] * BF16)
    return flops, nbytes


def b2_launch(m: dict, bucket: int):
    """(flops, bytes) of one flash-attention launch over a bucket."""
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    w = m.get("window", 0) if m.get("attention") == "swa" else 0
    pairs = sum(min(i + 1, w) if w else i + 1 for i in range(bucket))
    flops = 4 * h * dh * pairs
    nbytes = bucket * (2 * h + 2 * kv) * dh * BF16
    return flops, nbytes


def b3_launch(m: dict, keys: Sequence[int]):
    """(flops, bytes) of one decode-attention launch over every slot."""
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    seen = int(sum(keys))
    flops = 4 * h * dh * seen
    nbytes = seen * 2 * kv * dh * BF16 + len(keys) * 2 * h * dh * BF16
    return flops, nbytes


def b4_layer(m: dict, tokens: int):
    """(flops, bytes) of B4b then B4a on one MoE layer's capacity buffers
    for ``tokens`` routed together."""
    d, f, e = m["d_model"], m["d_ff"], m["n_experts"]
    rows = e * capacity(m, tokens)
    kept = min(tokens * m["top_k"], rows)
    flops = 2 * kept * d * f * 3
    nbytes = (3 * e * d * f + rows * d * 2 + rows * f * 2) * BF16
    return flops, nbytes
