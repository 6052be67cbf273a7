"""RecurrentGemma (Griffin), the ``hybrid`` family (port of
``repro/models/rglru.py``): RG-LRU recurrent blocks and local attention in
the pattern (rec, rec, attn).

  recurrent block:  x -> {linear -> causal depthwise conv1d -> RG-LRU}
                         ⊙ gelu(linear gate) -> linear out
  RG-LRU:  r_t = σ(x W_r), i_t = σ(x W_i), a_t = exp(-c softplus(Λ) r_t),
           h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)      (c = 8)
  attention block:  MQA local attention within ``cfg.window``, RoPE.

Whole sequences served (forward, prefill) run the recurrence through
kernel B6 (``kernels/rglru_scan/ops.py lru``), once per recurrent layer; a
decode step computes its one step in plain PyTorch, as the reference
computes it in XLA.  The training forward (``forward(..., train=True)``)
runs the recurrence as the reference trains it, a log-depth scan of
``(a, b)`` pairs in float32 (``rg_lru_scan_train``: Hillis-Steele where the
reference's ``associative_scan`` pairs odd and even steps) in plain
PyTorch under autograd on any device (B6 has a backward in neither
package and refuses a gradient); with gradients asked under
``cfg.remat`` each (rec, rec, attn) superblock and each tail layer is
recomputed in the backward (the reference's ``jax.checkpoint``), and the
training forward writes no state.  The local attention of whole
sequences is plain PyTorch, as the reference's XLA
``blockwise_attention``; a decode step's attention over the ring goes
through the decode-attention kernel (``kernels/decode_attn``) under its
``kv_pos`` mask.

``RecurrentGemma.layers`` holds one module per layer in execution order:
superblock i's (rec1, rec2, attn) are layers 3i, 3i+1, 3i+2, the tail's
recurrent layers follow.  The serving cache is ``{"layers": [...], "pos":
scalar}`` with, per layer, ``{"h" (B, r) float32, "conv" (B, cw-1, r)}``
(recurrent) or a ring ``{"k", "v" (B, W, KV, dh), "kv_pos" (B, W)}``
(attention), W = min(window, max_len); ``decode_step`` updates it in place,
``pos`` included, and returns the same dict.  The batch shares one
``pos``, so prefill takes equal-length prompts.

Under a ``MeshPolicy`` whose ``model`` axis is larger than 1 a layer
computes Megatron-style on this rank's blocks (``models.io.ShardedLM``):

  * the recurrent block on the rank's ``rnn/m`` channels: ``w_x`` and
    ``w_gate`` column-parallel and the causal conv on its channels; the
    gates' ``w_r``/``w_i`` are dense (rnn, rnn) products, column-parallel,
    so the conv output is gathered whole over ``model`` once a layer
    (B × T × rnn float32, reader ``"tp_gather"``); B6 (or the decode's
    step) on its channels, so ``h`` is (B, rnn/m) and ``conv`` (B, cw-1,
    rnn/m); ``w_out`` row-parallel, its partial output summed over
    ``model`` (reader ``"tp_sum"``);
  * the GeGLU MLP column- and row-parallel;
  * the local attention on the rank's ``H/m`` query heads with ``wo``
    row-parallel where the heads divide, else every head on every rank
    (``wq``, ``wo`` whole, the output whole and not summed); the one KV
    head whole, and the ring split by sequence where ``W`` divides: rank
    ``r`` holds slots ``[r W/m, (r+1) W/m)`` of K/V and ``kv_pos`` whole
    (``sharding.serve_cache_spec``).  Prefill runs the plain local
    attention as without a mesh and keeps the rank's slots; a decode
    step writes the token's K/V on the rank that owns slot ``pos % W``
    (the same rank for every row: the batch shares ``pos``), gathers
    ``q`` over ``model`` where the heads are split, runs the
    decode-attention kernel for every head over its slots with the
    log-sum-exp, merges the ranks' partial softmaxes
    (``collectives.softmax_merge``) and keeps its heads.

The embedding and the logits are vocab-parallel
(``transformer.embed_body``, ``unembed``).  Each rank's part is a
function of its blocks (``rec_in_body`` then ``rec_out_body`` around the
gather, ``attention_full_body``, ``decode_query``/``ring_attend``/
``attention_out`` around the decode's collectives, ``mlp_body``), so one
process can run every rank's.

The training forward computes on the same blocks, which training also
splits over the data axes (``sharding.block_spec``; each gathered at its
use, ``collectives.at_use``): each split layer takes its input's
gradient summed over ``model``, the conv output's gather is an autograd
collective whose backward reduce-scatters the ranks' partial gradients
into each rank's channels (``collectives.model_gather``), the one KV
head's ``wk``/``wv`` take their gradient summed over ``model`` where
the query heads split, and the RG-LRU runs ``rg_lru_scan_train`` on the
rank's channels from zero states of its width.  Under ``cfg.remat`` each
superblock and tail layer is recomputed with its collectives.
``cfg.seq_parallel`` is the transformer's: RecurrentGemma computes whole
sequences with the flag set, which is the same function.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import generator, resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import current_policy, model_parallel
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.rglru_scan.ops import lru
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import (MLP, own_heads, seq_part,
                                            split_input, split_layer,
                                            split_output, unembed,
                                            write_owned)

_C = 8.0                                   # RG-LRU temperature
PATTERN = ("rec", "rec", "attn")
REC = ("w_x", "w_gate", "conv_w", "conv_b", "w_r", "b_r", "w_i", "b_i",
       "lam", "w_out")
ATTN = ("wq", "wk", "wv", "wo")
MLP_NAMES = ("w_gate", "w_up", "w_down")
CHANNELS = (None, None, "model")           # a (B, T, rnn) activation's split


class RecLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, r, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
        p = lambda *shape, dt=dtype: layers.param(*shape, dtype=dt,
                                                  device=device)
        self.norm1, self.norm2 = p(d), p(d)
        self.w_x, self.w_gate = p(d, r), p(d, r)
        self.conv_w, self.conv_b = p(cw, r), p(r)
        self.w_r, self.b_r = p(r, r), p(r)
        self.w_i, self.b_i = p(r, r), p(r)
        self.lam = p(r, dt=torch.float32)  # float32 in a bf16 model too
        self.w_out = p(r, d)
        self.mlp = MLP(cfg, dtype, device)


class AttnLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        p = lambda *shape: layers.param(*shape, dtype=dtype, device=device)
        self.norm1, self.norm2 = p(d), p(d)
        self.wq, self.wk, self.wv = p(d, h, dh), p(d, kv, dh), p(d, kv, dh)
        self.wo = p(h, dh, d)
        self.mlp = MLP(cfg, dtype, device)


def layer_kinds(cfg) -> List[str]:
    """Each layer's kind in execution order: (rec, rec, attn) per
    superblock, then the tail's recurrent layers."""
    if tuple(cfg.block_pattern) != PATTERN:
        raise ValueError(f"{cfg.name}: block pattern {cfg.block_pattern} is "
                         f"not {PATTERN}")
    n_super = cfg.n_layers // len(PATTERN)
    return list(PATTERN) * n_super + ["rec"] * (cfg.n_layers - 3 * n_super)


class RecurrentGemma(nn.Module):
    """The parameters of one RecurrentGemma LM, uninitialised
    (``init_params`` draws them, ``io.lm_params_from_numpy`` copies the
    reference's)."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not hybrid")
        dtype = getattr(torch, cfg.param_dtype)
        d, vp = cfg.d_model, cfg.vocab_padded
        self.embed = layers.param(vp, d, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            (RecLayer if kind == "rec" else AttnLayer)(cfg, dtype, device)
            for kind in layer_kinds(cfg))
        self.final_norm = layers.param(d, dtype=dtype, device=device)
        self.lm_head = layers.param(d, vp, dtype=dtype, device=device)


def init_params(cfg, seed: int = 0, device=None) -> RecurrentGemma:
    """Random weights with the reference's distributions
    (``rglru.py:36-113``): projections normal with std ``1/sqrt(fan-in)``,
    ``w_out``, ``wo`` and the MLPs' ``w_down`` scaled by ``1/sqrt(2
    n_layers)``; ``conv_w`` at 0.1; ``lam`` uniform in [0.4, 0.9), kept in
    float32; embeddings 0.02; norms and biases 0.  From a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (CUDA by
    default)."""
    dev = resolve(device)
    model = RecurrentGemma(cfg, dev)
    gen = generator(dev, seed)
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embed":
            p.copy_(layers.embed_init(p.shape, gen))
        elif leaf in ("w_out", "wo", "w_down"):
            p.copy_(layers.dense_init(p.shape, gen, scale=out_scale))
        elif leaf in ("w_x", "w_gate", "w_r", "w_i", "w_up", "wq", "wk", "wv",
                      "lm_head"):
            p.copy_(layers.dense_init(p.shape, gen))
        elif leaf == "conv_w":
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)
        elif leaf == "lam":
            p.copy_(torch.rand(p.shape, generator=gen, device=dev) * 0.5 + 0.4)
        else:                                   # norms and biases
            p.zero_()
    return model


# ---------------------------------------------------------------------------
# RG-LRU and conv
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b, conv_state):
    """Depthwise causal conv: x (B, T, r), w (cw, r), conv_state (B, cw-1,
    r) -> (out (B, T, r), the new state: the last cw-1 inputs)."""
    cw, n = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state, x], dim=1)
    out = sum(xp[:, i:i + n] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else conv_state
    return out + b, new_state


def _log_a(lam, r_gate):
    return -_C * F.softplus(lam) * r_gate              # <= 0


def _gated(a, i_gate, x):
    """sqrt(1 - a²) (clipped to [1e-9, 1]) times the input gate's share."""
    return torch.sqrt(torch.clamp(1.0 - torch.square(a), 1e-9, 1.0)) * (
        i_gate * x)


def rg_lru_scan(x, r_gate, i_gate, lam, h0):
    """x, gates (B, T, r) float32; h0 (B, r) -> (h (B, T, r), h_last).  The
    recurrence is kernel B6, which starts from ``h0`` (the reference folds
    h0 into step 0 instead: the same function)."""
    log_a = _log_a(lam, r_gate)
    h = lru(log_a, _gated(torch.exp(log_a), i_gate, x), h0)
    return h, h[:, -1]


def rg_lru_scan_train(x, r_gate, i_gate, lam, h0):
    """The reference's training ``rg_lru_scan`` (``rglru.py:130-144``),
    differentiable: x, gates (B, T, r) float32; h0 (B, r) -> (h (B, T, r),
    h_last).  h0 is folded into step 0's ``b``, and ``h_t = a_t h_{t-1} +
    b_t`` is a scan of the pairs ``(a, b)`` under ``(a1, b1) ∘ (a2, b2) =
    (a1 a2, a2 b1 + b2)`` in ``ceil(log2 T)`` rounds, round j combining
    each step with the one ``2^j`` before it (Hillis-Steele)."""
    log_a = _log_a(lam, r_gate)
    a = torch.exp(log_a)
    b = _gated(a, i_gate, x)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    off = 1
    while off < b.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b, b[:, -1]


def rec_in_body(w, cfg, x, conv_state):
    """A model rank's recurrent block up to its conv, on its blocks ``w``
    (``w_x``/``w_gate (d, rnn/m)``, ``conv_w``/``conv_b`` its channels;
    whole at m = 1): x (B, T, d), ``conv_state`` (B, cw-1, rnn/m) ->
    (the conv output (B, T, rnn/m) in float32, the GELU gate (B, T,
    rnn/m), the new conv state)."""
    bx = torch.einsum("btd,dr->btr", x, w.w_x)
    gate = F.gelu(torch.einsum("btd,dr->btr", x, w.w_gate), approximate="tanh")
    bx, conv_state = causal_conv1d(bx, w.conv_w, w.conv_b, conv_state)
    return bx.float(), gate, conv_state


def rec_out_body(w, cfg, bx_all, gate, h0, m_idx: int = 0, *,
                 single: bool, train: bool = False):
    """The rest of a model rank's recurrent block: ``bx_all`` (B, T, rnn)
    float32, every rank's conv output side by side (the gates' ``w_r``,
    ``w_i (rnn, rnn/m)`` read all of it); the RG-LRU on its channels from
    ``h0`` (B, rnn/m) (B6 over a whole sequence, ``rg_lru_scan_train``
    when ``train``, one step when ``single``); ``w_out (rnn/m, d)`` ->
    (its partial output (B, T, d), which the model ranks sum, its last
    state (B, rnn/m))."""
    n = w.lam.shape[0]
    bx32 = bx_all.narrow(2, m_idx * n, n)
    r_gate = torch.sigmoid(torch.einsum("btr,rs->bts", bx_all, w.w_r.float())
                           + w.b_r.float())
    i_gate = torch.sigmoid(torch.einsum("btr,rs->bts", bx_all, w.w_i.float())
                           + w.b_i.float())
    if single:
        a = torch.exp(_log_a(w.lam, r_gate))
        h = a * h0[:, None] + _gated(a, i_gate, bx32)
        h_last = h[:, -1]
    else:
        scan = rg_lru_scan_train if train else rg_lru_scan
        h, h_last = scan(bx32, r_gate, i_gate, w.lam, h0)
    return (torch.einsum("btr,rd->btd", h.to(gate.dtype) * gate, w.w_out),
            h_last)


def rec_block(p: RecLayer, cfg, x, st: dict, *, single: bool,
              train: bool = False):
    """The temporal-mixing recurrent block: x (B, T, d); ``st`` {h, conv}
    is updated in place, but in the training forward (``train``), which
    reads the zero state and writes nothing (a recomputed layer would
    write twice).  Under the split the conv output is gathered over
    ``model`` between ``rec_in_body`` and ``rec_out_body`` and the
    partial outputs summed."""
    w = collectives.layer_weights(p, REC)
    tp = split_layer(w.lam.shape[0] != cfg.rnn_width)
    bx32, gate, conv_state = rec_in_body(w, cfg, split_input(x, tp),
                                         st["conv"])
    bx_all = bx32 if tp is None else collectives.model_gather(
        bx32, CHANNELS, tp[0])
    out, h_last = rec_out_body(w, cfg, bx_all, gate, st["h"],
                               0 if tp is None else tp[2], single=single,
                               train=train)
    if not train:
        st["h"].copy_(h_last)
        st["conv"].copy_(conv_state)
    return split_output(out, tp)


def _qkv(p: AttnLayer, cfg, x, positions):
    """x (B, S, d) -> q (B, S, H, dh), k/v (B, S, KV, dh) with RoPE."""
    q = torch.einsum("bsd,dhe->bshe", x, p.wq)
    k = torch.einsum("bsd,dke->bske", x, p.wk)
    v = torch.einsum("bsd,dke->bske", x, p.wv)
    q = layers.apply_rope(q.transpose(1, 2), positions[:, None, :],
                          cfg.rope_theta).transpose(1, 2)
    k = layers.apply_rope(k.transpose(1, 2), positions[:, None, :],
                          cfg.rope_theta).transpose(1, 2)
    return q, k, v


def mlp_body(w, x):
    """A model rank's part of the GeGLU MLP on its blocks (``w_gate``/
    ``w_up (d, f/m)``, ``w_down (f/m, d)``): its partial output."""
    return layers.geglu(x, w.w_gate, w.w_up, w.w_down)


def _mlp(p: MLP, cfg, x):
    w = collectives.layer_weights(p, MLP_NAMES)
    tp = split_layer(w.w_gate.shape[1] != cfg.d_ff)
    return split_output(mlp_body(w, split_input(x, tp)), tp)


def rec_layer(p: RecLayer, cfg, x, st, *, single: bool,
              train: bool = False):
    x = x + rec_block(p, cfg, layers.rms_norm(x, p.norm1, cfg.norm_eps), st,
                      single=single, train=train)
    return x + _mlp(p.mlp, cfg, layers.rms_norm(x, p.norm2, cfg.norm_eps))


def attention_weights(p: AttnLayer, cfg):
    """(``p``'s weights as the layer computes with them, the split's
    ``(mesh, m, index)`` where ``model`` splits the query heads, else
    None).  The KV heads must be whole: RecurrentGemma's one KV head never
    divides ``model``.  Under the split ``wk``/``wv`` take their gradient
    summed over ``model``: each rank's query heads read them in part."""
    w = collectives.layer_weights(p, ATTN)
    if w.wk.shape[1] != cfg.n_kv_heads:
        raise NotImplementedError(
            f"{cfg.name}: the local attention on a mesh takes its KV heads "
            "whole (one KV head); a KV split over model is not ported")
    tp = split_layer(w.wq.shape[1] != cfg.n_heads)
    if tp is not None:
        w.wk, w.wv = split_input(w.wk, tp), split_input(w.wv, tp)
    return w, tp


def attention_full_body(w, cfg, x, positions):
    """A model rank's local attention over whole sequences on its blocks
    ``w`` (``wq (d, H/m, dh)``, ``wo (H/m, dh, d)``; the KV whole; every
    head where ``model`` does not split them): (its partial output (B, S,
    d), k, v (B, S, KV, dh))."""
    q, k, v = _qkv(w, cfg, x, positions)
    o = layers.local_attention(q, k, v, window=cfg.window)
    return torch.einsum("bshe,hed->bsd", o, w.wo), k, v


def attn_layer_full(p: AttnLayer, cfg, x, positions):
    """Whole sequences: returns (x, k, v)."""
    w, tp = attention_weights(p, cfg)
    out, k, v = attention_full_body(
        w, cfg, split_input(layers.rms_norm(x, p.norm1, cfg.norm_eps), tp),
        positions)
    x = x + split_output(out, tp)
    return x + _mlp(p.mlp, cfg, layers.rms_norm(x, p.norm2, cfg.norm_eps)), k, v


def decode_query(w, cfg, x, pos):
    """One token's q (B, H held, dh) and k, v (B, KV, dh) with RoPE at the
    shared position ``pos`` (a scalar), on blocks ``w``."""
    b = x.shape[0]
    q, k, v = _qkv(w, cfg, x, pos.reshape(1, 1).expand(b, 1))
    return q[:, 0].contiguous(), k[:, 0], v[:, 0]


def ring_attend(q, st: dict, pos, lo: int):
    """A rank's decode over its ring slots ``lo ..`` (``st["k"]``,
    ``st["v"]`` (B, W/m, KV, dh); ``st["kv_pos"]`` (B, W) whole), for every
    query head of ``q`` (B, H, dh): (output (B, H, dh), log-sum-exp (B,
    H)), which ``collectives.softmax_merge`` merges over the ranks."""
    return transformer.seq_attend(q, st["k"], st["v"], lo,
                                  kv_pos=st["kv_pos"], pos=pos)


def attention_out(w, o):
    """A rank's heads of the decode's merged output through its ``wo``:
    its partial output (B, d)."""
    return torch.einsum("bhe,hed->bd", o, w.wo)


def attn_layer_decode(p: AttnLayer, cfg, x, pos, st: dict):
    """One token against the ring cache ``st``, written in place at slot
    ``pos % W`` before attending; under the sequence split, on the rank
    that owns the slot, and the ranks' partial softmaxes merged (module
    docstring)."""
    b, w_all = x.shape[0], st["kv_pos"].shape[1]
    w, tp = attention_weights(p, cfg)
    slot = (pos % w_all).long().reshape(1)
    q, k, v = decode_query(w, cfg, split_input(
        layers.rms_norm(x, p.norm1, cfg.norm_eps), tp), pos)
    st["kv_pos"].index_copy_(1, slot, pos.reshape(1, 1).expand(b, 1))
    n = st["k"].shape[1]
    if n == w_all:
        st["k"].index_copy_(1, slot, k[:, None])
        st["v"].index_copy_(1, slot, v[:, None])
        o = decode_attn(q, st["k"].transpose(1, 2), st["v"].transpose(1, 2),
                        kv_pos=st["kv_pos"], pos=pos)
    else:                                     # the ring split by sequence
        mesh, _, idx = model_parallel(current_policy())
        write_owned(st["k"], st["v"], k, v, slot[0], idx * n)
        q_all = q if tp is None else collectives.gather_heads(q, mesh)
        o, lse = ring_attend(q_all, st, pos, idx * n)
        o = own_heads(collectives.softmax_merge(o, lse, mesh), q.shape[1],
                      idx)
    x = x + split_output(attention_out(w, o), tp)[:, None]
    return x + _mlp(p.mlp, cfg, layers.rms_norm(x, p.norm2, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Cache and full model
# ---------------------------------------------------------------------------


def _rec_state(cfg, batch, dev, mesh):
    dtype = getattr(torch, cfg.compute_dtype)
    shape = lambda name, *s: sharding.serve_cache_shape(name, s, mesh)
    return {"h": torch.zeros(shape("h", batch, cfg.rnn_width),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros(shape("conv", batch, cfg.conv_width - 1,
                                      cfg.rnn_width),
                                dtype=dtype, device=dev)}


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """The zero cache; under a mesh policy each tensor the rank's part
    (``sharding.serve_cache_spec``; ``kv_pos`` whole)."""
    dev = resolve(device)
    w = min(cfg.window, max_len)
    dtype = getattr(torch, cfg.compute_dtype)
    policy = current_policy()
    mesh = policy.mesh if policy is not None else None
    kv_shape = sharding.serve_cache_shape(
        "k", (batch, w, cfg.n_kv_heads, cfg.d_head), mesh)
    return {"layers": [
        _rec_state(cfg, batch, dev, mesh) if kind == "rec" else
        {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
         "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
         "kv_pos": torch.full((batch, w), -1, dtype=torch.int32, device=dev)}
        for kind in layer_kinds(cfg)],
        "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _embed(params: RecurrentGemma, cfg, tokens, train: bool = False):
    x = transformer._embed(params, cfg, tokens, train)
    # gemma's scaling, the factor rounded to x's dtype first (50.5 in bf16
    # at d = 2560, not 50.596)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _run_full(params: RecurrentGemma, cfg, tokens, cache):
    """forward and prefill: every layer over the whole sequence, recurrent
    states into ``cache`` in place; returns (x, [(k, v) per attention
    layer])."""
    b, n = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(n, dtype=torch.int32,
                             device=x.device)[None].expand(b, n)
    kvs = []
    for p, st in zip(params.layers, cache["layers"]):
        if isinstance(p, RecLayer):
            x = rec_layer(p, cfg, x, st, single=False)
        else:
            x, k, v = attn_layer_full(p, cfg, x, positions)
            kvs.append((k, v))
    return layers.rms_norm(x, params.final_norm, cfg.norm_eps), kvs


def train_groups(cfg) -> List[List[int]]:
    """The layers the training forward recomputes together under
    ``cfg.remat``, as the reference checkpoints its scan bodies: each
    superblock's (rec, rec, attn), then each tail layer alone."""
    n_super = cfg.n_layers // len(PATTERN)
    return ([[3 * i, 3 * i + 1, 3 * i + 2] for i in range(n_super)]
            + [[j] for j in range(3 * n_super, cfg.n_layers)])


def _train_group(params: RecurrentGemma, cfg, idx, states, positions, x):
    for i in idx:
        p = params.layers[i]
        if isinstance(p, RecLayer):
            x = rec_layer(p, cfg, x, states[i], single=False, train=True)
        else:
            x = attn_layer_full(p, cfg, x, positions)[0]
    return x


def forward(params: RecurrentGemma, cfg, tokens: torch.Tensor,
            train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, Vp), aux loss 0); ``train`` is the
    training forward (module docstring), from the zero recurrent states."""
    b, n = tokens.shape
    dev = params.embed.device
    if not train:
        cache = init_cache(cfg, b, cfg.window, dev)
        x, _ = _run_full(params, cfg, tokens, cache)
        return unembed(params, cfg, x), torch.zeros((), device=x.device)
    x = _embed(params, cfg, tokens, train=True)
    positions = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(
        b, n)
    policy = current_policy()
    mesh = policy.mesh if policy is not None else None
    states = [_rec_state(cfg, b, dev, mesh) if kind == "rec" else None
              for kind in layer_kinds(cfg)]
    remat = cfg.remat and torch.is_grad_enabled()
    for idx in train_groups(cfg):
        group = functools.partial(_train_group, params, cfg, idx, states,
                                  positions)
        x = (checkpoint(group, x, use_reentrant=False,
                        preserve_rng_state=False) if remat else group(x))
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params: RecurrentGemma, cfg, tokens: torch.Tensor, max_len: int
            ) -> Tuple[torch.Tensor, dict]:
    """tokens (B, T), equal-length prompts -> (next-token logits (B, Vp),
    the cache, ``pos = T``).  Each ring keeps the last W positions at slot
    ``p % W`` (``rglru.py:323-338``); a prompt shorter than W leaves the
    rest empty (-1).  Under the sequence split a rank keeps its slots of
    K/V and ``kv_pos`` whole."""
    b, n = tokens.shape
    cache = init_cache(cfg, b, max_len, params.embed.device)
    x, kvs = _run_full(params, cfg, tokens, cache)
    dev = x.device
    w = min(cfg.window, max_len)
    if n >= w:
        kept = torch.arange(n - w, n, dtype=torch.int32, device=dev)
        order = torch.argsort(kept % w)
    else:
        kept = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                          torch.full((w - n,), -1, dtype=torch.int32,
                                     device=dev)])
        order = torch.arange(w, device=dev)
    attn = [st for st in cache["layers"] if "kv_pos" in st]
    part = seq_part(cfg.n_kv_heads, w)
    for st, (k, v) in zip(attn, kvs):
        for name, t in (("k", k), ("v", v)):
            t = t[:, -w:] if n >= w else F.pad(t, (0, 0, 0, 0, 0, w - n))
            t = t[:, order]
            st[name] = t if part is None else t.narrow(1, *part).contiguous()
        st["kv_pos"] = kept[order][None].expand(b, w).contiguous()
    cache["pos"] = torch.full((), n, dtype=torch.int32, device=dev)
    return unembed(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params: RecurrentGemma, cfg, cache: dict, token: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """token (B,): one step; updates ``cache`` in place and returns
    (logits (B, Vp), cache)."""
    pos = cache["pos"]
    x = _embed(params, cfg, token)[:, None]
    for p, st in zip(params.layers, cache["layers"]):
        if isinstance(p, RecLayer):
            x = rec_layer(p, cfg, x, st, single=True)
        else:
            x = attn_layer_decode(p, cfg, x, pos, st)
    cache["pos"].add_(1)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], cache
