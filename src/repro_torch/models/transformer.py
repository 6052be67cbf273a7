"""Decoder-only transformer LM, dense and MoE families (port of
``repro/models/transformer.py``: starcoder2, granite, h2o-danube, qwen1.5,
chameleon, dbrx, kimi-k2).

Parameters live in ``nn.Module``s with the reference's names and shapes
(``wq (d, H, dh)``, ``wo (H, dh, d)``, ...), one ``Block`` per layer where
the reference stacks layers on a leading axis and scans them; the
functions keep the reference's names and contracts.  ``Transformer.layers``
is in execution order: an MoE model's ``n_dense_layers`` dense blocks
first, then its MoE blocks (the reference's ``dense_layers`` and
``moe_layers`` stacks), which is also the cache's layer order.  An MoE
block's FFN is ``models/moe.py`` (the grouped expert kernels B4b, B4a).

Serving (``prefill``, ``decode_step``, and ``forward`` by default) takes
the kernels: prefill attention always goes through the flash-attention
kernel (``kernels/flash_attn/ops.py``), the reference's
``attn_impl="pallas"`` path.  Training asks for ``forward(..., train=
True)``, the reference's training forward: attention follows
``cfg.attn_impl`` (``"xla"``, every config's default, is
``layers.blockwise_attention`` in plain PyTorch under autograd;
``"pallas"`` is the flash kernel, which has no backward in either
package, so asking for gradients through it raises), and an MoE layer's
expert FFN is the reference's einsums (``moe.moe_block(..., train=True)``).
Parameters take gradients only there; under ``cfg.remat`` (every
config's default) each layer is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), its
collectives with it.  Decode attention always goes through the
decode-attention kernel (``kernels/decode_attn/ops.py``), with its mask
chosen by the configuration, here and nowhere else (``Block.decode``):
under full attention ``lengths = min(pos+1, S)``, because such a cache is
filled in order (see ``decode_step``); under a sliding window the ring
cache is not a prefix of positions, so the kernel masks it by
``kv_pos``, as the reference's plain ``decode_attention`` does.

Under a ``MeshPolicy`` whose ``model`` axis is larger than 1 a layer
computes Megatron-style on this rank's blocks (``models.io.ShardedLM``):
attention on its ``H/m`` query heads, with its ``KV/m`` heads where the
KV heads divide and else the whole KV, of which its query heads read
their groups (``kv_heads``); ``wo`` row-parallel; the MLP's ``w_gate``
and ``w_up`` column-parallel and ``w_down`` row-parallel.  Each such
layer takes its input through ``collectives.sum_backward`` (its gradient
summed over ``model``) and sums its partial output over ``model``
(``sum_forward``), one all-reduce; a weight that ``model`` does not split
but the rank reads in part (the whole KV) takes its gradient through
``sum_backward`` too.  The embedding is vocab-parallel (``embed_body``:
the rank's rows, zeros for the ids outside them, then the all-reduce),
and ``unembed`` returns the rank's vocab slice of the logits, the padded
ids masked by their global index (``models.model.lm_loss`` is the
vocab-parallel cross entropy).  A leaf that ``model`` does not divide is
whole on every rank, which computes that part whole.  A rank's part of
each layer is a function of its blocks and its ``model`` index that
returns the partial output before the all-reduce (``attention_body``,
``attention_decode_body``, ``mlp_body``, ``embed_body``,
``unembed_body``), so one process can run every rank's and sum them; each
layer takes its weights through ``collectives.at_use``, which gathers a
block that training splits over the data axes (FSDP) at its use.

Under ``cfg.seq_parallel`` (the reference's ``constrain(x, "batch",
"seq", None)`` before attention and the FFN) a whole-sequence pass,
training or prefill, keeps the residual stream split by sequence over
``model`` between the layers (``seq_split``, ``collectives.SeqSplit``):
the embedding's partial rows are reduce-scattered to the rank's ``S/m``
rows, the norms and residual adds run on them, a layer gathers its
normed input whole before its column-parallel products and
reduce-scatters its row-parallel output back into the rows in place of
the all-reduce (``layer_input``, ``layer_output``; a layer ``model``
does not split gathers its input and keeps its rows of the output), the
norms' weights take their gradients summed over ``model``, and the final
norm's output is gathered before the head.  A length ``m`` does not
divide is padded inside the gathers and scatters.  Decode stays as it is.

KV heads that do not divide ``model`` split the serving cache by sequence
where its length divides (``sharding.serve_cache_spec``): a rank holds
slots ``[r S/m, (r+1) S/m)`` of K/V, and ``kv_pos`` whole.  Prefill keeps
the rank's slots of the K/V it computed; a decode step writes the
token's K/V only on the rank that owns its slot (``write_owned``),
gathers the query heads over ``model`` where they are split
(``collectives.gather_heads``), runs the decode-attention kernel for
every head over the rank's slots with its log-sum-exp
(``seq_attend``), merges the ranks' partial softmaxes
(``collectives.softmax_merge``), keeps the rank's heads and applies
``wo`` row-parallel (``attention_decode_seq``).  Where neither the KV
heads nor the length divide, the cache is whole on every rank.

The KV cache is a dict with the reference's layout (``k``/``v`` of
``(n_layers, B, S, KV, dh)``, ``kv_pos (B, S)``, ``pos (B,)``), but
``decode_step`` updates it in place, ``pos`` included, and returns the same
dict, where the reference builds a new one: every tensor keeps its storage,
so a CUDA graph of the step replays on it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import generator, resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import current_policy, model_parallel
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.models import layers, moe as moe_lib


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not the transformer's, "
            "which covers the dense and MoE families (models.model "
            "dispatches the others)")


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = layers.param(d, h, dh, dtype=dtype, device=device)
        self.wk = layers.param(d, kv, dh, dtype=dtype, device=device)
        self.wv = layers.param(d, kv, dh, dtype=dtype, device=device)
        self.wo = layers.param(h, dh, d, dtype=dtype, device=device)
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            self.register_parameter(
                name, layers.param(heads, dh, dtype=dtype, device=device)
                if cfg.qkv_bias else None)


class MLP(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = layers.param(d, f, dtype=dtype, device=device)
        self.w_up = layers.param(d, f, dtype=dtype, device=device)
        self.w_down = layers.param(f, d, dtype=dtype, device=device)


class Block(nn.Module):
    """One pre-norm layer: attention then the FFN (a SwiGLU MLP, or the MoE
    layer when ``use_moe``), each residual."""

    def __init__(self, cfg, dtype, device, use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.attn_norm = layers.param(cfg.d_model, dtype=dtype, device=device)
        self.mlp_norm = layers.param(cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        if use_moe:
            self.moe = moe_lib.MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)

    def ffn(self, y, train: bool = False, seq=None):
        """y (B, S, d) -> (out (B, S, d), aux loss); the MoE layer routes
        the B*S tokens together, as the reference does.  Under the
        sequence split ``seq`` y and out are the rank's rows."""
        if not self.use_moe:
            return (mlp_block(self.mlp, self.cfg, y, seq),
                    torch.zeros((), device=y.device))
        if seq is not None:
            return moe_lib.moe_block(self.moe, y, self.cfg, train=train,
                                     seq=seq)
        b, s, d = y.shape
        out, aux = moe_lib.moe_block(self.moe, y.reshape(b * s, d), self.cfg,
                                     train=train)
        return out.reshape(b, s, d), aux

    def forward(self, x, positions, train: bool = False, seq=None):
        """Whole sequences (forward, prefill; ``train`` the training
        forward): x (B, S, d) -> (x, k, v, aux loss).  Under the sequence
        split ``seq`` (``seq_split``) x is the rank's rows (B, S/m, d), on
        which the norms and residual adds run; k and v are the whole
        sequence's."""
        cfg = self.cfg
        h, k, v = attention_full(
            self.attn, cfg,
            layers.rms_norm(x, norm_weight(self.attn_norm, seq), cfg.norm_eps),
            positions, train=train, seq=seq)
        x = x + h
        out, aux = self.ffn(
            layers.rms_norm(x, norm_weight(self.mlp_norm, seq), cfg.norm_eps),
            train=train, seq=seq)
        return x + out, k, v, aux

    def decode(self, x, pos, slot, k_cache, v_cache, kv_pos, lengths):
        """One token per sequence: x (B, 1, d).  The token's K/V go into this
        layer's cache (B, S, KV, dh) at ``slot``, in place, before attending
        (self-attention includes the current token).  The decode-attention
        kernel reads the cache's prefix of ``lengths`` slots under full
        attention, the slots ``kv_pos`` marks under a sliding window
        (``decode_step``)."""
        cfg = self.cfg
        hn = layers.rms_norm(x, self.attn_norm, cfg.norm_eps)
        w, tp = attention_weights(self.attn, cfg)
        if k_cache.shape[1] != kv_pos.shape[1]:        # split by sequence
            h = attention_decode_seq(w, cfg, hn, pos, slot, k_cache,
                                     v_cache, kv_pos, lengths)
        else:
            h = attention_decode_body(w, cfg, hn, pos, slot, k_cache,
                                      v_cache, kv_pos, lengths,
                                      0 if tp is None else tp[2])
        x = x + split_output(h, tp)[:, None]
        out, _ = self.ffn(layers.rms_norm(x, self.mlp_norm, cfg.norm_eps))
        return x + out


class Transformer(nn.Module):
    """The parameters of one dense or MoE LM, uninitialised
    (``init_params`` draws them, ``io.lm_params_from_numpy`` copies the
    reference's).  ``layers`` is in execution order; an MoE model's first
    ``n_dense`` are dense."""

    def __init__(self, cfg, device):
        super().__init__()
        _check_family(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        d, vp = cfg.d_model, cfg.vocab_padded
        self.embed = layers.param(vp, d, dtype=dtype, device=device)
        self.final_norm = layers.param(d, dtype=dtype, device=device)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings
            else layers.param(d, vp, dtype=dtype, device=device))
        self.n_dense = (cfg.n_dense_layers if cfg.family == "moe"
                        else cfg.n_layers)
        self.layers = nn.ModuleList(Block(cfg, dtype, device,
                                          use_moe=i >= self.n_dense)
                                    for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """Random weights as the reference draws them (normal, std
    ``scale/sqrt(shape[0])``, so an expert weight ``(E, d, f)`` has std
    ``1/sqrt(E)``; attention and dense-MLP output projections scaled by
    ``1/sqrt(2 n_layers)``, the experts' ``w_down`` not; embeddings 0.02,
    norms and biases 0), from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (CUDA by default).  Each tensor is drawn in float32 and cast to the parameter
    dtype on its own, so no float32 copy of the whole model ever exists."""
    dev = resolve(device)
    model = Transformer(cfg, dev)
    gen = generator(dev, seed)
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embed":
            p.copy_(layers.embed_init(p.shape, gen))
        elif leaf in ("wq", "wk", "wv", "w_gate", "w_up", "lm_head") \
                or ".moe." in name:
            p.copy_(layers.dense_init(p.shape, gen))
        elif leaf in ("wo", "w_down"):
            p.copy_(layers.dense_init(p.shape, gen, scale=out_scale))
        else:                                   # norms and biases
            p.zero_()
    return model


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(p: Attention, cfg, x, positions):
    """x (B, S, d) -> q (B, S, H, dh), k/v (B, S, KV, dh) with RoPE (the
    heads of ``p``'s blocks: a rank's under the split)."""
    q = torch.einsum("bsd,dhe->bshe", x, p.wq)
    k = torch.einsum("bsd,dke->bske", x, p.wk)
    v = torch.einsum("bsd,dke->bske", x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = layers.apply_rope(q.transpose(1, 2), positions[:, None, :],
                          cfg.rope_theta).transpose(1, 2)
    k = layers.apply_rope(k.transpose(1, 2), positions[:, None, :],
                          cfg.rope_theta).transpose(1, 2)
    return q, k, v


# ---------------------------------------------------------------------------
# The split over ``model``
# ---------------------------------------------------------------------------


def split_layer(split: bool):
    """The policy's ``(mesh, m, index)`` for a layer whose blocks ``model``
    splits (``split``), else None; blocks split without a policy raise."""
    if not split:
        return None
    tp = model_parallel(current_policy())
    if tp is None:
        raise RuntimeError("a layer holding its blocks of a model split "
                           "computes under a mesh policy only")
    return tp


def split_input(x, tp):
    """A split layer's input: its gradient summed over ``model``."""
    if tp is None:
        return x
    return collectives.sum_backward(x, tp[0], ("model",), reader="tp_grads")


def split_output(x, tp):
    """A split layer's partial output summed over ``model``."""
    if tp is None:
        return x
    return collectives.sum_forward(x, tp[0], ("model",), reader="tp_sum")


def seq_split(cfg, n: int):
    """The sequence split of a whole-sequence pass of ``n`` positions
    (``collectives.SeqSplit``) under ``cfg.seq_parallel`` and a policy
    whose ``model`` axis is larger than 1, else None."""
    if not cfg.seq_parallel:
        return None
    tp = model_parallel(current_policy())
    return None if tp is None else collectives.SeqSplit(tp, n)


def layer_input(x, tp, seq):
    """A layer's input: under the sequence split ``seq`` the rank's rows
    gathered whole (the gradient reduce-scattered where ``model`` splits
    the layer, else the rank's rows of it, every rank computing it
    alike); else ``split_input``."""
    if seq is None:
        return split_input(x, tp)
    return seq.gather(x, whole=tp is None)


def layer_output(x, tp, seq):
    """A layer's output: under the sequence split the partial outputs
    reduce-scattered into the rank's rows (where ``model`` splits the
    layer), or the rank's rows of the whole output; else
    ``split_output``."""
    if seq is None:
        return split_output(x, tp)
    return seq.scatter(x) if tp is not None else seq.rows(x)


def norm_weight(w, seq):
    """A norm's weight: under the sequence split it acts on the rank's
    rows, so its gradient is summed over ``model``."""
    if seq is None:
        return w
    return collectives.sum_backward(w, seq.mesh, ("model",),
                                    reader="sp_norms")


def kv_heads(n_q: int, n_kv: int, cfg, m_idx: int):
    """The KV heads that model rank ``m_idx``'s ``n_q`` query heads (from
    ``m_idx * n_q`` on) read, as indices into the ``n_kv`` it holds: None
    where those are its own block (or all heads are its), each serving
    ``n_q / n_kv`` consecutive query heads; else, the KV whole, one index
    per run of ``gcd(n_q, G)`` consecutive query heads (G = H / KV), all
    in one group."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if n_kv != kv or n_q == h:
        return None
    g = h // kv
    run = math.gcd(n_q, g)
    h0 = m_idx * n_q
    return [(h0 + i * run) // g for i in range(n_q // run)]


def take_heads(x: torch.Tensor, idx, dim: int) -> torch.Tensor:
    """``x``'s heads ``idx`` along ``dim`` (``kv_heads``): a view where they
    are consecutive, else a copy."""
    if idx is None:
        return x
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return x.narrow(dim, idx[0], len(idx))
    return x.index_select(dim, torch.tensor(idx, device=x.device))


def attention_weights(p: Attention, cfg):
    """(``p``'s weights as the layer computes with them, the split's
    ``(mesh, m, index)`` or None).  Under the split with the KV heads
    whole, ``wk``/``wv``/``bk``/``bv`` take their gradient summed over
    ``model``: each rank reads only its query heads' groups."""
    w = collectives.layer_weights(p, ("wq", "wk", "wv", "wo", "bq", "bk", "bv"))
    tp = split_layer(w.wq.shape[1] != cfg.n_heads)
    if tp is not None and w.wk.shape[1] == cfg.n_kv_heads:
        for n in ("wk", "wv", "bk", "bv"):
            if getattr(w, n) is not None:
                setattr(w, n, split_input(getattr(w, n), tp))
    return w, tp


def attention_body(w, cfg, x, positions, m_idx: int = 0,
                   train: bool = False):
    """Model rank ``m_idx``'s part of ``attention_full`` on its blocks
    ``w`` (``wq (d, H/m, dh)``, ``wk``/``wv`` its KV heads or all, ``wo
    (H/m, dh, d)``, the biases; the whole weights at m = 1): (its partial
    output (B, S, d), which the model ranks sum, and its k, v (B, S, KV
    held, dh))."""
    q, k, v = _qkv(w, cfg, x, positions)
    sel = kv_heads(q.shape[2], k.shape[2], cfg, m_idx)
    ka, va = take_heads(k, sel, 2), take_heads(v, sel, 2)
    window = cfg.window if cfg.attention == "swa" else 0
    if train and cfg.attn_impl == "xla":
        o = layers.blockwise_attention(q, ka, va, causal=True, window=window,
                                       block_q=cfg.attn_block_q,
                                       block_kv=cfg.attn_block_kv)
        return layers.heads_out(o, w.wo), k, v
    if train and torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError(
            f"{cfg.name}: attn_impl='pallas' trains through the flash-"
            "attention kernel (B2), which has a backward in neither "
            "package; train with attn_impl='xla' (the default)")
    o = flash_attn(q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
                   causal=True, window=window).transpose(1, 2)
    return layers.heads_out(o, w.wo), k, v


def attention_full(p: Attention, cfg, x, positions, train: bool = False,
                   seq=None):
    """Causal (or sliding-window) attention over whole sequences.  Serving
    goes through the flash-attention kernel, which reads q, k and v as (B,
    H, S, dh) views of the (B, S, H, dh) tensors (no copies); ``train``
    follows ``cfg.attn_impl`` (module docstring).  Returns (out, k, v),
    k and v the heads this rank holds; under the sequence split ``seq``
    x and out are the rank's rows, k and v the whole sequence's."""
    w, tp = attention_weights(p, cfg)
    out, k, v = attention_body(w, cfg, layer_input(x, tp, seq), positions,
                               0 if tp is None else tp[2], train)
    return layer_output(out, tp, seq), k, v


def attention_decode_body(w, cfg, x, pos, slot, k_cache, v_cache, kv_pos,
                          lengths, m_idx: int = 0):
    """Model rank ``m_idx``'s part of one decode step's attention
    (``Block.decode``) on its blocks ``w``: x (B, 1, d); the token's k, v
    written into the rank's cache (B, S, KV held, dh) at ``slot``, in
    place; returns its partial output (B, d)."""
    bidx = torch.arange(x.shape[0], device=x.device)
    q, k, v = _qkv(w, cfg, x, pos[:, None])
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    sel = kv_heads(q.shape[2], k.shape[2], cfg, m_idx)
    q = q[:, 0].contiguous()
    k_t = take_heads(k_cache.transpose(1, 2), sel, 1)
    v_t = take_heads(v_cache.transpose(1, 2), sel, 1)
    if cfg.attention == "full":
        o = decode_attn(q, k_t, v_t, lengths)
    else:
        o = decode_attn(q, k_t, v_t, kv_pos=kv_pos, pos=pos)
    return torch.einsum("bhe,hed->bd", o, w.wo)


def seq_part(n_kv: int, n_slots: int):
    """(this model rank's first slot, its slots) of a cache of ``n_slots``
    slots and ``n_kv`` KV heads that the current policy splits by
    sequence (``sharding.serve_cache_spec``), else None."""
    tp = model_parallel(current_policy())
    if tp is None:
        return None
    n = sharding.serve_cache_shape("k", (1, n_slots, n_kv, 1), tp[0])[1]
    return None if n == n_slots else (tp[2] * n, n)


def write_owned(k_cache, v_cache, k, v, slot, lo: int) -> None:
    """The token's k, v (B, KV, dh) into a rank's slots ``lo ..`` of a
    cache split by sequence (``k_cache``/``v_cache`` (B, S/m, KV, dh)), in
    place, in the rows whose ``slot`` ((B,) or a scalar, global) the rank
    owns; the other rows keep theirs.  No host sync: a CUDA graph
    replays it."""
    b, n = k_cache.shape[:2]
    local = torch.broadcast_to(slot, (b,)).long() - lo
    own = ((local >= 0) & (local < n))[:, None, None]
    idx = local.clamp(0, n - 1)
    bidx = torch.arange(b, device=k.device)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[bidx, idx] = torch.where(own, new.to(cache.dtype),
                                       cache[bidx, idx])


def seq_attend(q, k_cache, v_cache, lo: int, lengths=None, kv_pos=None,
               pos=None):
    """A rank's decode over its slots ``lo ..`` of a cache split by
    sequence, for every query head: q (B, H, dh) against ``k_cache``/
    ``v_cache`` (B, S/m, KV, dh), masked by ``lengths`` (B,) over the
    whole cache (its valid slots are ``clamp(lengths - lo, 0, S/m)``) or
    by the whole ``kv_pos`` (B, S) (its slots' columns) with ``pos``;
    returns (output (B, H, dh), log-sum-exp (B, H)): the decode-attention
    kernel's partial softmax, which ``collectives.softmax_merge`` merges
    over the ranks."""
    n = k_cache.shape[1]
    k_t, v_t = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    if lengths is not None:
        own = (lengths - lo).clamp(0, n).to(torch.int32)
        return decode_attn(q, k_t, v_t, own, return_lse=True)
    return decode_attn(q, k_t, v_t, kv_pos=kv_pos.narrow(1, lo, n), pos=pos,
                       return_lse=True)


def own_heads(o, n: int, m_idx: int):
    """Model rank ``m_idx``'s ``n`` heads of the merged output ``o`` (B,
    H, dh): all of them where ``n`` is H."""
    return o if n == o.shape[1] else o.narrow(1, m_idx * n, n)


def decode_query(w, cfg, x, pos):
    """One token's q (B, H held, dh) and k, v (B, KV held, dh) with RoPE
    at ``pos`` (B,), on blocks ``w``."""
    q, k, v = _qkv(w, cfg, x, pos[:, None])
    return q[:, 0].contiguous(), k[:, 0], v[:, 0]


def attention_decode_seq(w, cfg, x, pos, slot, k_cache, v_cache, kv_pos,
                         lengths):
    """One decode step's attention over a cache split by sequence
    (module docstring) on the rank's blocks ``w``: x (B, 1, d); its part
    of the cache (B, S/m, KV, dh) written in place where it owns the
    token's slot; returns its partial output (B, d), which the model
    ranks sum where ``model`` splits the query heads, or the whole output
    where it does not."""
    mesh, _, idx = model_parallel(current_policy())
    n = k_cache.shape[1]
    lo = idx * n
    q, k, v = decode_query(w, cfg, x, pos)
    write_owned(k_cache, v_cache, k, v, slot, lo)
    q_all = (q if q.shape[1] == cfg.n_heads
             else collectives.gather_heads(q, mesh))
    if cfg.attention == "full":
        o, lse = seq_attend(q_all, k_cache, v_cache, lo, lengths=lengths)
    else:
        o, lse = seq_attend(q_all, k_cache, v_cache, lo, kv_pos=kv_pos,
                            pos=pos)
    o = own_heads(collectives.softmax_merge(o, lse, mesh), q.shape[1], idx)
    return torch.einsum("bhe,hed->bd", o, w.wo)


def mlp_body(w, x):
    """A model rank's part of the SwiGLU MLP on its blocks ``w``
    (``w_gate``/``w_up (d, f/m)``, ``w_down (f/m, d)``): its partial
    output, which the model ranks sum."""
    return layers.swiglu(x, w.w_gate, w.w_up, w.w_down)


def mlp_block(p: MLP, cfg, x, seq=None):
    w = collectives.layer_weights(p, ("w_gate", "w_up", "w_down"))
    tp = split_layer(w.w_gate.shape[1] != cfg.d_ff)
    return layer_output(mlp_body(w, layer_input(x, tp, seq)), tp, seq)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def embed_body(embed, ids, lo: int):
    """A model rank's part of the vocab-parallel embedding: the rows of
    ``ids`` (global, in ``[0, Vp)``) that fall in its block ``embed``
    (rows ``lo .. lo + V/m - 1``), zeros for the others, which the model
    ranks sum.  ``F.embedding`` of the ids in range: its backward sums a
    token's rows without atomics, the others adding zeros to row 0."""
    local = ids - lo
    inside = (local >= 0) & (local < embed.shape[0])
    x = F.embedding(torch.where(inside, local, 0), embed)
    return x * inside[..., None].to(x.dtype)


def _embed(params: Transformer, cfg, tokens, train: bool = False,
           seq=None):
    # training looks up through F.embedding, whose backward sums a
    # token's rows without atomics; a negative id (a masked target's
    # input) reads from the end, as indexing does.  Under the sequence
    # split the rank's rows: the vocab-parallel parts reduce-scattered
    embed = collectives.at_use(params.embed)
    tp = split_layer(embed.shape[0] != cfg.vocab_padded)
    if tp is not None:
        x = layer_output(embed_body(embed, tokens.remainder(cfg.vocab_padded),
                                    tp[2] * embed.shape[0]), tp, seq)
    else:
        x = (F.embedding(tokens.remainder(embed.shape[0]), embed) if train
             else embed[tokens])
        x = x if seq is None else seq.rows(x)
    return x.to(getattr(torch, cfg.compute_dtype))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def forward(params: Transformer, cfg, tokens: torch.Tensor,
            train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, Vp), aux loss: the MoE layers'
    load-balancing losses summed, 0 for a dense model).  ``train`` is the
    training forward (module docstring); with gradients asked under
    ``cfg.remat`` each layer's activations are recomputed in the backward
    (the reference's ``jax.checkpoint``; the layers draw no random
    numbers, so no RNG state is kept).  Under the sequence split
    (``seq_split``) the residual stream between the layers and the final
    norm are the rank's rows, gathered whole before the head."""
    b, s = tokens.shape
    seq = seq_split(cfg, s)
    x = _embed(params, cfg, tokens, train, seq)
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), device=x.device)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for blk in params.layers:
        if remat:
            x, _, _, a = checkpoint(blk, x, positions, train, seq,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            x, _, _, a = blk(x, positions, train, seq)
        aux = aux + a
    x = layers.rms_norm(x, norm_weight(params.final_norm, seq), cfg.norm_eps)
    return unembed(params, cfg, x, seq), aux


def unembed_body(w, cfg, x, lo: int = 0, tied: bool = False):
    """A model rank's slice of the logits: ``x`` through its vocab block
    ``w`` (the tied ``embed (V/m, d)`` or ``lm_head (d, V/m)``), whose
    first id is ``lo``; padded ids (global id at or past ``cfg.vocab``)
    get -1e9."""
    if tied:
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, w)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=x.device) >= cfg.vocab
        logits = torch.where(pad, -1e9, logits.float()).to(logits.dtype)
    return logits


def unembed(params: Transformer, cfg, x, seq=None):
    """Logits over the padded vocab; padded ids get -1e9.  Under the split
    the rank's vocab slice (module docstring); under the sequence split
    ``seq`` x is the rank's rows, gathered whole first."""
    tied = cfg.tie_embeddings
    w = collectives.at_use(params.embed if tied else params.lm_head)
    n = w.shape[0] if tied else w.shape[1]
    tp = split_layer(n != cfg.vocab_padded)
    return unembed_body(w, cfg, layer_input(x, tp, seq),
                        0 if tp is None else tp[2] * n, tied)


# --------------------------- KV cache ---------------------------------------


def cache_len(cfg, max_len: int) -> int:
    if cfg.attention == "swa":
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Slot-based cache with a position per sequence (``pos`` (B,)), so a
    continuous-batching engine can stagger requests across slots.  Under
    a mesh policy K/V take the rank's part (``sharding.serve_cache_spec``),
    ``kv_pos`` stays whole."""
    _check_family(cfg)
    dev = resolve(device)
    s = cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.d_head)
    policy = current_policy()
    if policy is not None:
        shape = sharding.serve_cache_shape("k", shape, policy.mesh)
    dtype = getattr(torch, cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "kv_pos": torch.full((batch, s), -1, dtype=torch.int32, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(params: Transformer, cfg, cache: dict, token: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """token (B,) int: one autoregressive step for every slot.  The ring
    slot is ``pos % S`` under a sliding window, else ``min(pos, S-1)``.
    Updates ``cache`` in place and returns (logits (B, Vp), cache).

    Under full attention the cache is filled in order: ``prefill`` leaves
    slots ``0..length-1`` valid and the rest empty, each step writes slot
    ``min(pos, S-1)``, and a server rewrites a reused slot's whole row, so
    after this step's write the valid slots are exactly ``0 ..
    min(pos+1, S) - 1``.  The decode-attention kernel reads that prefix
    through ``lengths`` and computes what the ``kv_pos`` mask computes."""
    b = token.shape[0]
    pos = cache["pos"].expand(b)
    s = cache["kv_pos"].shape[1]              # the whole cache's slots
    slot = pos % s if cfg.attention == "swa" else pos.clamp(max=s - 1)
    lengths = (pos + 1).clamp(max=s).to(torch.int32)
    x = _embed(params, cfg, token)[:, None]
    cache["kv_pos"][torch.arange(b, device=x.device), slot] = pos
    for i, blk in enumerate(params.layers):
        x = blk.decode(x, pos, slot, cache["k"][i], cache["v"][i],
                       cache["kv_pos"], lengths)
    cache["pos"].add_(1)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], cache


def prefill(params: Transformer, cfg, tokens: torch.Tensor, max_len: int,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; returns (next-token logits (B, Vp), primed cache).

    ``lengths`` (B,) serves right-padded prompts of different lengths:
    logits come from position ``lengths-1`` and cache entries at or past
    the length are marked empty (-1).  With ``lengths=None`` the whole row
    is the prompt.

    Under a sliding window shorter than the prompt, the cache keeps the
    last ``window`` positions of the padded row, placed at slot ``p %
    window``; with ``lengths`` the padded ones among them are then marked
    empty, so a padded prompt keeps fewer than ``window`` of its own
    positions.  This is the reference's behaviour (ROADMAP queue C).

    Under the sequence split (``seq_split``) the residual stream between
    the layers and the final norm are the rank's rows, gathered whole
    before the logits are taken; K/V come from each layer's gathered
    input, as without the split."""
    b, s = tokens.shape
    seq = seq_split(cfg, s)
    x = _embed(params, cfg, tokens, seq=seq)
    dev = x.device
    positions = _positions(b, s, dev)
    ks, vs = [], []
    for blk in params.layers:
        x, k, v, _ = blk(x, positions, seq=seq)
        ks.append(k)
        vs.append(v)
    k, v = torch.stack(ks), torch.stack(vs)          # (L, B, S, KV, dh)

    c = cache_len(cfg, max_len)
    if cfg.attention == "swa" and s > c:
        # keep the last `c` tokens, position p at ring slot p % c
        kept = torch.arange(s - c, s, dtype=torch.int32, device=dev)
        order = torch.argsort(kept % c)
        k, v = k[:, :, s - c:][:, :, order], v[:, :, s - c:][:, :, order]
        kv_pos = torch.zeros((b, c), dtype=torch.int32, device=dev)
        kv_pos[:, (kept % c).long()] = kept
    else:
        if s > c:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {c}")
        pad = (0, 0, 0, 0, 0, c - s)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        kv_pos = torch.cat([positions, torch.full((b, c - s), -1,
                                                  dtype=torch.int32, device=dev)], 1)

    part = seq_part(cfg.n_kv_heads, c)
    if part is not None:                      # the rank's slots
        k = k.narrow(2, *part).contiguous()
        v = v.narrow(2, *part).contiguous()
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    if seq is not None:
        x = seq.gather(x)
    if lengths is None:
        cache = {"k": k, "v": v, "kv_pos": kv_pos,
                 "pos": torch.full((b,), s, dtype=torch.int32, device=dev)}
        return unembed(params, cfg, x[:, -1:])[:, 0], cache
    lengths = lengths.to(torch.int32)
    valid = (kv_pos < lengths[:, None]) & (kv_pos >= 0)
    kv_pos = torch.where(valid, kv_pos, -1).to(torch.int32)
    # the cache owns its pos (decode_step advances it in place)
    cache = {"k": k, "v": v, "kv_pos": kv_pos, "pos": lengths.clone()}
    last = (lengths - 1).clamp(min=0).long()
    x_last = x[torch.arange(b, device=dev), last][:, None]
    return unembed(params, cfg, x_last)[:, 0], cache
