"""Whisper-medium backbone: the encoder-decoder transformer of the audio
family (port of ``repro/models/encdec.py``).

The conv front end is a stub, as in the reference: the model takes
precomputed frame embeddings (B, S_enc, d_model).  Both stacks add
sinusoidal positions (the reference's deviation from Whisper's learned
decoder positions), computed in float32.

Parameters live in ``nn.Module``s with the reference's names and shapes:
``embed``, ``enc_layers.i`` (``ln1``, ``attn``, ``ln2``, ``mlp``),
``dec_layers.i`` (``ln1``, ``self_attn``, ``ln2``, ``cross_attn``,
``ln3``, ``mlp``), ``enc_final_ln``, ``dec_final_ln`` and ``lm_head``; one
module per layer where the reference stacks layers and scans them.

Serving (``prefill``, ``decode_step``, and ``forward`` by default) takes
the kernels: the encoder's self-attention goes through the flash-attention
kernel (``kernels/flash_attn/ops.py``) without the causal mask; a
teacher-forced ``forward`` runs it causal for the decoder's
self-attention and unmasked for its cross-attention (Sq = T, Skv = S_enc).
Decode runs the decode-attention kernel (``kernels/decode_attn/ops.py``)
twice per layer, both under ``lengths`` (see ``decode_step``).  Training
asks for ``forward(..., train=True)``: every attention is
``layers.blockwise_attention`` in plain PyTorch under autograd, as the
reference trains (neither kernel has a backward in either package), each
layer recomputed in the backward when ``cfg.remat`` is set, as the
reference's ``jax.checkpoint`` does.

Under a ``MeshPolicy`` whose ``model`` axis is larger than 1 the layers
split as the transformer's do (``models/transformer.py``): every
attention (the encoder's and decoder's self-attention and the
cross-attention) on the rank's ``H/m`` heads of ``wq``/``wk``/``wv`` with
``wo`` row-parallel; the GELU MLP's ``w1`` and ``b1`` column-parallel and
``w2`` row-parallel, ``b2`` added once after the all-reduce; layer norms
whole; the embedding vocab-parallel and ``lm_head`` the rank's vocab
slice.  The cache then holds the rank's heads (``init_cache(heads=)``).
A rank's part of each is ``mha_body`` and ``mlp_body``.

The cache has the reference's layout (``self_k``/``self_v``/``cross_k``/
``cross_v`` of ``(n_layers, B, max_len, H, dh)``, ``enc_len`` and ``pos``
scalars, ``kv_pos (B, max_len)``), but ``decode_step`` updates it in
place, ``pos`` included, and returns the same dict: every tensor keeps its
storage, so a CUDA graph of the step replays on it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import generator, resolve
from repro_torch.distributed import collectives
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.models import layers, transformer


def _check_family(cfg) -> None:
    if cfg.family != "encdec":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not enc-dec")


class LayerNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.w = layers.param(d, dtype=dtype, device=device)
        self.b = layers.param(d, dtype=dtype, device=device)

    def forward(self, x, eps):
        return layers.layer_norm(x, self.w, self.b, eps)


class MHA(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
        self.wq = layers.param(d, h, dh, dtype=dtype, device=device)
        self.wk = layers.param(d, h, dh, dtype=dtype, device=device)
        self.wv = layers.param(d, h, dh, dtype=dtype, device=device)
        self.wo = layers.param(h, dh, d, dtype=dtype, device=device)


class MLP(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = layers.param(d, f, dtype=dtype, device=device)
        self.b1 = layers.param(f, dtype=dtype, device=device)
        self.w2 = layers.param(f, d, dtype=dtype, device=device)
        self.b2 = layers.param(d, dtype=dtype, device=device)


class EncLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.attn = MHA(cfg, dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class DecLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.self_attn = MHA(cfg, dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.cross_attn = MHA(cfg, dtype, device)
        self.ln3 = LayerNorm(d, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class EncDec(nn.Module):
    """The parameters of one enc-dec model, uninitialised (``init_params``
    draws them, ``io.lm_params_from_numpy`` copies the reference's)."""

    def __init__(self, cfg, device):
        super().__init__()
        _check_family(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        d, vp = cfg.d_model, cfg.vocab_padded
        self.embed = layers.param(vp, d, dtype=dtype, device=device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        self.enc_final_ln = LayerNorm(d, dtype, device)
        self.dec_final_ln = LayerNorm(d, dtype, device)
        self.lm_head = layers.param(d, vp, dtype=dtype, device=device)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32: ``sin`` then ``cos`` of ``p / 10000^(2i/d)``."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg, seed: int = 0, device=None) -> EncDec:
    """Random weights as the reference draws them (normal, std
    ``scale/sqrt(shape[0])``; the attention and MLP output projections
    scaled by ``1/sqrt(2 n_layers)``; embedding 0.02; layer-norm gains 1,
    biases 0), from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (CUDA by default), each tensor drawn in float32 and cast on
    its own."""
    dev = resolve(device)
    model = EncDec(cfg, dev)
    gen = generator(dev, seed)
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embed":
            p.copy_(layers.embed_init(p.shape, gen))
        elif leaf in ("wq", "wk", "wv", "w1", "lm_head"):
            p.copy_(layers.dense_init(p.shape, gen))
        elif leaf in ("wo", "w2"):
            p.copy_(layers.dense_init(p.shape, gen, scale=out_scale))
        elif leaf == "w":                       # layer-norm gains
            p.fill_(1.0)
        else:                                   # biases
            p.zero_()
    return model


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


MHA_NAMES = ("wq", "wk", "wv", "wo")
MLP_NAMES = ("w1", "b1", "w2", "b2")


def mlp_body(w, x):
    """A model rank's part of the GELU MLP on its blocks ``w`` (``w1 (d,
    f/m)``, ``b1 (f/m)``, ``w2 (f/m, d)``): its partial output before
    ``b2``, which the model ranks sum."""
    h = F.gelu(torch.einsum("bsd,df->bsf", x, w.w1) + w.b1,
               approximate="tanh")             # jax.nn.gelu's default
    return torch.einsum("bsf,fd->bsd", h, w.w2)


def _mlp(p: MLP, cfg, x):
    w = collectives.layer_weights(p, MLP_NAMES)
    tp = transformer.split_layer(w.w1.shape[1] != cfg.d_ff)
    out = mlp_body(w, transformer.split_input(x, tp))
    return transformer.split_output(out, tp) + w.b2


def mha_body(w, cfg, xq, xkv, *, causal: bool, train: bool):
    """A model rank's part of ``_mha`` on its heads' blocks ``w``: its
    partial output (B, Sq, d), which the model ranks sum."""
    q = torch.einsum("bsd,dhe->bshe", xq, w.wq)
    k = torch.einsum("bsd,dhe->bshe", xkv, w.wk)
    v = torch.einsum("bsd,dhe->bshe", xkv, w.wv)
    if train:
        o = layers.blockwise_attention(q, k, v, causal=causal,
                                       block_q=cfg.attn_block_q,
                                       block_kv=cfg.attn_block_kv)
    else:
        o = flash_attn(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal).transpose(1, 2)
    return layers.heads_out(o, w.wo)


def _mha(p: MHA, cfg, xq, xkv, *, causal: bool, train: bool):
    """Attention of ``xq`` (B, Sq, d) over ``xkv`` (B, Skv, d) -> (B, Sq,
    d): the flash-attention kernel when serving (through (B, H, S, dh)
    views, no copies), ``blockwise_attention`` when training."""
    w = collectives.layer_weights(p, MHA_NAMES)
    tp = transformer.split_layer(w.wq.shape[1] != cfg.n_heads)
    q_in = transformer.split_input(xq, tp)
    kv_in = q_in if xkv is xq else transformer.split_input(xkv, tp)
    return transformer.split_output(
        mha_body(w, cfg, q_in, kv_in, causal=causal, train=train), tp)


def _enc_layer(lp: EncLayer, cfg, x, train: bool):
    eps = cfg.norm_eps
    hn = lp.ln1(x, eps)
    x = x + _mha(lp.attn, cfg, hn, hn, causal=False, train=train)
    return x + _mlp(lp.mlp, cfg, lp.ln2(x, eps))


def _dec_layer(lp: DecLayer, cfg, x, enc, train: bool):
    eps = cfg.norm_eps
    hn = lp.ln1(x, eps)
    x = x + _mha(lp.self_attn, cfg, hn, hn, causal=True, train=train)
    x = x + _mha(lp.cross_attn, cfg, lp.ln2(x, eps), enc, causal=False,
                 train=train)
    return x + _mlp(lp.mlp, cfg, lp.ln3(x, eps))


def _run(layer, lp, cfg, train: bool, *xs):
    """One layer; under training with ``cfg.remat`` its activations are
    recomputed in the backward (the reference's ``jax.checkpoint``).  The
    layers draw no random numbers, so no RNG state is kept."""
    if train and cfg.remat and torch.is_grad_enabled():
        return checkpoint(layer, lp, cfg, *xs, train, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(lp, cfg, *xs, train)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def encode(params: EncDec, cfg, frames: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """frames (B, S, d) precomputed frame embeddings (the front-end stub)
    -> the encoder's output (B, S, d) in the compute dtype."""
    _, s, d = frames.shape
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
    for lp in params.enc_layers:
        x = _run(_enc_layer, lp, cfg, train, x)
    return params.enc_final_ln(x, cfg.norm_eps)


def decode_train(params: EncDec, cfg, enc_out: torch.Tensor,
                 tokens: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, T) -> logits (B, T, Vp)."""
    _, t = tokens.shape
    x = transformer._embed(params, cfg, tokens, train)
    x = x + sinusoidal_positions(t, cfg.d_model, x.device).to(x.dtype)[None]
    for lp in params.dec_layers:
        x = _run(_dec_layer, lp, cfg, train, x, enc_out)
    x = params.dec_final_ln(x, cfg.norm_eps)
    return _unembed(params, cfg, x)


def _unembed(params: EncDec, cfg, x):
    """Logits over the padded vocab; padded ids get -1e9 (in float32, then
    the logits' dtype)."""
    return transformer.unembed(params, cfg, x)


def forward(params: EncDec, cfg, batch: dict, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"frames" (B, S, d), "tokens" (B, T)} -> (logits (B, T, Vp),
    aux loss 0).  ``train`` is the training forward (module docstring)."""
    enc = encode(params, cfg, batch["frames"], train)
    logits = decode_train(params, cfg, enc, batch["tokens"], train)
    return logits, torch.zeros((), device=logits.device)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None,
               heads: int = None) -> dict:
    """The empty cache; ``heads`` the heads a model rank holds (all by
    default)."""
    _check_family(cfg)
    dev = resolve(device)
    shape = (cfg.n_layers, batch, max_len, heads or cfg.n_heads, cfg.d_head)
    dtype = getattr(torch, cfg.compute_dtype)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name in ("self_k", "self_v", "cross_k", "cross_v")} | {
        "enc_len": torch.zeros((), dtype=torch.int32, device=dev),
        "kv_pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params: EncDec, cfg, batch, max_len: int) -> dict:
    """Encode the frames (a dict with ``"frames"`` (B, S, d), or the
    tensor) and prime the cross-attention cache, padded to ``max_len``
    (which the self-attention cache shares, so it must hold the S frames);
    the decoder starts from position 0.  Returns the cache alone, as the
    reference's does."""
    frames = batch["frames"] if isinstance(batch, dict) else batch
    b, s, _ = frames.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the {s} encoder "
                         "frames the cross-attention cache holds")
    enc = encode(params, cfg, frames)
    cache = init_cache(cfg, b, max_len, device=enc.device,
                       heads=params.dec_layers[0].cross_attn.wk.shape[1])
    for i, lp in enumerate(params.dec_layers):
        ca = collectives.layer_weights(lp.cross_attn, ("wk", "wv"))
        cache["cross_k"][i, :, :s] = torch.einsum("bsd,dhe->bshe", enc,
                                                  ca.wk)
        cache["cross_v"][i, :, :s] = torch.einsum("bsd,dhe->bshe", enc,
                                                  ca.wv)
    cache["enc_len"].fill_(s)
    return cache


def decode_step(params: EncDec, cfg, cache: dict, token: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """token (B,) int: one decoder step at the cache's position ``pos``.
    Updates ``cache`` in place and returns (logits (B, Vp), cache).

    Both attentions go through the decode-attention kernel under
    ``lengths``, which computes what the reference's masks compute.
    Self-attention: the reference marks slot ``pos`` with ``kv_pos = pos``
    at each step and keeps the slots with ``0 <= kv_pos <= pos``; prefill
    leaves every slot empty and decoding starts at position 0, so the cache
    fills in order and those slots are exactly ``0 .. pos``: ``lengths =
    pos + 1``.  Cross-attention: the reference keeps the slots below
    ``enc_len`` (``enc_pos``), ``lengths = enc_len``.  Past ``max_len`` the
    step writes the last slot (the reference drops the write)."""
    b = token.shape[0]
    pos = cache["pos"]
    s = cache["self_k"].shape[2]
    eps = cfg.norm_eps
    dev = token.device
    bidx = torch.arange(b, device=dev)
    slot = pos.clamp(max=s - 1).expand(b)
    self_len = (pos + 1).clamp(max=s).to(torch.int32).expand(b).contiguous()
    cross_len = cache["enc_len"].expand(b).contiguous()
    x = transformer._embed(params, cfg, token)[:, None]
    dim = torch.arange(0, cfg.d_model, 2, dtype=torch.float32,
                       device=dev)[None]
    angle = pos.float() / torch.pow(10000.0, dim / cfg.d_model)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    x = x + pe.to(x.dtype)[None]
    cache["kv_pos"][bidx, slot] = pos
    for i, lp in enumerate(params.dec_layers):
        sa = collectives.layer_weights(lp.self_attn, MHA_NAMES)
        ca = collectives.layer_weights(lp.cross_attn, MHA_NAMES)
        tp = transformer.split_layer(sa.wq.shape[1] != cfg.n_heads)
        hn = lp.ln1(x, eps)
        q = torch.einsum("bsd,dhe->bshe", hn, sa.wq)
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        sk[bidx, slot] = torch.einsum("bsd,dhe->bshe", hn, sa.wk)[:, 0]
        sv[bidx, slot] = torch.einsum("bsd,dhe->bshe", hn, sa.wv)[:, 0]
        o = decode_attn(q[:, 0].contiguous(), sk.transpose(1, 2),
                        sv.transpose(1, 2), self_len)
        x = x + transformer.split_output(
            torch.einsum("bhe,hed->bd", o, sa.wo), tp)[:, None]
        q = torch.einsum("bsd,dhe->bshe", lp.ln2(x, eps), ca.wq)
        o = decode_attn(q[:, 0].contiguous(),
                        cache["cross_k"][i].transpose(1, 2),
                        cache["cross_v"][i].transpose(1, 2), cross_len)
        x = x + transformer.split_output(
            torch.einsum("bhe,hed->bd", o, ca.wo), tp)[:, None]
        x = x + _mlp(lp.mlp, cfg, lp.ln3(x, eps))
    cache["pos"].add_(1)
    x = params.dec_final_ln(x, eps)
    return _unembed(params, cfg, x)[:, 0], cache
