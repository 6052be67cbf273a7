"""RWKV6 (Finch), the ``ssm`` family (port of ``repro/models/rwkv6.py``):
an attention-free LM with a data-dependent per-channel decay.

Per head, with a (K, V) state S:

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    y_t = r_t S_{t-1} + (r_t · (u ⊙ k_t)) v_t

with ``log w_t = -exp(clip(w0 + tanh(x_w A) B, -8, 2))``.  Whole sequences
served (forward, prefill) take the chunked scan, kernel B5
(``kernels/rwkv6_scan/ops.py wkv``), once per layer; a decode step takes
the single-token recurrence ``wkv_step`` in plain PyTorch, as the
reference computes it in XLA.  The training forward (``forward(...,
train=True)``) takes the reference's chunk algorithm ``wkv_chunked`` in
plain PyTorch under autograd on any device, as the reference trains
through its jnp ``wkv_chunked`` (B5 has a backward in neither package
and refuses a gradient); with gradients asked under ``cfg.remat`` each
layer is recomputed in the backward (the reference's
``jax.checkpoint``), and the training forward writes no state.

Parameters live in ``nn.Module``s with the reference's names and shapes,
one ``Layer`` per layer where the reference stacks them.  The serving
state is a dict with the reference's layout (``tm_prev``, ``cm_prev``
``(n_layers, B, d)`` in the compute dtype, ``S (n_layers, B, H, K, V)``
float32, a scalar ``pos``); ``decode_step`` updates it in place, ``pos``
included, and returns the same dict, where the reference builds a new one.

Under a ``MeshPolicy`` whose ``model`` axis is larger than 1 a layer
computes Megatron-style on this rank's blocks (``models.io.ShardedLM``,
by ``sharding.compute_spec``): the time mix on its ``H/m`` heads (``wr``,
``wk``, ``wv``, ``wg`` column-parallel; the decay LoRA ``wA``/``wB``
whole, of which the rank takes its heads' columns of ``wB`` and of
``w0``; ``u`` and the group norm's ``gn_w``/``gn_b`` on its heads; B5 and
the decode's ``wkv_step`` on its heads, so ``S`` holds ``(B, H/m, K,
V)``), ``wo`` row-parallel and its partial output summed over ``model``
(one all-reduce, reader ``"tp_sum"``); the channel mix with ``wk_c``
column-parallel and ``wv_c`` row-parallel, and ``wr_c``'s columns giving
the rank's ``d/m`` gate channels: the partial output is reduce-scattered
over ``model`` into those channels (``"tp_sum"``), gated there and
gathered whole (``"tp_gather"``), which moves the bytes of one all-reduce
(an all-reduce and a slice would move them and gather again).  The token
shift's ``tm_prev``/``cm_prev`` stay whole on every rank: the shifted
input feeds the column-parallel products whole.  The embedding and the
logits are vocab-parallel (``transformer.embed_body``, ``unembed``).
Each rank's part is a function of its blocks and its ``model`` index
(``time_mix_body``, ``channel_mix_body``), so one process can run every
rank's.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import generator, resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import current_policy
from repro_torch.kernels.rwkv6_scan.ops import wkv
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import (split_input, split_layer,
                                            split_output, unembed)

TIME_MIX = ("mu", "wr", "wk", "wv", "wg", "wo", "wA", "wB", "w0", "u",
            "gn_w", "gn_b")
# the time mix's weights that every model rank reads whole, each using
# its heads' part: their gradients are summed over ``model``
TIME_MIX_WHOLE = ("mu", "wA", "wB", "w0", "gn_w", "gn_b")
CHANNEL_MIX = ("mu_c", "wk_c", "wv_c", "wr_c")


class Layer(nn.Module):
    """One block: time mix (``mu``, ``wr`` ... ``u``, ``gn_*``) then channel
    mix (``mu_c``, ``wk_c``, ``wv_c``, ``wr_c``), each behind a layer norm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        p = lambda *shape: layers.param(*shape, dtype=dtype, device=device)
        for name in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "w0", "gn_w", "gn_b"):
            setattr(self, name, p(d))
        self.mu = p(5, d)                          # r, k, v, g, w
        for name in ("wr", "wk", "wv", "wg", "wo", "wr_c"):
            setattr(self, name, p(d, d))
        self.wA = p(d, cfg.decay_lora)
        self.wB = p(cfg.decay_lora, d)
        self.u = p(cfg.n_heads, cfg.head_size)
        self.mu_c = p(2, d)                        # k, r
        self.wk_c = p(d, f)
        self.wv_c = p(f, d)


class RWKV6(nn.Module):
    """The parameters of one RWKV6 LM, uninitialised (``init_params`` draws
    them, ``io.lm_params_from_numpy`` copies the reference's)."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not rwkv6")
        if cfg.n_heads * cfg.head_size != cfg.d_model:
            raise ValueError(f"{cfg.name}: n_heads * head_size != d_model")
        dtype = getattr(torch, cfg.param_dtype)
        d, vp = cfg.d_model, cfg.vocab_padded
        p = lambda *shape: layers.param(*shape, dtype=dtype, device=device)
        self.embed = p(vp, d)
        self.ln0_w, self.ln0_b = p(d), p(d)
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm_w, self.final_norm_b = p(d), p(d)
        self.lm_head = p(d, vp)


def init_params(cfg, seed: int = 0, device=None) -> RWKV6:
    """Random weights with the reference's distributions
    (``rwkv6.py:31-73``): ``mu``, ``mu_c`` uniform in [0, 1); the
    projections normal with std ``1/sqrt(fan-in)``, ``wo`` and ``wv_c``
    scaled by ``1/sqrt(2 n_layers)``; ``w0 = 0.3 N - 0.6``; ``wB`` at 0.01,
    ``u`` at 0.3; embeddings 0.02; norm weights 1, biases 0.  From a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (CUDA by
    default), each tensor drawn in float32 and cast on its own."""
    dev = resolve(device)
    model = RWKV6(cfg, dev)
    gen = generator(dev, seed)
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    normal = lambda shape, std: torch.randn(shape, generator=gen,
                                            device=dev) * std
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embed":
            p.copy_(layers.embed_init(p.shape, gen))
        elif leaf in ("mu", "mu_c"):
            p.copy_(torch.rand(p.shape, generator=gen, device=dev))
        elif leaf in ("wo", "wv_c"):
            p.copy_(layers.dense_init(p.shape, gen, scale=out_scale))
        elif leaf in ("wr", "wk", "wv", "wg", "wA", "wk_c", "wr_c", "lm_head"):
            p.copy_(layers.dense_init(p.shape, gen))
        elif leaf == "w0":
            p.copy_(normal(p.shape, 0.3) - 0.6)
        elif leaf == "wB":
            p.copy_(normal(p.shape, 0.01))
        elif leaf == "u":
            p.copy_(normal(p.shape, 0.3))
        elif leaf.endswith("_w"):                  # norm weights
            p.fill_(1.0)
        else:                                      # norm biases
            p.zero_()
    return model


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, T, d); prev (B, d), the last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay_log(p: Layer, x_w: torch.Tensor, lo: int, n: int
               ) -> torch.Tensor:
    """log w_t (B, T, n) in float32, in [-e^2, -e^-8], of channels ``lo ..
    lo + n - 1``: the exponent is clipped to [-8, 2] for the chunk
    cumsum's safety."""
    lora = torch.tanh(torch.einsum("btd,dl->btl", x_w, p.wA))
    lora = torch.einsum("btl,ld->btd", lora, p.wB.narrow(1, lo, n))
    return -torch.exp((p.w0.narrow(0, lo, n).float()
                       + lora.float()).clamp(-8.0, 2.0))


def wkv_step(r, k, v, dlog, u, state):
    """The single-token recurrence: r, k, v, dlog (B, H, K/V); state (B, H,
    K, V) float32 -> (y (B, H, V) in r's dtype, new state)."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    y = torch.einsum("bhk,bhkv->bhv", r32, state)
    bonus = torch.einsum("bhk,hk,bhk->bh", r32, u.float(), k32)
    y = y + bonus[..., None] * v32
    state = (torch.exp(dlog.float())[..., None] * state
             + k32[..., None] * v32[..., None, :])
    return y.to(r.dtype), state


def wkv_chunked(r, k, v, dlog, u, state, chunk: int,
                d_dtype_name: str = "compute"):
    """The reference's chunk-parallel RWKV6 core (``rwkv6.py:89-149``) in
    plain PyTorch, differentiable: r, k, v (B, T, H, K/V), dlog (B, T, H,
    K) float32, u (H, K), state (B, H, K, V) -> (y (B, T, H, V) in r's
    dtype, the state after them, float32).  Chunks of ``L = min(chunk,
    T)``; T must be a multiple of L, as the reference asserts.  Within a
    chunk the relative decay ``D[i, s] = exp(p_i - p_s - d_s)`` (at most
    1) is rounded to the compute dtype under ``d_dtype_name ==
    "compute"``, as are the r and k it multiplies, the contraction in
    float32.  Every chunk's intra-chunk terms are computed at once; the
    state is carried through the chunks in turn."""
    b, n, h, kd = r.shape
    vd = v.shape[-1]
    n_l = min(chunk, n)
    if n % n_l:
        raise ValueError(f"T={n} is not a multiple of the chunk {n_l}")
    nc = n // n_l
    cut = lambda x, e: x.reshape(b, nc, n_l, h, e).transpose(2, 3)
    rc, kc, vc = cut(r, kd), cut(k, kd), cut(v, vd)     # (B, nc, H, L, e)
    dc = cut(dlog, kd).float()
    d_dtype = r.dtype if d_dtype_name == "compute" else torch.float32
    r32, k32, v32 = rc.float(), kc.float(), vc.float()
    p = torch.cumsum(dc, dim=3) - dc          # exclusive: sum over j < i
    pd = p + dc
    p_end = pd[..., -1, :]                    # (B, nc, H, K) total decay
    dmat = torch.exp(p[..., :, None, :] - pd[..., None, :, :]).to(d_dtype)
    a = torch.einsum("bchik,bchsk,bchisk->bchis", rc.to(d_dtype).float(),
                     kc.to(d_dtype).float(), dmat.float())
    mask = torch.tril(torch.ones((n_l, n_l), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    a = torch.where(mask, a, 0.0)
    y_intra = torch.einsum("bchis,bchsv->bchiv", a, v32)
    diag = torch.einsum("bchik,hk,bchik->bchi", r32, u.float(), k32)
    k_dec = k32 * torch.exp(p_end[..., None, :] - pd)
    kv = torch.einsum("bchsk,bchsv->bchkv", k_dec, v32)
    decay = torch.exp(p_end)[..., None]
    s = state.float()
    starts = []
    for c in range(nc):
        starts.append(s)
        s = decay[:, c] * s + kv[:, c]
    y_inter = torch.einsum("bchlk,bchkv->bchlv", r32 * torch.exp(p),
                           torch.stack(starts, 1))
    y = y_inter + y_intra + diag[..., None] * v32
    return y.transpose(2, 3).reshape(b, n, h, vd).to(r.dtype), s


def time_mix_body(w, cfg, x, tm_prev, state, m_idx: int = 0, *,
                  single: bool, train: bool = False):
    """Model rank ``m_idx``'s part of the time mix on its blocks ``w``
    (``wr``/``wk``/``wv``/``wg (d, d/m)``, ``wo (d/m, d)``, ``u (H/m,
    K)``; ``mu``, ``wA``, ``wB``, ``w0``, ``gn_w``, ``gn_b`` whole, of
    which it reads its heads' channels; the whole weights at m = 1): x
    (B, T, d), T = 1 when ``single``; ``state`` (B, H/m, K, V), its heads.
    Returns (its partial output (B, T, d), which the model ranks sum, x's
    last token, the new state).  A whole-sequence pass starts from the
    zero state, as forward and prefill do, and takes the chunked scan
    (B5; ``train``: ``wkv_chunked`` under autograd); a decode step
    carries ``state``."""
    b, n, _ = x.shape
    h, dh = w.u.shape[0], cfg.head_size
    dl = h * dh
    lo = m_idx * dl
    if w.wr.shape[1] != dl or w.wo.shape[0] != dl:
        raise ValueError(f"{cfg.name}: the time mix's blocks do not split "
                         f"by head ({tuple(w.wr.shape)} for {h} heads)")
    xs = _token_shift(x, tm_prev)
    mu = w.mu.to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    r = torch.einsum("btd,de->bte", xr, w.wr).reshape(b, n, h, dh)
    k = torch.einsum("btd,de->bte", xk, w.wk).reshape(b, n, h, dh)
    v = torch.einsum("btd,de->bte", xv, w.wv).reshape(b, n, h, dh)
    g = F.silu(torch.einsum("btd,de->bte", xg, w.wg))
    dlog = _decay_log(w, xw, lo, dl).reshape(b, n, h, dh)
    if single:
        y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], dlog[:, 0], w.u, state)
        y = y[:, None]
    elif train:
        y, state = wkv_chunked(r, k, v, dlog, w.u, state, cfg.rwkv_chunk,
                               cfg.rwkv_d_dtype)
    else:
        chunk = min(cfg.rwkv_chunk, n)
        if n % chunk:              # the reference asserts it (rwkv6.py:99)
            raise ValueError(f"{cfg.name}: T={n} is not a multiple of the "
                             f"chunk {chunk}")
        d_dtype = r.dtype if cfg.rwkv_d_dtype == "compute" else torch.float32
        y, state = wkv(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       dlog.transpose(1, 2), w.u, chunk=chunk, d_dtype=d_dtype)
        y = y.transpose(1, 2)
    y = layers.group_norm_heads(y.reshape(b, n, dl), w.gn_w.narrow(0, lo, dl),
                                w.gn_b.narrow(0, lo, dl), h, eps=1e-5)
    return torch.einsum("btd,de->bte", y * g, w.wo), x[:, -1], state


def time_mix(p: Layer, cfg, x, tm_prev, state, *, single: bool,
             train: bool = False):
    """The time mix (``time_mix_body``), under the split its partial
    outputs summed over ``model``, and the gradients of its input and of
    the weights every rank reads whole (``TIME_MIX_WHOLE``) summed over
    ``model``: (out, x's last token, the new state)."""
    w = collectives.layer_weights(p, TIME_MIX)
    tp = split_layer(w.u.shape[0] != cfg.n_heads)
    if tp is not None:
        for n in TIME_MIX_WHOLE:
            setattr(w, n, split_input(getattr(w, n), tp))
    out, last, state = time_mix_body(w, cfg, split_input(x, tp), tm_prev,
                                     state, 0 if tp is None else tp[2],
                                     single=single, train=train)
    return split_output(out, tp), last, state


def channel_mix_body(w, cfg, x, cm_prev, x_r=None):
    """A model rank's part of the channel mix on its blocks ``w``
    (``wk_c (d, f/m)``, ``wv_c (f/m, d)``, ``wr_c (d, d/m)``; whole at m =
    1): (its partial output (B, T, d), which the model ranks sum, the
    sigmoid gate of its ``wr_c`` channels, x's last token).  The layer's
    output is the gate times the summed output, channel for channel.
    ``x_r``, the same values as ``x``, feeds the gate where its gradient
    must not be summed with the products' (``channel_mix``)."""
    mu = w.mu_c.to(x.dtype)
    xs = _token_shift(x, cm_prev)
    xk = x + mu[0] * (xs - x)
    if x_r is None:
        xr = x + mu[1] * (xs - x)
    else:
        xr = x_r + mu[1] * (_token_shift(x_r, cm_prev) - x_r)
    k = torch.square(F.relu(torch.einsum("btd,df->btf", xk, w.wk_c)))
    out = torch.einsum("btf,fd->btd", k, w.wv_c)
    rgate = torch.sigmoid(torch.einsum("btd,de->bte", xr, w.wr_c))
    return out, rgate, x[:, -1]


def channel_mix(p: Layer, cfg, x, cm_prev):
    """The channel mix (``channel_mix_body``).  Under the split the
    partial outputs are reduce-scattered over ``model`` into the rank's
    gate channels, gated, and gathered whole (module docstring); where
    ``model`` splits only ``d_ff`` they are summed, where it splits only
    ``d`` each rank gates its channels of the whole output.  In the
    backward the whole gradient's channels of the rank come back from
    the gather, an all-gather gives every rank's partial the gradient of
    the sum, and the gradients of the input and of the weights a rank
    reads whole but uses in part are summed over ``model``: ``mu_c``, and
    ``wk_c``/``wv_c`` where only ``d`` splits; the gate's input and
    ``mu_c``'s gate row where ``d`` does not split feed a gate every rank
    computes alike, and keep their gradient."""
    w = collectives.layer_weights(p, CHANNEL_MIX)
    f_split = w.wk_c.shape[1] != cfg.d_ff
    d_split = w.wr_c.shape[1] != cfg.d_model
    tp = split_layer(f_split or d_split)
    if tp is None:
        out, rgate, last = channel_mix_body(w, cfg, x, cm_prev)
        return rgate * out, last
    x_k = split_input(x, tp)
    if d_split:
        x_r, w.mu_c = None, split_input(w.mu_c, tp)
    else:
        x_r = x
        w.mu_c = torch.stack([split_input(w.mu_c[0], tp), w.mu_c[1]])
    if not f_split:
        w.wk_c, w.wv_c = split_input(w.wk_c, tp), split_input(w.wv_c, tp)
    out, rgate, last = channel_mix_body(w, cfg, x_k, cm_prev, x_r)
    if not d_split:
        return rgate * split_output(out, tp), last
    mesh, chans = tp[0], (None, None, "model")
    if f_split:
        out = collectives.model_scatter(out, chans, mesh)
    else:
        out = out.narrow(2, tp[2] * rgate.shape[2], rgate.shape[2])
    return collectives.model_gather(rgate * out, chans, mesh,
                                    whole=True), last


def block(p: Layer, cfg, x, state: dict, i: int, *, single: bool,
          train: bool = False):
    """Layer ``i``: writes its ``tm_prev``, ``cm_prev`` and ``S`` into
    ``state`` in place, but in the training forward (``train``), which
    reads the zero state and writes nothing (a recomputed layer would
    write twice)."""
    h, tm_prev, s = time_mix(
        p, cfg, layers.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps),
        state["tm_prev"][i], state["S"][i], single=single, train=train)
    x = x + h
    h, cm_prev = channel_mix(
        p, cfg, layers.layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps),
        state["cm_prev"][i])
    if not train:
        state["tm_prev"][i].copy_(tm_prev)
        state["cm_prev"][i].copy_(cm_prev)
        state["S"][i].copy_(s)
    return x + h


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_state(cfg, batch: int, device=None) -> dict:
    """The zero state; under a mesh policy ``S`` holds the rank's heads
    (``sharding.serve_cache_shape``)."""
    dev = resolve(device)
    h, dh, d = cfg.n_heads, cfg.head_size, cfg.d_model
    policy = current_policy()
    h = sharding.serve_cache_shape(
        "S", (1, batch, h, dh, dh),
        policy.mesh if policy is not None else None)[2]
    dtype = getattr(torch, cfg.compute_dtype)
    return {"tm_prev": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                                   device=dev),
            "cm_prev": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                                   device=dev),
            "S": torch.zeros((cfg.n_layers, batch, h, dh, dh),
                             dtype=torch.float32, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    del max_len                    # a constant-size state, whatever the length
    return init_state(cfg, batch, device)


def _run(params: RWKV6, cfg, tokens, state, *, single: bool,
         train: bool = False):
    x = transformer._embed(params, cfg, tokens, train)
    x = layers.layer_norm(x, params.ln0_w, params.ln0_b, cfg.norm_eps)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params.layers):
        layer = functools.partial(block, p, cfg, state=state, i=i,
                                  single=single, train=train)
        x = (checkpoint(layer, x, use_reentrant=False,
                        preserve_rng_state=False) if remat else layer(x))
    return layers.layer_norm(x, params.final_norm_w, params.final_norm_b,
                             cfg.norm_eps)


def forward(params: RWKV6, cfg, tokens: torch.Tensor, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, Vp), aux loss 0); ``train`` is the
    training forward (module docstring)."""
    state = init_state(cfg, tokens.shape[0], params.embed.device)
    x = _run(params, cfg, tokens, state, single=False, train=train)
    return unembed(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params: RWKV6, cfg, tokens: torch.Tensor, max_len: int
            ) -> Tuple[torch.Tensor, dict]:
    """tokens (B, T), equal-length prompts -> (next-token logits (B, Vp),
    the state after them, ``pos = T``)."""
    b, n = tokens.shape
    state = init_state(cfg, b, params.embed.device)
    x = _run(params, cfg, tokens, state, single=False)
    state["pos"] = torch.full((), n, dtype=torch.int32, device=x.device)
    return unembed(params, cfg, x[:, -1:])[:, 0], state


def decode_step(params: RWKV6, cfg, cache: dict, token: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
    """token (B,): one step; updates ``cache`` in place and returns
    (logits (B, Vp), cache)."""
    x = _run(params, cfg, token[:, None], cache, single=True)
    cache["pos"].add_(1)
    return unembed(params, cfg, x)[:, 0], cache
