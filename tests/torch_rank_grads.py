"""Every ``model`` rank's training bodies of the recurrent families run in
one process, the mesh's collectives composed by hand, and their gradients
set beside the whole layer's (``tests/test_torch_megatron.py`` on the CPU,
``tests/test_torch_cuda.py`` on the card).

Each rank's blocks (``sharding.rank_blocks``) are leaves of their own that
take gradients; the layer input is one leaf that every rank reads, so
autograd sums its gradient over the ranks as ``collectives.sum_backward``
does.  Partial outputs are summed (the all-reduce), the RG-LRU's conv
outputs concatenated (the all-gather, whose backward hands each rank its
channels of the summed gradient), and RWKV6's channel mix gated on each
rank's channels of the summed output (the reduce-scatter and the gather).
``merged`` puts the ranks' gradients of a leaf back into the whole
leaf's: concatenated along the dim that ``model`` splits, else summed (a
weight every rank reads whole but uses in part).  Imports no JAX.
"""
import torch

from repro_torch.distributed import sharding
from repro_torch.models import layers, rglru, rwkv6

RWKV_NAMES = rwkv6.TIME_MIX + rwkv6.CHANNEL_MIX
# (module index in the superblock, reference path, names) of every block
# of a RecurrentGemma superblock
REC_PARTS = [(i, f"super/rec{i + 1}", rglru.REC) for i in (0, 1)] + [
    (2, "super/attn", rglru.ATTN)]


def leaf_blocks(mod, path, names, m, r):
    """Rank ``r``'s blocks of ``mod`` on a ``model`` axis of ``m``, each
    a leaf that takes a gradient."""
    w = sharding.rank_blocks(mod, path, names, m, r)
    for n in names:
        t = getattr(w, n)
        if t is not None:
            setattr(w, n, t.detach().clone().requires_grad_(True))
    return w


def _grads(loss, x, blocks):
    """(x's gradient, {(key, name): [each rank's gradient]}) of ``loss``
    over ``blocks``: {key: (names, [each rank's namespace])}."""
    leaves = [(key, n, getattr(w, n)) for key, (names, ws) in blocks.items()
              for w in ws for n in names if getattr(w, n) is not None]
    got = torch.autograd.grad(loss, [x] + [t for *_, t in leaves])
    out = {}
    for (key, n, _), g in zip(leaves, got[1:]):
        out.setdefault((key, n), []).append(g)
    return got[0], out


def merged(grads, mod, path, name, m):
    """The ranks' gradients of ``mod``'s leaf ``name`` (at ``path``) as
    the whole leaf's (module docstring)."""
    spec = sharding.compute_spec(f"{path}/{name}",
                                 tuple(getattr(mod, name).shape),
                                 sharding.model_rank(m, 0), train=False)
    dims = [i for i, e in enumerate(spec) if e is not None]
    g = [x.float() for x in grads]
    return torch.cat(g, dims[0]) if dims else sum(g[1:], g[0])


def rwkv6_layer(layer, cfg, x, m, c):
    """One RWKV6 layer's time mix and channel mix (training bodies, from
    the zero state) on every rank of a ``model`` axis of ``m`` over ``x``
    (B, T, d); the loss ``(tm * c[0]).sum() + (cm * c[1]).sum()`` in
    float32.  Returns (x's gradient, {name: the merged gradient})."""
    b, d = x.shape[0], cfg.d_model
    ws = [leaf_blocks(layer, "layers", RWKV_NAMES, m, r) for r in range(m)]
    xx = x.detach().clone().requires_grad_(True)
    prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    tm = sum(rwkv6.time_mix_body(
        w, cfg, xx, prev, torch.zeros((b, w.u.shape[0], cfg.head_size,
                                       cfg.head_size), device=x.device),
        r, single=False, train=True)[0].float() for r, w in enumerate(ws))
    parts = [rwkv6.channel_mix_body(w, cfg, xx, prev) for w in ws]
    total = sum(p[0].float() for p in parts)
    dl = d // m
    cm = torch.cat([p[1].float() * total[..., r * dl:(r + 1) * dl]
                    for r, p in enumerate(parts)], -1)
    loss = (tm * c[0]).sum() + (cm * c[1]).sum()
    gx, g = _grads(loss, xx, {"": (RWKV_NAMES, ws)})
    return gx, {n: merged(g[("", n)], layer, "layers", n, m)
                for n in RWKV_NAMES}


def rglru_superblock(model, cfg, x, m, c):
    """A RecurrentGemma superblock (layers 0-2 of ``model``: rec, rec,
    attn, each with its MLP; the norms whole) trained on every rank of a
    ``model`` axis of ``m`` over ``x`` (B, T, d) from the zero states; the
    attention on each rank's query heads where they divide ``m``, else on
    rank 0 alone (every rank computes it alike); the loss ``(out *
    c).sum()`` in float32.  Returns (x's gradient, {(layer, name): the
    merged gradient})."""
    b, n, _ = x.shape
    eps = cfg.norm_eps
    blocks = {}
    for i, path, names in REC_PARTS:
        p = model.layers[i]
        ranks = (range(m) if names is not rglru.ATTN
                 or cfg.n_heads % m == 0 else [0])
        blocks[i] = (names, [leaf_blocks(p, path, names, m, r)
                             for r in ranks])
        blocks[f"{i}/mlp"] = (rglru.MLP_NAMES, [
            leaf_blocks(p.mlp, f"{path}/mlp", rglru.MLP_NAMES, m, r)
            for r in range(m)])
    xx = x.detach().clone().requires_grad_(True)
    positions = torch.arange(n, dtype=torch.int32,
                             device=x.device)[None].expand(b, n)
    h = xx
    for i, _, names in REC_PARTS:
        p, ws = model.layers[i], blocks[i][1]
        y = layers.rms_norm(h, p.norm1.detach(), eps)
        if names is rglru.ATTN:
            h = h + sum(rglru.attention_full_body(w, cfg, y, positions)[0]
                        for w in ws)
        else:
            k = cfg.rnn_width // m
            conv = torch.zeros((b, cfg.conv_width - 1, k), dtype=x.dtype,
                               device=x.device)
            h0 = torch.zeros((b, k), device=x.device)
            ins = [rglru.rec_in_body(w, cfg, y, conv) for w in ws]
            bx_all = torch.cat([t[0] for t in ins], -1)
            h = h + sum(rglru.rec_out_body(w, cfg, bx_all, ins[r][1], h0, r,
                                           single=False, train=True)[0]
                        for r, w in enumerate(ws))
        y = layers.rms_norm(h, p.norm2.detach(), eps)
        h = h + sum(rglru.mlp_body(w, y) for w in blocks[f"{i}/mlp"][1])
    gx, g = _grads((h.float() * c).sum(), xx, blocks)
    out = {}
    for i, path, names in REC_PARTS:
        p = model.layers[i]
        for key, mod, where, nm in ((i, p, path, names),
                                    (f"{i}/mlp", p.mlp, f"{path}/mlp",
                                     rglru.MLP_NAMES)):
            for name in nm:
                if (key, name) in g:
                    out[(key, name)] = merged(
                        g[(key, name)], mod, where, name,
                        len(blocks[key][1]))
    return gx, out


def worst(got: dict, want: dict) -> float:
    """The largest of each gradient's max abs difference over its own
    largest magnitude."""
    assert got.keys() == want.keys(), (got.keys() ^ want.keys())
    return max(float((got[k] - want[k].float()).abs().max())
               / max(float(want[k].float().abs().max()), 1e-30)
               for k in want)
