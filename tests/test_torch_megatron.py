"""The Megatron split of the transformer families over ``model``, on the
CPU without a process group: every model rank's body (attention on its
heads, the MLP on its ff columns, the embedding and the logits on its
vocab rows, the cross entropy's terms), run one after another in one
process on its blocks (``sharding.rank_blocks``) and summed by hand,
against the port's whole layer and the JAX reference's function on the
same weights, for model axes of 2 and 4; the recurrent families'
training bodies' gradients, every rank's composed in one process
(``tests/torch_rank_grads.py``), against the whole layer's.

The configurations cover the split's cases: KV heads that divide the
model axis (each rank its ``KV/m``), that do not (the whole KV on every
rank, each rank reading its query heads' groups: qwen with 2 KV heads on
4 ranks, granite's single KV head, and 6 query heads over 3 KV heads on 2
ranks, whose groups straddle the ranks), query heads that do not divide
(every rank computes the whole attention), and an ff width that does not
divide.  Everything is float32: a rank's partial outputs summed in
another order than one product's stay within ``TP_TOL`` of the largest
output; against the reference the layers' ``REF_TOL``
(``tests/test_torch_lm.py``'s attention tolerance).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attn import ref as da_ref
from repro_torch.models import encdec, io, model as model_lib, rglru, rwkv6
from repro_torch.models import transformer

TP_TOL = 1e-5          # of the largest output: partial sums reordered
REF_TOL = 2e-5         # against the reference, as tests/test_torch_lm.py
MS = (2, 4)

# (arch, overrides): the attention's cases (module docstring)
ATTN_CASES = [("qwen1.5-0.5b", {"n_kv_heads": 2}),
              ("starcoder2-15b", {}),
              ("granite-34b", {}),
              ("qwen1.5-0.5b", {"n_heads": 6, "n_kv_heads": 3}),
              ("dbrx-132b", {})]
ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the file runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(cases):
    return [f"{a}-" + "-".join(f"{k}{v}" for k, v in o.items())
            for a, o in cases]


def _cfgs(arch, over):
    return (reduce_config(get_config(arch), **over),
            jax_reduce_config(jax_get_config(arch), **over))


def _j(x):
    return jnp.asarray(x.detach().numpy())


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1.0))


def _rank_outputs(split, m, body):
    """Every model rank's body output summed, or, where ``model`` does not
    split the layer, each rank's alike (the whole computed on every
    rank): returns that sum or rank 0's."""
    outs = [body(r) for r in range(m)]
    if not split:
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        return outs[0]
    return sum(outs[1:], outs[0])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch,over", ATTN_CASES, ids=_ids(ATTN_CASES))
def test_attention_bodies_sum_to_the_whole_layer(arch, over, m, train):
    """``attention_body`` on every rank's heads, summed, against the whole
    layer (the flash plain version when serving, ``blockwise_attention``
    when training) and the reference's ``attention_full``; each rank's
    k/v are its KV heads of the whole layer's, or all of them where the
    KV heads do not divide."""
    cfg, jcfg = _cfgs(arch, over)
    attn = transformer.init_params(cfg, seed=3, device="cpu").layers[0].attn
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, 24, cfg.d_model)),
                        dtype=torch.float32)
    pos = transformer._positions(2, 24, "cpu")
    whole = sharding.rank_blocks(attn, "layers/attn", ATTN, 1, 0)
    with torch.no_grad():
        want, k, v = transformer.attention_body(whole, cfg, x, pos, 0, train)
    split, kv_split = cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0

    def body(r):
        w = sharding.rank_blocks(attn, "layers/attn", ATTN, m, r)
        with torch.no_grad():
            out, kr, vr = transformer.attention_body(w, cfg, x, pos, r, train)
        n = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
        lo = r * n if kv_split else 0
        assert torch.equal(kr, k[:, :, lo:lo + n])
        assert torch.equal(vr, v[:, :, lo:lo + n])
        return out

    got = _rank_outputs(split, m, body)
    _close(got.numpy(), want.numpy(), TP_TOL)
    _close(got.numpy(), _reference_attention(arch, tuple(over.items())),
           REF_TOL)


@functools.lru_cache(maxsize=None)
def _reference_attention(arch, over):
    """The reference's ``attention_full`` on the weights and input of
    ``test_attention_bodies_sum_to_the_whole_layer`` (one compile a
    configuration)."""
    cfg, jcfg = _cfgs(arch, dict(over))
    attn = transformer.init_params(cfg, seed=3, device="cpu").layers[0].attn
    x = np.random.default_rng(4).standard_normal((2, 24, cfg.d_model))
    pos = transformer._positions(2, 24, "cpu")
    jp = {n: _j(getattr(attn, n)) for n in ATTN
          if getattr(attn, n) is not None}
    ref, _, _ = jax.jit(lambda p, x, q: jtf.attention_full(p, jcfg, x, q))(
        jp, jnp.asarray(x, jnp.float32), _j(pos))
    return np.asarray(ref)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch,over", ATTN_CASES, ids=_ids(ATTN_CASES))
def test_decode_bodies_sum_to_the_whole_step(arch, over, m):
    """``attention_decode_body`` on every rank's heads and its part of the
    cache (its KV heads, or all), summed, against the whole step; each
    rank's cache after the step is its part of the whole one's."""
    cfg, _ = _cfgs(arch, over)
    attn = transformer.init_params(cfg, seed=5, device="cpu").layers[0].attn
    rng = np.random.default_rng(6)
    b, s = 3, 20
    x = torch.as_tensor(rng.standard_normal((b, 1, cfg.d_model)),
                        dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal(
        (b, s, cfg.n_kv_heads, cfg.d_head)), dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal(kc.shape), dtype=torch.float32)
    pos = torch.tensor([4, 11, 19], dtype=torch.int32)
    slot = pos.long()
    lengths = pos + 1
    kv_pos = torch.where(torch.arange(s)[None] <= pos[:, None],
                         torch.arange(s)[None], -1).to(torch.int32)
    whole = sharding.rank_blocks(attn, "layers/attn", ATTN, 1, 0)
    wk, wv = kc.clone(), vc.clone()
    with torch.no_grad():
        want = transformer.attention_decode_body(
            whole, cfg, x, pos, slot, wk, wv, kv_pos, lengths)
    split, kv_split = cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0

    def body(r):
        n = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
        lo = r * n if kv_split else 0
        rk = kc[:, :, lo:lo + n].clone()
        rv = vc[:, :, lo:lo + n].clone()
        w = sharding.rank_blocks(attn, "layers/attn", ATTN, m, r)
        with torch.no_grad():
            out = transformer.attention_decode_body(
                w, cfg, x, pos, slot, rk, rv, kv_pos, lengths, r)
        assert torch.equal(rk, wk[:, :, lo:lo + n])
        assert torch.equal(rv, wv[:, :, lo:lo + n])
        return out

    got = _rank_outputs(split, m, body)
    _close(got.numpy(), want.numpy(), TP_TOL)


def test_kv_heads_maps_query_heads_to_their_groups():
    """``kv_heads``: None where a rank holds its own KV block or all heads
    are its own; else one index per run of gcd(n_q, G) query heads, the
    group of the run's first head."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"), n_heads=6, n_kv_heads=3)
    assert transformer.kv_heads(6, 3, cfg, 0) is None
    assert transformer.kv_heads(3, 3, cfg, 0) == [0, 0, 1]
    assert transformer.kv_heads(3, 3, cfg, 1) == [1, 2, 2]
    cfg = reduce_config(get_config("qwen1.5-0.5b"), n_heads=8, n_kv_heads=2)
    assert transformer.kv_heads(2, 1, cfg, 3) is None     # its own block
    assert transformer.kv_heads(2, 2, cfg, 3) == [1]      # G 4: one group
    assert transformer.kv_heads(4, 2, cfg, 1) == [1]
    x = torch.arange(24.).reshape(1, 2, 3, 4)
    assert transformer.take_heads(x, [1, 2], 2).data_ptr() == \
        x[:, :, 1].data_ptr()
    assert torch.equal(transformer.take_heads(x, [0, 0, 1], 2),
                       x[:, :, [0, 0, 1]])


# ---------------------------------------------------------------------------
# MLP, embedding, logits and loss
# ---------------------------------------------------------------------------

MLP_CASES = [("qwen1.5-0.5b", {}), ("qwen1.5-0.5b", {"d_ff": 70})]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch,over", MLP_CASES, ids=_ids(MLP_CASES))
def test_mlp_bodies_sum_to_the_whole_layer(arch, over, m):
    """``mlp_body`` on every rank's ff columns (``w_gate``/``w_up``) and
    rows (``w_down``), summed, against the whole SwiGLU and the
    reference's ``mlp_block``; an ff of 70 splits over 2 ranks and stays
    whole over 4."""
    cfg, jcfg = _cfgs(arch, over)
    mlp = transformer.init_params(cfg, seed=7, device="cpu").layers[0].mlp
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (2, 10, cfg.d_model)), dtype=torch.float32)
    names = ("w_gate", "w_up", "w_down")
    with torch.no_grad():
        want = transformer.mlp_body(
            sharding.rank_blocks(mlp, "layers/mlp", names, 1, 0), x)
        got = _rank_outputs(
            cfg.d_ff % m == 0, m,
            lambda r: transformer.mlp_body(
                sharding.rank_blocks(mlp, "layers/mlp", names, m, r), x))
    _close(got.numpy(), want.numpy(), TP_TOL)
    ref = jax.jit(lambda p, x: jtf.mlp_block(p, jcfg, x))(
        {n: _j(getattr(mlp, n)) for n in names}, _j(x))
    _close(got.numpy(), np.asarray(ref), REF_TOL)


@pytest.mark.parametrize("m", MS)
def test_embedding_and_logits_bodies_make_the_whole(m):
    """The vocab-parallel embedding: every rank's ``embed_body`` (its rows,
    zeros elsewhere; negative ids read from the end), summed, is the whole
    lookup bit for bit and the reference's; the tied ``unembed_body`` on
    every rank's vocab rows, side by side, is the whole logits with the
    padded ids masked by their global index, and the reference's."""
    cfg, jcfg = _cfgs("qwen1.5-0.5b", {})
    assert cfg.tie_embeddings and cfg.vocab_padded > cfg.vocab
    model = transformer.init_params(cfg, seed=9, device="cpu")
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(-3, cfg.vocab, (3, 12)),
                           dtype=torch.int32)
    ids = toks.remainder(cfg.vocab_padded)
    vl = cfg.vocab_padded // m
    blocks = [sharding.rank_blocks(model, "", ("embed",), m, r).embed
              for r in range(m)]
    assert all(b.shape[0] == vl for b in blocks)
    with torch.no_grad():
        got = sum(transformer.embed_body(blocks[r], ids, r * vl)
                  for r in range(m))
        assert torch.equal(got, transformer._embed(model, cfg, toks))
        x = torch.as_tensor(rng.standard_normal((3, 12, cfg.d_model)),
                            dtype=torch.float32)
        want = transformer.unembed(model, cfg, x)
        logits = torch.cat([transformer.unembed_body(blocks[r], cfg, x,
                                                     r * vl, tied=True)
                            for r in range(m)], -1)
    jemb = _j(model.embed)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jemb[jnp.asarray(ids.numpy())]))
    _close(logits.numpy(), want.numpy(), TP_TOL)
    assert bool((logits[..., cfg.vocab:] == -1e9).all())
    ref = jax.jit(lambda p, x: jtf.unembed(p, jcfg, x))({"embed": jemb},
                                                         _j(x))
    _close(logits.numpy(), np.asarray(ref), REF_TOL)


@pytest.fixture(scope="module")
def loss_case():
    """Reduced qwen on the reference's weights, 3 x 16 tokens with masked
    targets: (cfg, the port's model, tokens, the reference's loss)."""
    cfg, jcfg = _cfgs("qwen1.5-0.5b", {})
    jparams = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    model = io.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    toks[1, 5:] = -1                                  # masked targets
    _, jm = jax.jit(lambda p, b: jmodel.lm_loss(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    return cfg, model, torch.as_tensor(toks), float(jm["loss"])


@pytest.mark.parametrize("m", MS)
def test_vocab_parallel_cross_entropy_is_the_reference_loss(loss_case, m):
    """The loss from every rank's vocab slice of the logits: the maximum
    over the ranks' maxima, then ``cross_entropy_parts`` (the sum of
    exponentials, the label's logit from the rank that holds it) summed
    over the ranks; on reduced qwen's carried weights, the masked mean
    equals the reference's ``lm_loss`` and the port's whole-vocab one."""
    cfg, model, tokens, ref = loss_case
    with torch.no_grad():
        logits, _ = model_lib.forward(model, cfg, tokens, train=True)
        whole, metrics = model_lib.lm_loss(model, cfg, {"tokens": tokens})
    logits, targets = logits[:, :-1], tokens[:, 1:].long()
    vl = cfg.vocab_padded // m
    parts = [logits[..., r * vl:(r + 1) * vl] for r in range(m)]
    mx = torch.stack([p.amax(-1).float() for p in parts]).amax(0)
    terms = [model_lib.cross_entropy_parts(p, targets, mx, r * vl)
             for r, p in enumerate(parts)]
    s = sum(t[0] for t in terms)
    label = sum(t[1] for t in terms)
    mask = (targets >= 0).float()
    loss = ((mx + torch.log(s) - label) * mask).sum() / mask.sum()
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# Enc-dec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("which", ["self", "cross"])
def test_encdec_attention_bodies_sum_to_the_whole(which, m, train):
    """Whisper's ``mha_body`` on every rank's heads, summed (self-attention
    causal, cross-attention over 20 encoder frames unmasked), against the
    whole attention and the reference's ``_mha``."""
    cfg, jcfg = _cfgs("whisper-medium", {})
    lp = encdec.init_params(cfg, seed=13, device="cpu").dec_layers[0]
    p = lp.self_attn if which == "self" else lp.cross_attn
    rng = np.random.default_rng(14)
    xq = torch.as_tensor(rng.standard_normal((2, 9, cfg.d_model)),
                         dtype=torch.float32)
    xkv = xq if which == "self" else torch.as_tensor(
        rng.standard_normal((2, 20, cfg.d_model)), dtype=torch.float32)
    causal = which == "self"
    path = f"dec_layers/{which}_attn"
    run = lambda w: encdec.mha_body(w, cfg, xq, xkv, causal=causal,
                                    train=train)
    with torch.no_grad():
        want = run(sharding.rank_blocks(p, path, encdec.MHA_NAMES, 1, 0))
        got = sum(run(sharding.rank_blocks(p, path, encdec.MHA_NAMES, m, r))
                  for r in range(m))
    _close(got.numpy(), want.numpy(), TP_TOL)
    ref, _, _ = jax.jit(lambda p, a, b: jencdec._mha(p, jcfg, a, b,
                                                     causal=causal))(
        {n: _j(getattr(p, n)) for n in encdec.MHA_NAMES}, _j(xq), _j(xkv))
    _close(got.numpy(), np.asarray(ref), REF_TOL)


@pytest.mark.parametrize("m", MS)
def test_encdec_mlp_bodies_sum_to_the_whole(m):
    """Whisper's GELU MLP: ``mlp_body`` on every rank's ``w1``/``b1``
    columns and ``w2`` rows, summed, then ``b2`` once, against the whole
    MLP and the reference's ``_mlp`` (random nonzero biases)."""
    cfg, _ = _cfgs("whisper-medium", {})
    mlp = encdec.init_params(cfg, seed=15, device="cpu").enc_layers[0].mlp
    rng = np.random.default_rng(16)
    with torch.no_grad():
        for n in ("b1", "b2"):
            getattr(mlp, n).copy_(torch.as_tensor(
                rng.standard_normal(getattr(mlp, n).shape)))
    x = torch.as_tensor(rng.standard_normal((2, 7, cfg.d_model)),
                        dtype=torch.float32)
    with torch.no_grad():
        want = encdec._mlp(mlp, cfg, x)
        got = sum(encdec.mlp_body(sharding.rank_blocks(
            mlp, "enc_layers/mlp", encdec.MLP_NAMES, m, r), x)
            for r in range(m)) + mlp.b2
    _close(got.numpy(), want.numpy(), TP_TOL)
    ref = jax.jit(jencdec._mlp)({n: _j(getattr(mlp, n))
                                 for n in encdec.MLP_NAMES}, _j(x))
    _close(got.numpy(), np.asarray(ref), REF_TOL)


def test_compute_spec_keeps_model_and_gathers_the_data_axes():
    """``compute_spec`` is ``param_spec`` with the data axes gathered: on
    a 2 x 2 training mesh ``wq`` computes as ``(None, "model", None)``,
    granite's single KV head leaves ``wk`` whole, the embedding splits its
    vocab; ``rank_blocks`` cuts by it."""
    mesh = sharding.Coord({"data": 2, "model": 2}, {"data": 1, "model": 1})
    assert sharding.param_spec("layers/attn/wq", (2, 64, 4, 16), mesh,
                               train=True) == (None, "data", "model", None)
    assert sharding.compute_spec("layers/attn/wq", (2, 64, 4, 16), mesh,
                                 train=True) == (None, None, "model", None)
    assert sharding.compute_spec("layers/attn/wk", (64, 1, 16), mesh,
                                 train=True) == (None, None, None)
    assert sharding.compute_spec("embed", (2048, 64), mesh,
                                 train=True) == ("model", None)
    w = torch.arange(2048 * 4.).reshape(2048, 4)
    got = sharding.rank_blocks(torch.nn.Module(), "", (), 2, 1)
    assert vars(got) == {}
    holder = type("H", (), {"embed": w})()
    assert torch.equal(sharding.rank_blocks(holder, "", ("embed",), 4,
                                            3).embed, w[1536:])


# ---------------------------------------------------------------------------
# The recurrent families over ``model``
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rwkv_case(single):
    """Reduced rwkv6-7b's first layer, inputs of a 2 x 16 prefill (or one
    decode token from a random state) and the reference's ``time_mix`` and
    ``channel_mix`` on them (one compile a case)."""
    cfg, jcfg = _cfgs("rwkv6-7b", {})
    layer = rwkv6.init_params(cfg, seed=17, device="cpu").layers[0]
    rng = np.random.default_rng(18)
    t = 1 if single else 16
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32)
    x, tm_prev, cm_prev = f32(2, t, cfg.d_model), f32(2, cfg.d_model), \
        f32(2, cfg.d_model)
    state = (f32(2, cfg.n_heads, cfg.head_size, cfg.head_size) if single
             else torch.zeros(2, cfg.n_heads, cfg.head_size, cfg.head_size))
    jp = {n: _j(getattr(layer, n)) for n in rwkv6.TIME_MIX + rwkv6.CHANNEL_MIX}
    jout, _, jstate = jax.jit(lambda p, a, b, c: jrwkv6.time_mix(
        p, jcfg, a, b, c, single=single))(jp, _j(x), _j(tm_prev), _j(state))
    jcm, _ = jax.jit(lambda p, a, b: jrwkv6.channel_mix(p, jcfg, a, b))(
        jp, _j(x), _j(cm_prev))
    return cfg, layer, (x, tm_prev, cm_prev, state), tuple(
        np.asarray(a) for a in (jout, jstate, jcm))


@pytest.mark.parametrize("single", [False, True], ids=["prefill", "decode"])
@pytest.mark.parametrize("m", MS)
def test_rwkv6_bodies_sum_to_the_whole_layer(m, single):
    """RWKV6's time mix on every rank's ``H/m`` heads (``wr``/``wk``/
    ``wv``/``wg`` columns, ``wo`` rows, ``u``, and its heads' channels of
    ``wB``, ``w0`` and the group norm; B5's plain version, or the decode's
    step from the rank's heads of a random state), the partial outputs
    summed and the states side by side; the channel mix's partial outputs
    summed and each rank's ``wr_c`` gate applied to its channels: against
    the port's whole layer and the reference's ``time_mix`` and
    ``channel_mix``."""
    cfg, layer, (x, tm_prev, cm_prev, state), ref = _rwkv_case(single)
    h = cfg.n_heads // m
    tm = lambda mm, r: sharding.rank_blocks(layer, "layers", rwkv6.TIME_MIX,
                                            mm, r)
    cm = lambda mm, r: sharding.rank_blocks(layer, "layers",
                                            rwkv6.CHANNEL_MIX, mm, r)
    with torch.no_grad():
        want, _, s_want = rwkv6.time_mix_body(tm(1, 0), cfg, x, tm_prev,
                                              state.clone(), single=single)
        outs, states = [], []
        for r in range(m):
            w = tm(m, r)
            assert w.u.shape[0] == h and w.wk.shape[1] == h * cfg.head_size
            assert w.wo.shape[0] == h * cfg.head_size
            o, _, s = rwkv6.time_mix_body(
                w, cfg, x, tm_prev, state[:, r * h:(r + 1) * h].clone(), r,
                single=single)
            outs.append(o)
            states.append(s)
        out, rgate, _ = rwkv6.channel_mix_body(cm(1, 0), cfg, x, cm_prev)
        parts = [rwkv6.channel_mix_body(cm(m, r), cfg, x, cm_prev)
                 for r in range(m)]
    got, got_s = sum(outs[1:], outs[0]), torch.cat(states, 1)
    total = sum(p[0] for p in parts)
    dl = cfg.d_model // m
    gated = torch.cat([p[1] * total[..., r * dl:(r + 1) * dl]
                       for r, p in enumerate(parts)], -1)
    _close(got.numpy(), want.numpy(), TP_TOL)
    _close(got_s.numpy(), s_want.numpy(), TP_TOL)
    _close(gated.numpy(), (rgate * out).numpy(), TP_TOL)
    for a, b in zip((got, got_s, gated), ref):
        _close(a.numpy(), b, REF_TOL)


REC_CFG = ("recurrentgemma-2b", {"n_heads": 6, "window": 16})


@pytest.mark.parametrize("single", [False, True], ids=["prefill", "decode"])
@pytest.mark.parametrize("m", MS)
def test_rglru_recurrent_bodies_sum_to_the_whole_block(m, single):
    """The recurrent block on every rank's ``rnn/m`` channels: each rank's
    ``rec_in_body`` (``w_x``, ``w_gate``, the conv on its channels), the
    conv outputs side by side (the gather), each rank's ``rec_out_body``
    (its columns of ``w_r``/``w_i``, B6's plain version or the decode's
    step on its channels, ``w_out`` rows), summed; the states side by
    side; the GeGLU MLP's bodies summed: against the port's whole block
    and the reference's ``rec_block``."""
    cfg, jcfg = _cfgs(*REC_CFG)
    layer = rglru.init_params(cfg, seed=21, device="cpu").layers[0]
    rng = np.random.default_rng(22)
    t, r_w, cw = (1 if single else 12), cfg.rnn_width, cfg.conv_width
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32)
    x, conv, h0 = f32(2, t, cfg.d_model), f32(2, cw - 1, r_w), f32(2, r_w)
    blocks = lambda mm, r: sharding.rank_blocks(layer, "super/rec1",
                                                rglru.REC, mm, r)
    n = r_w // m
    with torch.no_grad():
        bx, gate, c_want = rglru.rec_in_body(blocks(1, 0), cfg, x, conv)
        want, h_want = rglru.rec_out_body(blocks(1, 0), cfg, bx, gate, h0,
                                          single=single)
        ins = [rglru.rec_in_body(blocks(m, r), cfg, x,
                                 conv[..., r * n:(r + 1) * n])
               for r in range(m)]
        bx_all = torch.cat([i[0] for i in ins], -1)
        outs = [rglru.rec_out_body(blocks(m, r), cfg, bx_all, ins[r][1],
                                   h0[:, r * n:(r + 1) * n], r,
                                   single=single) for r in range(m)]
        mlp = lambda mm, r: rglru.mlp_body(sharding.rank_blocks(
            layer.mlp, "super/rec1/mlp", rglru.MLP_NAMES, mm, r), x)
        mlp_want, mlp_got = mlp(1, 0), sum(mlp(m, r) for r in range(m))
    got = sum(o[0] for o in outs)
    got_h = torch.cat([o[1] for o in outs], -1)
    got_c = torch.cat([i[2] for i in ins], -1)
    _close(got.numpy(), want.numpy(), TP_TOL)
    _close(got_h.numpy(), h_want.numpy(), TP_TOL)
    assert torch.equal(got_c, c_want)
    _close(mlp_got.numpy(), mlp_want.numpy(), TP_TOL)
    jp = {n: _j(getattr(layer, n)) for n in rglru.REC}
    jout, jst = jax.jit(lambda p, a, s: jrglru.rec_block(
        p, jcfg, a, s, single=single))(jp, _j(x), {"h": _j(h0),
                                                  "conv": _j(conv)})
    _close(got.numpy(), np.asarray(jout), REF_TOL)
    _close(got_h.numpy(), np.asarray(jst["h"]), REF_TOL)


# every rank's training bodies' gradients, merged, against the whole
# layer's, each of its largest magnitude: float32 partial sums reordered
GRAD_TOL = 1e-5


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_recurrent_training_bodies_backward_to_the_whole_layer(arch, m):
    """The training bodies' backward on every rank of a model axis of
    ``m``, composed in one process (``tests/torch_rank_grads.py``): one
    RWKV6 layer's time mix and channel mix (``wkv_chunked``) and one
    RecurrentGemma superblock (``rg_lru_scan_train``; 6 query heads,
    split over 2 ranks and whole over 4) over 2 x 16 tokens; the input's
    gradient summed over the ranks, the split weights' concatenated and
    the weights every rank reads whole summed equal the whole layer's."""
    import torch_rank_grads as trg

    cfg = _cfgs(*(REC_CFG if arch == "recurrentgemma-2b" else (arch, {})))[0]
    rng = np.random.default_rng(31)
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32)
    x = f32(2, 16, cfg.d_model)
    if arch == "rwkv6-7b":
        layer = rwkv6.init_params(cfg, seed=32, device="cpu").layers[0]
        c = f32(2, 2, 16, cfg.d_model)
        run = lambda mm: trg.rwkv6_layer(layer, cfg, x, mm, c)
    else:
        model = rglru.init_params(cfg, seed=33, device="cpu")
        c = f32(2, 16, cfg.d_model)
        run = lambda mm: trg.rglru_superblock(model, cfg, x, mm, c)
    gx_want, want = run(1)
    gx, got = run(m)
    _close(gx.numpy(), gx_want.numpy(), GRAD_TOL)
    assert trg.worst(got, want) <= GRAD_TOL
    assert min(float(g.abs().max()) for g in want.values()) > 0


@pytest.mark.parametrize("m", MS)
def test_rglru_attention_bodies_with_the_ring_split_by_sequence(m):
    """The local attention on every rank: a 2 x 24 prefill on its query
    heads (6: 3 a rank over 2, all over 4, where every rank's output is
    the whole and nothing is summed); a decode at position 24 against a
    ring of 16 split by sequence (4 or 8 slots a rank): each rank's
    ``decode_query``, ``q`` gathered by hand where the heads split, the
    token's K/V written only into the owner's slots, each rank's
    ``ring_attend`` with its log-sum-exp, the partial softmaxes merged
    (``merge_partials``), each rank's heads through its ``wo``: against
    the whole layer, and the merged output against the reference's
    ``decode_attention`` over the whole ring."""
    cfg, _ = _cfgs(*REC_CFG)
    layer = rglru.init_params(cfg, seed=23, device="cpu").layers[2]
    rng = np.random.default_rng(24)
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32)
    b, s, w_all = 2, 24, cfg.window
    x = f32(b, s, cfg.d_model)
    positions = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    blocks = lambda mm, r: sharding.rank_blocks(layer, "super/attn",
                                                rglru.ATTN, mm, r)
    split = cfg.n_heads % m == 0
    with torch.no_grad():
        want, k, v = rglru.attention_full_body(blocks(1, 0), cfg, x,
                                               positions)
        got = _rank_outputs(split, m, lambda r: rglru.attention_full_body(
            blocks(m, r), cfg, x, positions)[0])
    _close(got.numpy(), want.numpy(), TP_TOL)

    # the ring after the prompt: positions 8 .. 23 at slot p % 16
    kept = torch.arange(s - w_all, s, dtype=torch.int32)
    order = torch.argsort(kept % w_all)
    ring = {"k": k[:, -w_all:][:, order], "v": v[:, -w_all:][:, order],
            "kv_pos": kept[order][None].expand(b, w_all).contiguous()}
    pos = torch.tensor(s, dtype=torch.int32)
    slot = int(pos) % w_all
    xd = f32(b, 1, cfg.d_model)
    with torch.no_grad():
        q, kn, vn = rglru.decode_query(blocks(1, 0), cfg, xd, pos)
        whole = {n: t.clone() for n, t in ring.items()}
        whole["k"][:, slot], whole["v"][:, slot] = kn, vn
        whole["kv_pos"][:, slot] = pos
        o_want = transformer.decode_attn(
            q, whole["k"].transpose(1, 2), whole["v"].transpose(1, 2),
            kv_pos=whole["kv_pos"], pos=pos)
        d_want = rglru.attention_out(blocks(1, 0), o_want)
        qs = [rglru.decode_query(blocks(m, r), cfg, xd, pos)
              for r in range(m)]
        q_all = torch.cat([t[0] for t in qs], 1) if split else qs[0][0]
        n = w_all // m
        partial = []
        for r in range(m):
            st = {"k": ring["k"][:, r * n:(r + 1) * n].clone(),
                  "v": ring["v"][:, r * n:(r + 1) * n].clone(),
                  "kv_pos": whole["kv_pos"]}
            transformer.write_owned(st["k"], st["v"], qs[r][1], qs[r][2],
                                    pos % w_all, r * n)
            assert torch.equal(st["k"], whole["k"][:, r * n:(r + 1) * n])
            assert torch.equal(st["v"], whole["v"][:, r * n:(r + 1) * n])
            partial.append(rglru.ring_attend(q_all, st, pos, r * n))
        merged = da_ref.merge_partials([p[0] for p in partial],
                                       [p[1] for p in partial])
        hq = qs[0][0].shape[1]
        d_got = _rank_outputs(split, m, lambda r: rglru.attention_out(
            blocks(m, r), transformer.own_heads(merged, hq, r)))
    assert torch.equal(q_all, q)
    _close(merged.numpy(), o_want.numpy(), TP_TOL)
    _close(d_got.numpy(), d_want.numpy(), TP_TOL)
    ref = jlayers.decode_attention(_j(q), _j(whole["k"]), _j(whole["v"]),
                                   _j(whole["kv_pos"]), _j(pos))
    _close(merged.numpy(), np.asarray(ref), REF_TOL)


# ---------------------------------------------------------------------------
# The sequence split of the transformer's cache
# ---------------------------------------------------------------------------

# (arch, overrides, m): KV heads that do not divide m -- granite's one KV
# head (full attention), qwen's 2 on 4 ranks, danube's sliding-window ring
# with one KV head, and 6 query heads over one KV head (whole on every
# rank of 4: nothing summed)
SEQ_CASES = [(a, o, m) for a, o, ms in (
    ("granite-34b", {}, MS),
    ("qwen1.5-0.5b", {"n_kv_heads": 2}, (4,)),
    ("h2o-danube-3-4b", {"n_kv_heads": 1}, MS),
    ("qwen1.5-0.5b", {"n_heads": 6, "n_kv_heads": 1}, MS)) for m in ms]


@pytest.mark.parametrize("arch,over,m", SEQ_CASES,
                         ids=[f"{i}-m{c[2]}" for i, c in
                              zip(_ids([c[:2] for c in SEQ_CASES]),
                                  SEQ_CASES)])
def test_sequence_split_decode_merges_to_the_whole_step(arch, over, m):
    """One decode step of a cache of 16 slots split by sequence over m
    ranks: each rank's ``decode_query``, ``q`` gathered by hand where the
    heads split, the token's K/V written only where a rank owns the row's
    slot (``write_owned``; rows whose slots fall on different ranks), its
    ``seq_attend`` under ``lengths`` (full attention: its valid slots
    ``clamp(lengths - lo, 0, S/m)``) or the whole ``kv_pos`` (the ring),
    the ranks' partial softmaxes merged by hand (``merge_partials``; some
    ranks hold no valid slot of a row), each rank's heads through its
    ``wo``, summed where the heads split: against the port's whole step
    (``attention_decode_body``) and the reference's
    ``attention_decode``."""
    cfg, jcfg = _cfgs(arch, over)
    attn = transformer.init_params(cfg, seed=25, device="cpu").layers[0].attn
    rng = np.random.default_rng(26)
    b, s = 3, 16
    swa = cfg.attention == "swa"
    pos = torch.tensor([3, 9, 21] if swa else [3, 9, 14], dtype=torch.int32)
    slot = (pos % s if swa else pos.clamp(max=s - 1)).long()
    lengths = (pos + 1).clamp(max=s).to(torch.int32)
    # before the step: each row's last positions below pos at slot p % s
    j = torch.arange(s)[None]
    last = pos[:, None] - 1 - (pos[:, None] - 1 - j) % s
    kv_pos = torch.where(last >= 0, last, -1).to(torch.int32)
    kv_pos[torch.arange(b), slot] = pos
    x = torch.as_tensor(rng.standard_normal((b, 1, cfg.d_model)),
                        dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal(
        (b, s, cfg.n_kv_heads, cfg.d_head)), dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal(kc.shape), dtype=torch.float32)
    blocks = lambda mm, r: sharding.rank_blocks(attn, "layers/attn", ATTN,
                                                mm, r)
    wk, wv = kc.clone(), vc.clone()
    split = cfg.n_heads % m == 0
    n = s // m
    with torch.no_grad():
        want = transformer.attention_decode_body(
            blocks(1, 0), cfg, x, pos, slot, wk, wv, kv_pos, lengths)
        qs = [transformer.decode_query(blocks(m, r), cfg, x, pos)
              for r in range(m)]
        q_all = torch.cat([t[0] for t in qs], 1) if split else qs[0][0]
        parts = []
        for r in range(m):
            rk, rv = kc[:, r * n:(r + 1) * n].clone(), \
                vc[:, r * n:(r + 1) * n].clone()
            transformer.write_owned(rk, rv, qs[r][1], qs[r][2], slot, r * n)
            assert torch.equal(rk, wk[:, r * n:(r + 1) * n])
            assert torch.equal(rv, wv[:, r * n:(r + 1) * n])
            parts.append(transformer.seq_attend(
                q_all, rk, rv, r * n,
                **(dict(kv_pos=kv_pos, pos=pos) if swa
                   else dict(lengths=lengths))))
        assert any(bool((p[1] == float("-inf")).any()) for p in parts)
        merged = da_ref.merge_partials([p[0] for p in parts],
                                       [p[1] for p in parts])
        hq = qs[0][0].shape[1]
        got = _rank_outputs(split, m, lambda r: torch.einsum(
            "bhe,hed->bd", transformer.own_heads(merged, hq, r),
            blocks(m, r).wo))
    _close(got.numpy(), want.numpy(), TP_TOL)
    jp = {nm: _j(getattr(attn, nm)) for nm in ATTN
          if getattr(attn, nm) is not None}
    ref, _, _ = jax.jit(lambda p, a, q, kk, vv, kp: jtf.attention_decode(
        p, jcfg, a, q, kk, vv, kp))(jp, _j(x), _j(pos), _j(wk), _j(wv),
                                    _j(kv_pos))
    _close(got.numpy(), np.asarray(ref)[:, 0], REF_TOL)


def test_plain_lse_and_the_merge_with_empty_ranks():
    """B3's plain versions' log-sum-exp: the natural log of the sum of
    exp(q·k/sqrt(dh)) over the valid keys, -inf for a row with none (its
    output 0), the kernel's split algorithm's alike, under ``lengths`` and
    ``kv_pos``; every rank's slots of a cache of 12 (4 a rank) merged
    (``merge_partials``) equal the whole cache's output, with a rank that
    holds no valid slot of a row and a row that no rank holds, which
    merges to 0 with no NaN; ``collectives.softmax_merge`` over a world of
    one is the output itself (0 and no NaN on the empty row)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as mesh_lib

    rng = np.random.default_rng(27)
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32)
    q, k, v = f32(3, 4, 16), f32(3, 2, 12, 16), f32(3, 2, 12, 16)
    lengths = torch.tensor([0, 5, 12], dtype=torch.int32)
    o, lse = da_ref.decode_attn_plain(q, k, v, lengths, return_lse=True)
    scores = torch.einsum("bhd,bhsd->bhs", q,
                          k.repeat_interleave(2, 1)) / 4.0
    for row in (1, 2):
        want = torch.logsumexp(scores[row, :, :int(lengths[row])], -1)
        np.testing.assert_allclose(lse[row].numpy(), want.numpy(),
                                   rtol=1e-6)
    assert bool((lse[0] == float("-inf")).all()) and bool((o[0] == 0).all())
    o2, lse2 = da_ref.decode_attention_split_ref(q, k, v, lengths,
                                                 return_lse=True)
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), rtol=1e-6)
    kv_pos = torch.where(torch.arange(12)[None] < lengths[:, None],
                         torch.arange(12)[None], -1).to(torch.int32)
    o3, lse3 = da_ref.decode_attn_plain(q, k, v, kv_pos=kv_pos,
                                        pos=lengths - 1, return_lse=True)
    np.testing.assert_allclose(lse3.numpy(), lse.numpy(), rtol=1e-6)
    assert torch.equal(o3[0], o[0])
    parts = [da_ref.decode_attn_plain(
        q, k[:, :, lo:lo + 4], v[:, :, lo:lo + 4],
        (lengths - lo).clamp(0, 4).to(torch.int32), return_lse=True)
        for lo in (0, 4, 8)]
    assert bool((parts[2][1][1] == float("-inf")).all())   # rank 2, row 1
    merged = da_ref.merge_partials([p[0] for p in parts],
                                   [p[1] for p in parts])
    assert bool(torch.isfinite(merged).all()) and bool((merged[0] == 0).all())
    _close(merged.numpy(), o.numpy(), TP_TOL)
    mesh_lib.init_world("cpu")
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        one = collectives.softmax_merge(o, lse, mesh)
    finally:
        mesh_lib.close_world()
    assert torch.equal(one, o)
