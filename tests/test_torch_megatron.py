"""The Megatron split of the transformer families over ``model``, on the
CPU without a process group: every model rank's body (attention on its
heads, the MLP on its ff columns, the embedding and the logits on its
vocab rows, the cross entropy's terms), run one after another in one
process on its blocks (``sharding.rank_blocks``) and summed by hand,
against the port's whole layer and the JAX reference's function on the
same weights, for model axes of 2 and 4.

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
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import sharding
from repro_torch.models import encdec, io, model as model_lib, transformer

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
