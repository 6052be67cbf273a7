"""The port's RecurrentGemma path against the JAX reference on the CPU:
B6's plain version, the layers it adds (GeGLU with the tanh GELU, the
local attention, the causal conv), and a reduced recurrentgemma-2b on
carried weights (forward, prefill with every cache leaf, decode steps),
also with a tail (``n_layers=5``) and with a window of 16 that the ring
wraps past, through the family dispatch and the step functions.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``.
Tolerances, float32: 2e-5 for the scan and the layers (a few ulps of
outputs of order 1-10), 1e-4 for logits and caches after the layers and
the unembedding; ``kv_pos`` and ``pos`` exact.  One bf16 case holds the
model to 2e-2 of the logits' scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.rglru_scan import ops as jlru_ops
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_chunked_ref, rglru_scan_ref
from repro_torch.launch import steps
from repro_torch.models import io, layers, model as model_lib, rglru

TOL = 2e-5
LOGIT_TOL = 1e-4


def t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# B6's plain version and the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,w", [(2, 40, 24), (1, 130, 8), (3, 1, 16)])
def test_lru_plain_version_matches_reference(b, n, w):
    """A non-zero h0 and some log_a > 0: the plain version against the
    reference's oracle (both on the clamped log_a), the wrapper against
    the reference's ``ops.lru`` with its Pallas kernel in interpret mode
    (which clamps)."""
    rng = np.random.default_rng(b * 1000 + n + w)
    log_a = (rng.uniform(-2.0, 0.2, (b, n, w))).astype(np.float32)
    x = rng.standard_normal((b, n, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    assert (log_a > 0).any()
    clamped = np.minimum(log_a, 0.0)
    ref = jax.jit(jax_rglru_scan_ref)(clamped, x, h0)
    _close(rglru_scan_ref(t(clamped), t(x), t(h0)), ref)
    pallas = jlru_ops.lru(log_a, x, h0, block_t=32)
    got = lru_ops.lru(t(log_a), t(x), t(h0))
    _close(got, pallas)
    _close(got, ref)
    assert lru_ops.lru(t(log_a).bfloat16(), t(x).bfloat16(),
                       t(h0)).dtype == torch.bfloat16


# (B, T, W, chunk) for the card's two-pass algorithm: chunk boundaries, a
# tail, T = 1, a chunk longer than T
LRU_CHUNK_CASES = [(2, 40, 24, 16), (1, 130, 8, 64), (3, 1, 16, 16),
                   (2, 64, 8, 64), (1, 300, 8, 256)]


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("b,n,w,chunk", LRU_CHUNK_CASES)
def test_lru_two_pass_algorithm_matches_reference(b, n, w, chunk, deep):
    """``rglru_chunked_ref`` (the chunks' decays as direct products, the
    carries, the walks) against the reference's oracle on the clamped
    log_a and its Pallas kernel in interpret mode; with ``deep``, log_a =
    -80 on every 7th step (a decay that underflows to 0): finite."""
    rng = np.random.default_rng(b * 100 + n + chunk)
    log_a = rng.uniform(-2.0, 0.2, (b, n, w)).astype(np.float32)
    if deep:
        log_a[:, ::7] = -80.0
    x = rng.standard_normal((b, n, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    ref = jax.jit(jax_rglru_scan_ref)(np.minimum(log_a, 0.0), x, h0)
    pallas = jlru_ops.lru(log_a, x, h0, block_t=32)
    got = rglru_chunked_ref(t(log_a), t(x), t(h0), chunk)
    assert got.shape == (b, n, w) and bool(torch.isfinite(got).all())
    _close(got, ref)
    _close(got, pallas)


def test_lru_wrapper_cpu_uses_plain_version():
    rng = np.random.default_rng(3)
    log_a, x = (t(rng.standard_normal((2, 9, 8)).astype(np.float32))
                for _ in range(2))
    h0 = torch.zeros((2, 8))
    before = lru_ops.LAUNCHES
    assert torch.equal(lru_ops.lru(log_a, x, h0),
                       rglru_scan_ref(log_a.clamp(max=0.0), x, h0))
    assert lru_ops.LAUNCHES == before


def test_geglu_and_causal_conv_match_reference():
    """GeGLU takes the tanh GELU (``jax.nn.gelu``'s default); the conv
    carries its state across calls."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32) * 2
    wg, wu = (rng.standard_normal((24, 40)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((40, 24)).astype(np.float32) * 0.3
    ref = jax.jit(jlayers.geglu)(x, wg, wu, wd)
    _close(layers.geglu(t(x), t(wg), t(wu), t(wd)), ref)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    ref, rst = jax.jit(jrg.causal_conv1d)(x, w, b, st)
    got, gst = rglru.causal_conv1d(t(x), t(w), t(b), t(st))
    _close(got, ref)
    _close(gst, rst)


@pytest.mark.parametrize("h,kv,dh,s,window", [(4, 1, 32, 40, 16),
                                              (4, 2, 16, 33, 0),
                                              (2, 1, 64, 20, 64)])
def test_local_attention_matches_reference(h, kv, dh, s, window):
    """Causal MQA/GQA within a window against the reference's blockwise
    attention (blocks of 16), with the port's query blocks smaller than S
    so a block sees only its window's keys."""
    rng = np.random.default_rng(h * s + window)
    q = rng.standard_normal((2, s, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, kv, dh)).astype(np.float32)
            for _ in range(2))
    ref = jax.jit(lambda q, k, v: jlayers.blockwise_attention(
        q, k, v, causal=True, window=window, block_q=16, block_kv=16))(q, k, v)
    for block_q in (512, 8):
        got = layers.local_attention(t(q), t(k), t(v), window=window,
                                     block_q=block_q)
        _close(got, ref)


# ---------------------------------------------------------------------------
# The model on carried weights
# ---------------------------------------------------------------------------


def _pair(**overrides):
    """(reference cfg, port cfg, reference params, port model), reduced."""
    jcfg = jax_reduce_config(jax_get_config("recurrentgemma-2b"), **overrides)
    cfg = reduce_config(get_config("recurrentgemma-2b"), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jrg.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, cfg, jparams, io.lm_params_from_numpy(tree, cfg, device="cpu")


def _port_leaf(cache, n_super, group, i):
    """The port's cache entry that holds the reference's ``group`` (rec1,
    rec2, attn of superblock i; tail entry i)."""
    if group == "tail":
        return cache["layers"][3 * n_super + i]
    return cache["layers"][3 * i + ("rec1", "rec2", "attn").index(group)]


def _check_cache(got, ref, n_super):
    assert int(got["pos"]) == int(ref["pos"])
    groups = [("super", g, ref["super"][g]) for g in ("rec1", "rec2", "attn")]
    if "tail" in ref:
        groups.append(("tail", "tail", ref["tail"]))
    assert len(got["layers"]) == sum(
        next(iter(leaves.values())).shape[0] for _, _, leaves in groups)
    for _, group, leaves in groups:
        for key, stacked in leaves.items():
            for i in range(stacked.shape[0]):
                leaf = _port_leaf(got, n_super, group, i)[key]
                assert tuple(leaf.shape) == stacked[i].shape, (group, key)
                if key == "kv_pos":
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(stacked[i]))
                else:
                    _close(leaf, stacked[i], LOGIT_TOL)


# (overrides, prompt length, max_len): the reduced config (3 layers, no
# tail, window 2048); a tail of two recurrent layers under a window of 16
# that a 24-token prompt already exceeds and 8 decode steps wrap past
# again; a 12-token prompt under a window of 16 that the decode steps fill
# and wrap
MODEL_CASES = [({}, 24, 64), ({"n_layers": 5, "window": 16}, 24, 64),
               ({"window": 16}, 12, 64)]


@pytest.mark.parametrize("overrides,n,max_len", MODEL_CASES)
def test_forward_prefill_and_decode_match_reference(overrides, n, max_len):
    """forward logits; prefill logits and every cache leaf (the rings'
    ``kv_pos`` exact); then 8 decode steps, logits and cache after each,
    through the family dispatch."""
    jcfg, cfg, jparams, model = _pair(**overrides)
    n_super = cfg.n_layers // 3
    rng = np.random.default_rng(20 + cfg.n_layers + cfg.window)
    toks = rng.integers(0, cfg.vocab, (2, n)).astype(np.int32)
    ref, _ = jax.jit(lambda p, x: jrg.forward(p, jcfg, x))(jparams, toks)
    got, aux = model_lib.forward(model, cfg, t(toks))
    assert float(aux) == 0.0
    _close(got, ref, LOGIT_TOL)

    steps_ = rng.integers(0, cfg.vocab, (8, 2)).astype(np.int32)

    @jax.jit
    def jrun(p, x, steps_):               # the decode steps as one scan
        logits, c = jrg.prefill(p, jcfg, x, max_len)
        step = lambda c, tok: (lambda lc: (lc[1], lc))(
            jrg.decode_step(p, jcfg, c, tok))
        _, (outs, caches) = jax.lax.scan(step, c, steps_)
        return logits, c, outs, caches

    rlogits, rcache, routs, rcaches = jrun(jparams, toks, steps_)
    got, cache = model_lib.prefill(model, cfg, t(toks), max_len)
    _close(got, rlogits, LOGIT_TOL)
    _check_cache(cache, rcache, n_super)
    for i in range(8):
        got, cache = model_lib.decode_step(model, cfg, cache, t(steps_[i]))
        _close(got, routs[i], LOGIT_TOL)
        _check_cache(cache, jax.tree_util.tree_map(lambda a: a[i], rcaches),
                     n_super)
    if cfg.window == 16:                       # the ring wrapped
        assert int(cache["pos"]) > 16


def test_bf16_model_keeps_lam_float32_and_matches_reference():
    """In bf16, ``lam`` stays float32 (both when drawn and when carried)
    and the embedding scale is rounded to bf16 first (50.5 at d = 2560);
    prefill logits within 2e-2 of their scale, the greedy token equal."""
    jcfg, cfg, jparams, model = _pair(param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    for m in (model, model_lib.init_params(cfg, device="cpu")):
        for name, p in m.named_parameters():
            want = torch.float32 if name.endswith(".lam") else torch.bfloat16
            assert p.dtype == want, name
    assert float(torch.tensor(2560 ** 0.5, dtype=torch.bfloat16)) == 50.5
    rng = np.random.default_rng(30)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref, _ = jax.jit(lambda p, x: jrg.prefill(p, jcfg, x, 32))(jparams, toks)
    got, cache = rglru.prefill(model, cfg, t(toks), 32)
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got, ref, 2e-2 * float(np.abs(ref).max()))
    assert (got.float().argmax(-1).numpy() == ref.argmax(-1)).all()
    assert cache["layers"][0]["h"].dtype == torch.float32


def test_steps_serve_through_the_dispatch():
    jcfg, cfg, jparams, model = _pair()
    toks = t(np.arange(16, dtype=np.int32).reshape(2, 8))
    logits, cache = steps.make_prefill_step(cfg, 32)(model, toks)
    ref, rcache = rglru.prefill(model, cfg, toks, 32)
    assert torch.equal(logits, ref)
    nxt = logits.argmax(-1).to(torch.int32)
    logits, cache = steps.make_decode_step(cfg)(model, cache, nxt)
    ref, rcache = rglru.decode_step(model, cfg, rcache, nxt)
    assert torch.equal(logits, ref) and int(cache["pos"]) == 9


def test_init_params_and_carried_weights():
    """The port draws its own weights with the reference's shapes and
    scales; ``io`` maps superblocks and the tail onto layers in order and
    rejects a wrong tree."""
    jcfg, cfg, jparams, carried = _pair(n_layers=5)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert [type(m).__name__ for m in carried.layers] == \
        ["RecLayer", "RecLayer", "AttnLayer", "RecLayer", "RecLayer"]
    np.testing.assert_array_equal(carried.layers[4].w_x.numpy(),
                                  tree["tail"]["w_x"][1])
    np.testing.assert_array_equal(carried.layers[1].mlp.w_up.numpy(),
                                  tree["super"]["rec2"]["mlp"]["w_up"][0])
    model = model_lib.init_params(cfg, seed=3, device="cpu")
    state = model.state_dict()
    for name, value in io._flatten(tree):
        group, _, leaf = name.partition(".")
        if group == "super":
            sub, _, leaf = leaf.partition(".")
            name = f"layers.{('rec1', 'rec2', 'attn').index(sub)}.{leaf}"
            value = value[0]
        elif group == "tail":
            name, value = f"layers.3.{leaf}", value[0]
        got = state[name]
        assert tuple(got.shape) == value.shape, name
        assert abs(float(got.float().std()) - float(np.std(value))) \
            <= 0.2 * float(np.std(value)) + 1e-6, name
        assert abs(float(got.float().mean()) - float(np.mean(value))) \
            <= 0.2 * float(np.std(value)) + 0.05, name
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["super"]["attn"]["wq"] = bad["super"]["attn"]["wq"][:, :, :1]
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    del bad["tail"]
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(bad, cfg, device="cpu")
