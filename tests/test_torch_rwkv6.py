"""The port's RWKV6 path against the JAX reference on the CPU: B5's plain
versions (the token recurrence and the chunk algorithm), the layers it
adds, and a reduced rwkv6-7b on carried weights (forward, prefill with
every state leaf, decode steps), through the family dispatch and the step
functions.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``.
Tolerances, float32: the scans within 1e-5 of their output's largest
magnitude (outputs reach ~50 where decays are slow, and sums of that size
differ by a few ulps between summation orders), the layers within 2e-5,
logits and states after two layers and the unembedding within 1e-4.  One
bf16 case holds the model, whose decay tensor D is rounded to bf16 on both
sides (``rwkv_d_dtype="compute"``), to 2e-2 of the logits' scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.rwkv6_scan import ops as jwkv_ops
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_rwkv6_scan_ref
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_ref, wkv_chunked_ref,
                                               wkv_groups_ref)
from repro_torch.launch import steps
from repro_torch.models import io, layers, model as model_lib, rwkv6

SCAN_REL = 1e-5
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4


def t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


def _close_scaled(got, ref, rel=SCAN_REL):
    _close(got, ref, rel * float(np.abs(np.asarray(ref, np.float32)).max()))


def _wkv_inputs(rng, b, h, n, kd, vd):
    r, k = (rng.standard_normal((b, h, n, kd)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, n, vd)).astype(np.float32)
    # the model's range: -exp(clip(w0 + lora, -8, 2))
    dlog = -np.exp(np.clip(rng.normal(-0.6, 1.0, (b, h, n, kd)), -8, 2))
    u = rng.standard_normal((h, kd)).astype(np.float32) * 0.3
    return r, k, v, dlog.astype(np.float32), u


# ---------------------------------------------------------------------------
# B5's plain versions
# ---------------------------------------------------------------------------

# (B, H, T, K, V, chunk): T a multiple of the chunk, T not (through the
# wrapper, which pads), chunk > T, V != K
WKV_CASES = [(2, 3, 64, 16, 16, 16), (1, 2, 40, 8, 12, 16),
             (2, 2, 5, 16, 16, 32), (1, 4, 96, 32, 32, 32)]


@pytest.mark.parametrize("b,h,n,kd,vd,chunk", WKV_CASES)
def test_wkv_plain_versions_match_reference(b, h, n, kd, vd, chunk):
    """The token recurrence and the wrapper (the chunk algorithm, padded)
    against the reference's oracle and its Pallas kernel in interpret
    mode; the chunk algorithm's y and state against the reference model's
    ``wkv_chunked`` where T is a multiple of the chunk."""
    rng = np.random.default_rng(b * 100 + n + kd)
    r, k, v, dlog, u = _wkv_inputs(rng, b, h, n, kd, vd)
    oracle = jax.jit(jax_rwkv6_scan_ref)(r, k, v, dlog, u)
    pallas = jwkv_ops.wkv(r, k, v, dlog, u, chunk=chunk)
    y_tok, s_tok = rwkv6_scan_ref(t(r), t(k), t(v), t(dlog), t(u))
    y, state = wkv_ops.wkv(t(r), t(k), t(v), t(dlog), t(u), chunk=chunk)
    assert y.shape == (b, h, n, vd) and state.shape == (b, h, kd, vd)
    for got in (y_tok, y):
        _close_scaled(got, oracle)
        _close_scaled(got, pallas)
    _close_scaled(state, s_tok.numpy())
    if n % min(chunk, n) == 0:
        tr = lambda a: np.swapaxes(a, 1, 2)               # (B,T,H,K)
        ry, rs = jax.jit(lambda *a: jrwkv.wkv_chunked(
            *a, chunk, d_dtype_name="float32"))(
            tr(r), tr(k), tr(v), tr(dlog), u,
            np.zeros((b, h, kd, vd), np.float32))
        y2, s2 = wkv_chunked_ref(t(r), t(k), t(v), t(dlog), t(u), chunk)
        _close_scaled(y2, tr(np.asarray(ry)))
        _close_scaled(s2, rs)


# (B, H, T, K, V, group) for the card's algorithm (chunks of 16, sub-blocks
# of 8): T on group boundaries, a tail inside a chunk and a sub-block, T = 1,
# a group longer than T, V != K; decays as the model's, -e^2 everywhere (its
# clip), or -40 on every 5th row (far below it)
GROUP_CASES = [(2, 3, 64, 16, 16, 32), (1, 2, 70, 8, 12, 32),
               (2, 2, 1, 16, 16, 32), (1, 2, 40, 16, 8, 128),
               (1, 3, 133, 16, 16, 64)]


def _decays(dlog, decay):
    if decay == "clip":
        return np.full_like(dlog, -np.exp(2.0))
    if decay == "deep":
        dlog = dlog.copy()
        dlog[:, :, ::5] = -40.0
    return dlog


@pytest.mark.parametrize("decay", ["model", "clip", "deep"])
@pytest.mark.parametrize("b,h,n,kd,vd,group", GROUP_CASES)
def test_wkv_group_algorithm_matches_reference(b, h, n, kd, vd, group, decay):
    """The card's algorithm (``wkv_groups_ref``: the decay factored in
    sub-blocks, the group passes) against the reference's oracle and its
    Pallas kernel in interpret mode; finite, and its state equal to the
    token recurrence's."""
    rng = np.random.default_rng(b * 1000 + n + group)
    r, k, v, dlog, u = _wkv_inputs(rng, b, h, n, kd, vd)
    dlog = _decays(dlog, decay)
    oracle = jax.jit(jax_rwkv6_scan_ref)(r, k, v, dlog, u)
    pallas = jwkv_ops.wkv(r, k, v, dlog, u, chunk=16)
    y, state = wkv_groups_ref(t(r), t(k), t(v), t(dlog), t(u), group=group)
    assert y.shape == (b, h, n, vd) and state.shape == (b, h, kd, vd)
    assert bool(torch.isfinite(y).all() & torch.isfinite(state).all())
    _close_scaled(y, oracle)
    _close_scaled(y, pallas)
    _, s_tok = rwkv6_scan_ref(t(r), t(k), t(v), t(dlog), t(u))
    _close_scaled(state, s_tok.numpy())


@pytest.mark.parametrize("chunk,sub,group", [(32, 8, 64), (32, 16, 64),
                                             (16, 16, 32)])
def test_wkv_group_algorithm_other_blockings(chunk, sub, group):
    """The factoring at other chunk and sub-block sizes (block-rows of a
    32-row chunk each factored at their first row) against the oracle."""
    rng = np.random.default_rng(chunk + sub)
    r, k, v, dlog, u = _wkv_inputs(rng, 2, 2, 100, 16, 16)
    dlog = _decays(dlog, "deep")
    oracle = jax.jit(jax_rwkv6_scan_ref)(r, k, v, dlog, u)
    y, _ = wkv_groups_ref(t(r), t(k), t(v), t(dlog), t(u), chunk=chunk,
                          sub=sub, group=group)
    _close_scaled(y, oracle)


def test_wkv_chunked_rounds_d_as_the_reference():
    """bf16 inputs with D rounded to bf16 (``rwkv_d_dtype="compute"``)
    against the reference model's chunk algorithm: y within 2 bf16 ulps of
    its scale, the float32 state within 1e-2 of its scale."""
    rng = np.random.default_rng(11)
    b, h, n, kd = 2, 2, 32, 16
    r, k, v, dlog, u = _wkv_inputs(rng, b, h, n, kd, kd)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tr = lambda a: jnp.swapaxes(a, 1, 2)
    ry, rs = jax.jit(lambda *a: jrwkv.wkv_chunked(*a, 16))(
        tr(bf(r)), tr(bf(k)), tr(bf(v)), tr(dlog), bf(u),
        jnp.zeros((b, h, kd, kd), jnp.float32))
    tb = lambda a: t(a).bfloat16()
    y, state = wkv_ops.wkv(tb(r), tb(k), tb(v), t(dlog), tb(u), chunk=16,
                           d_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    ry = np.asarray(tr(ry).astype(jnp.float32))
    _close(y, ry, 2 * 2.0 ** -8 * float(np.abs(ry).max()))
    _close(state, rs, 1e-2 * float(np.abs(np.asarray(rs)).max()))


def test_wkv_wrapper_cpu_uses_plain_version():
    rng = np.random.default_rng(12)
    r, k, v, dlog, u = (t(a) for a in _wkv_inputs(rng, 1, 2, 16, 8, 8))
    before = wkv_ops.LAUNCHES
    y, state = wkv_ops.wkv(r, k, v, dlog, u, chunk=8)
    ry, rs = wkv_chunked_ref(r, k, v, dlog, u, 8)
    assert torch.equal(y, ry) and torch.equal(state, rs)
    assert wkv_ops.LAUNCHES == before


def test_layer_and_group_norms_match_reference():
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32)
    ref = jax.jit(lambda x, w, b: jlayers.layer_norm(x, w, b, 1e-5))(x, w, b)
    _close(layers.layer_norm(t(x), t(w), t(b)), ref, LAYER_TOL)
    ref = jax.jit(lambda x, w, b: jlayers.group_norm_heads(x, w, b, 4))(x, w, b)
    _close(layers.group_norm_heads(t(x), t(w), t(b), 4), ref, LAYER_TOL)
    for fn in (lambda x: layers.layer_norm(x, t(w), t(b)),
               lambda x: layers.group_norm_heads(x, t(w), t(b), 4)):
        assert fn(t(x).bfloat16()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The model on carried weights
# ---------------------------------------------------------------------------


def _pair(**overrides):
    """(reference cfg, port cfg, reference params, port model), reduced."""
    jcfg = jax_reduce_config(jax_get_config("rwkv6-7b"), **overrides)
    cfg = reduce_config(get_config("rwkv6-7b"), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jrwkv.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, cfg, jparams, io.lm_params_from_numpy(tree, cfg, device="cpu")


def _check_state(got, ref, tol=LOGIT_TOL):
    assert int(got["pos"]) == int(ref["pos"])
    for key in ("tm_prev", "cm_prev", "S"):
        assert tuple(got[key].shape) == ref[key].shape, key
        _close(got[key], ref[key], tol)


def test_forward_prefill_and_decode_match_reference():
    """forward logits; prefill logits and every state leaf; then 8 decode
    steps, logits and state after each, all through the family dispatch."""
    jcfg, cfg, jparams, model = _pair()
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    ref, _ = jax.jit(lambda p, x: jrwkv.forward(p, jcfg, x))(jparams, toks)
    got, aux = model_lib.forward(model, cfg, t(toks))
    assert float(aux) == 0.0 and got.shape == (2, 24, cfg.vocab_padded)
    _close(got, ref, LOGIT_TOL)

    steps_ = rng.integers(0, cfg.vocab, (8, 2)).astype(np.int32)

    @jax.jit
    def jrun(p, x, steps_):               # the decode steps as one scan
        logits, c = jrwkv.prefill(p, jcfg, x, 64)
        step = lambda c, tok: (lambda lc: (lc[1], lc))(
            jrwkv.decode_step(p, jcfg, c, tok))
        _, (outs, caches) = jax.lax.scan(step, c, steps_)
        return logits, c, outs, caches

    rlogits, rstate, routs, rstates = jrun(jparams, toks, steps_)
    got, state = model_lib.prefill(model, cfg, t(toks), 64)
    _close(got, rlogits, LOGIT_TOL)
    _check_state(state, rstate)
    for i in range(8):
        got, state = model_lib.decode_step(model, cfg, state, t(steps_[i]))
        _close(got, routs[i], LOGIT_TOL)
        _check_state(state, jax.tree_util.tree_map(lambda a: a[i], rstates))


def test_bf16_model_rounds_d_as_the_reference():
    """The reduced config in bf16 (``rwkv_d_dtype="compute"``): prefill
    logits within 2e-2 of their scale, the greedy token equal."""
    jcfg, cfg, jparams, model = _pair(param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    rng = np.random.default_rng(15)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref, rstate = jax.jit(lambda p, x: jrwkv.prefill(p, jcfg, x, 32))(
        jparams, toks)
    got, state = rwkv6.prefill(model, cfg, t(toks), 32)
    ref = np.asarray(ref.astype(jnp.float32))
    scale = float(np.abs(ref).max())
    _close(got, ref, 2e-2 * scale)
    assert (got.float().argmax(-1).numpy() == ref.argmax(-1)).all()
    assert state["tm_prev"].dtype == torch.bfloat16
    assert state["S"].dtype == torch.float32


def test_prefill_keeps_the_references_chunk_assertion():
    """T must be a multiple of min(chunk, T) in the reference model
    (``rwkv6.py:99``); the port's model raises where it asserts, though its
    wrapper would pad (ROADMAP queue C)."""
    jcfg, cfg, jparams, model = _pair()
    toks = np.zeros((1, 12), np.int32)                    # chunk 8
    with pytest.raises(AssertionError):
        jrwkv.prefill(jparams, jcfg, toks, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6.prefill(model, cfg, t(toks), 16)
    rwkv6.prefill(model, cfg, t(toks[:, :5]), 16)         # chunk > T


def test_steps_serve_through_the_dispatch():
    """``steps.make_prefill_step`` / ``make_decode_step`` give the model
    API's results, as the reference's serving steps do."""
    jcfg, cfg, jparams, model = _pair()
    toks = t(np.arange(16, dtype=np.int32).reshape(2, 8))
    logits, cache = steps.make_prefill_step(cfg, 32)(model, toks)
    ref, rcache = rwkv6.prefill(model, cfg, toks, 32)
    assert torch.equal(logits, ref)
    nxt = logits.argmax(-1).to(torch.int32)
    logits, cache = steps.make_decode_step(cfg)(model, cache, nxt)
    ref, rcache = rwkv6.decode_step(model, cfg, rcache, nxt)
    assert torch.equal(logits, ref) and int(cache["pos"]) == 9


def test_init_params_and_carried_weights():
    """The port draws its own weights with the reference's shapes and
    scales; ``io`` rejects a wrong tree."""
    jcfg, cfg, jparams, _ = _pair()
    model = model_lib.init_params(cfg, seed=3, device="cpu")
    state = model.state_dict()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    for name, value in io._flatten(tree):
        got = state[name.replace("layers.", "layers.0.", 1)
                    if name.startswith("layers.") else name]
        value = value[0] if name.startswith("layers.") else value
        assert tuple(got.shape) == value.shape, name
        assert abs(float(got.float().std()) - float(np.std(value))) \
            <= 0.2 * float(np.std(value)) + 1e-6, name
        assert abs(float(got.float().mean()) - float(np.mean(value))) \
            <= 0.2 * float(np.std(value)) + 0.05, name
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["layers"]["u"] = bad["layers"]["u"][:, :, :2]
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(bad, cfg, device="cpu")
