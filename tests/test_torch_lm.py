"""The port's dense LM path against the JAX reference on the CPU: the
flash-attention plain version, the layers, and a whole transformer on
carried weights (forward, prefill with and without lengths, the cache,
decode steps).

Inputs come from numpy with a seed; the reference runs under ``jax.jit``
(``tests/conftest.py`` sets its matmul precision to "highest").  Both sides
compute in float32, so every tolerance is a float32 one: 2e-5 for
attention and the layers (a few ulps of outputs of order 1, different
summation orders), and 1e-4 for logits and caches after two layers and
the unembedding.  Integer cache state (``kv_pos``, ``pos``) is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.flash_attn.kernel import flash_attention
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.kernels.decode_attn.ref import decode_attention_kv_pos_ref
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models import io, layers, model as model_lib, transformer

ARCHS = ["qwen1.5-0.5b", "h2o-danube-3-4b", "starcoder2-15b"]
ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# Flash attention (plain version) and layers
# ---------------------------------------------------------------------------

# every pair of (G, S), (G, (dh, window)) and (S, (dh, window)) once:
# G in {1,2,4}, dh in {16, 24 (not a power of two, as 120)}, S in {16, 40,
# 64} (40 leaves ragged 16-blocks), window in {0, 8}
_DW = [(16, 0), (16, 8), (24, 0), (24, 8)]
FLASH_CASES = [(g, dw[0], (16, 40, 64)[(4 * i + j) % 3], dw[1])
               for i, g in enumerate((1, 2, 4)) for j, dw in enumerate(_DW)]


@pytest.mark.parametrize("g,dh,s,window", FLASH_CASES)
def test_flash_attn_plain_matches_reference(g, dh, s, window):
    rng = np.random.default_rng(100 * g + s + window + dh)
    b, kv = 2, 2
    q = rng.standard_normal((b, kv * g, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    ref = jax.jit(lambda q, k, v: jax_attention_ref(
        q, k, v, causal=True, window=window))(q, k, v)
    pallas = jax.jit(lambda q, k, v: flash_attention(
        q, k, v, causal=True, window=window, block_q=16, block_kv=16,
        interpret=True))(q, k, v)
    got = fa_ops.flash_attn(t(q), t(k), t(v), causal=True, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATTN_TOL,
                               rtol=0)


def test_flash_attn_plain_masks_and_dtype():
    """Non-causal, a window alone, Sq != Skv, and bf16 in -> bf16 out; a
    row that sees no key gives 0."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 40, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 40, 16)).astype(np.float32)
    for causal, window in ((False, 0), (False, 8), (True, 0), (True, 5)):
        ref = jax.jit(lambda q, k, v: jax_attention_ref(
            q, k, v, causal=causal, window=window))(q, k, v)
        got = attention_ref(t(q), t(k), t(v), causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL,
                                   rtol=0)
    out = attention_ref(t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16())
    assert out.dtype == torch.bfloat16
    # causal with a window of 1: query i sees only key i, so the rows past
    # the last key see none
    q2 = rng.standard_normal((1, 2, 6, 8)).astype(np.float32)
    k2 = rng.standard_normal((1, 1, 4, 8)).astype(np.float32)
    got = attention_ref(t(q2), t(k2), t(k2), causal=True, window=1)
    assert torch.equal(got[:, :, 4:], torch.zeros_like(got[:, :, 4:]))


def test_flash_attn_wrapper_cpu_uses_plain_version():
    rng = np.random.default_rng(4)
    q = t(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
    k = t(rng.standard_normal((1, 1, 16, 8)).astype(np.float32))
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attn(q, k, k, window=4)
    assert torch.equal(out, attention_ref(q, k, k, window=4))
    assert fa_ops.LAUNCHES == before                      # no kernel launch


def test_rms_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32) * 3
    w = rng.standard_normal((24,)).astype(np.float32) * 0.1
    ref = jax.jit(lambda x, w: jlayers.rms_norm(x, w, 1e-5))(x, w)
    np.testing.assert_allclose(layers.rms_norm(t(x), t(w)).numpy(),
                               np.asarray(ref), atol=ATTN_TOL, rtol=0)
    assert layers.rms_norm(t(x).bfloat16(), t(w)).dtype == torch.bfloat16

    for dh, theta in ((24, 1e4), (120, 1e5)):            # 120 splits 60|60
        xr = rng.standard_normal((2, 3, 9, dh)).astype(np.float32)
        pos = rng.integers(0, 200, (2, 1, 9)).astype(np.int32)
        ref = jax.jit(lambda x, p: jlayers.apply_rope(x, p, theta))(xr, pos)
        np.testing.assert_allclose(
            layers.apply_rope(t(xr), t(pos), theta).numpy(), np.asarray(ref),
            atol=ATTN_TOL, rtol=0)

    wg = rng.standard_normal((24, 40)).astype(np.float32) * 0.2
    wu = rng.standard_normal((24, 40)).astype(np.float32) * 0.2
    wd = rng.standard_normal((40, 24)).astype(np.float32) * 0.2
    ref = jax.jit(jlayers.swiglu)(x, wg, wu, wd)
    np.testing.assert_allclose(
        layers.swiglu(t(x), t(wg), t(wu), t(wd)).numpy(), np.asarray(ref),
        atol=ATTN_TOL, rtol=0)


def test_decode_attention_matches_reference():
    """GQA over a slot cache with empty slots (-1) and slots past the
    query's position, per sequence."""
    rng = np.random.default_rng(6)
    b, h, kv, s, dh = 3, 8, 2, 12, 16
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    kv_pos = rng.integers(-1, 15, (b, s)).astype(np.int32)
    kv_pos[:, 0] = 0                                   # every row sees a key
    pos = np.array([3, 9, 14], np.int32)
    ref = jax.jit(jlayers.decode_attention)(q, kc, vc, kv_pos, pos)
    got = decode_attention_kv_pos_ref(t(q), t(kc).transpose(1, 2),
                                      t(vc).transpose(1, 2), t(kv_pos), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Whole model on carried weights
# ---------------------------------------------------------------------------


def _pair(arch, **overrides):
    """(reference cfg, port cfg, reference params, port model), reduced."""
    jcfg = jax_reduce_config(jax_get_config(arch), **overrides)
    cfg = reduce_config(get_config(arch), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jtf.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, io.lm_params_from_numpy(tree, cfg, device="cpu")


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol,
                               rtol=0)


def _check_cache(got, ref):
    for key in ("kv_pos", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for key in ("k", "v"):
        assert tuple(got[key].shape) == ref[key].shape
        _close(got[key], ref[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    """forward logits, prefill logits and cache with lengths=None and with
    right-padded lengths; starcoder2 and qwen carry QKV biases (set
    non-zero here), danube a window of 32 that the 40-token rows exceed."""
    jcfg, cfg, jparams, model = _pair(arch)
    rng = np.random.default_rng(8)
    if cfg.qkv_bias:                              # init makes them zero
        for name in ("bq", "bk", "bv"):
            shape = jparams["layers"]["attn"][name].shape
            jparams["layers"]["attn"][name] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        model = io.lm_params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(rng, cfg, 2, 40)
    ref, _ = jax.jit(lambda p, x: jtf.forward(p, jcfg, x))(jparams, toks)
    got, aux = transformer.forward(model, cfg, t(toks))
    assert float(aux) == 0.0
    _close(got, ref)
    # padded vocab ids are masked
    assert cfg.vocab_padded > cfg.vocab
    assert bool((got[..., cfg.vocab:] == -1e9).all())

    max_len = 48
    ref, rcache = jax.jit(lambda p, x: jtf.prefill(p, jcfg, x, max_len))(
        jparams, toks)
    got, cache = transformer.prefill(model, cfg, t(toks), max_len)
    _close(got, ref)
    _check_cache(cache, rcache)

    lengths = np.array([33, 17], np.int32)
    ref, rcache = jax.jit(lambda p, x, n: jtf.prefill(
        p, jcfg, x, max_len, lengths=n))(jparams, toks, lengths)
    got, cache = transformer.prefill(model, cfg, t(toks), max_len,
                                     lengths=t(lengths))
    _close(got, ref)
    _check_cache(cache, rcache)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, attn_impl):
    """Prefill two padded prompts, then 8 decode steps: logits within
    tolerance and the cache (positions exact) after each, against the
    reference's XLA attention and its Pallas kernel (interpret mode) in
    prefill.  Danube's ring (window 32) wraps during the 8 steps."""
    jcfg, cfg, jparams, model = _pair(arch)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    rng = np.random.default_rng(9)
    toks = _tokens(rng, cfg, 2, 32)
    lengths = np.array([29, 11], np.int32)
    max_len = 48

    @jax.jit
    def jrun(p, x, n, steps):
        logits, c = jtf.prefill(p, jcfg, x, max_len, lengths=n)
        outs, caches = [logits], []
        for i in range(steps.shape[0]):
            logits, c = jtf.decode_step(p, jcfg, c, steps[i])
            outs.append(logits)
            caches.append(c)
        return outs, caches

    steps = rng.integers(0, cfg.vocab, (8, 2)).astype(np.int32)
    routs, rcaches = jrun(jparams, toks, lengths, steps)
    got, cache = transformer.prefill(model, cfg, t(toks), max_len,
                                     lengths=t(lengths))
    _close(got, routs[0])
    for i in range(8):
        got, cache = transformer.decode_step(model, cfg, cache, t(steps[i]))
        _close(got, routs[i + 1])
        _check_cache(cache, rcaches[i])


def test_padded_swa_prefill_keeps_the_references_window():
    """A 40-token prompt padded to the 64 bucket under a window of 32: the
    reference keeps the bucket's last 32 positions (32..63) and masks the
    padded ones, so only 32..39 stay valid where the window would hold
    9..39 (ROADMAP queue C).  The port reproduces it."""
    jcfg, cfg, jparams, model = _pair("h2o-danube-3-4b")
    assert cfg.window == 32
    rng = np.random.default_rng(10)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :40] = rng.integers(2, cfg.vocab, 40)
    lengths = np.array([40], np.int32)
    ref, rcache = jax.jit(lambda p, x, n: jtf.prefill(
        p, jcfg, x, 192, lengths=n))(jparams, toks, lengths)
    got, cache = transformer.prefill(model, cfg, t(toks), 192,
                                     lengths=t(lengths))
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(rcache["kv_pos"]))
    valid = sorted(int(p) for p in cache["kv_pos"][0] if p >= 0)
    assert valid == list(range(32, 40))
    _close(got, ref)
    _check_cache(cache, rcache)


def test_init_params_shapes_scales_and_defaults():
    """The port draws its own weights (torch.Generator), with the
    reference's shapes, dtypes and scales; it defaults to CUDA."""
    cfg = reduce_config(get_config("starcoder2-15b"))
    jcfg = jax_reduce_config(jax_get_config("starcoder2-15b"))
    model = model_lib.init_params(cfg, seed=3, device="cpu")
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    state = model.state_dict()
    for name, value in io._flatten(tree):
        if name.startswith("layers."):
            got = state[f"layers.0.{name[len('layers.'):]}"]
            value = value[0]
        else:
            got = state[name]
        assert tuple(got.shape) == value.shape, name
        ref_std, got_std = float(np.std(value)), float(got.float().std())
        assert abs(got_std - ref_std) <= 0.15 * ref_std + 1e-12, name
    again = model_lib.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    bf16 = model_lib.init_params(
        dataclasses.replace(cfg, param_dtype="bfloat16"), device="cpu")
    assert bf16.embed.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            model_lib.init_params(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            model_lib.init_cache(cfg, 2, 16)


def test_unported_families_raise():
    """Every family of the reference dispatches (each architecture's
    reduced config builds through ``model.init_params``); an unknown family
    raises there, and the transformer still refuses the other families."""
    families = set()
    for arch in list_archs():
        cfg = reduce_config(get_config(arch))
        model = model_lib.init_params(cfg, device="cpu")
        assert model_lib.count_params(model) > 0, arch
        families.add(cfg.family)
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec"}
    with pytest.raises(NotImplementedError, match="unknown family"):
        model_lib.init_params(dataclasses.replace(cfg, family="conv"),
                              device="cpu")
    for arch in ("rwkv6-7b", "recurrentgemma-2b", "whisper-medium"):
        with pytest.raises(NotImplementedError, match="dense and MoE"):
            transformer.init_params(reduce_config(get_config(arch)),
                                    device="cpu")


def test_carried_weights_reject_a_wrong_tree():
    jcfg, cfg, jparams, _ = _pair("qwen1.5-0.5b")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :2]
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    del tree["final_norm"]
    with pytest.raises(RuntimeError):
        io.lm_params_from_numpy(tree, cfg, device="cpu")


def test_nvcc_flags_are_per_kernel():
    """B1 must not contract multiply-adds (bit-exact against an
    FMA-contracted reference at four written sites); B2, B3, B4, B5 and B6
    keep nvcc's default contraction.  The library name hashes each kernel's
    own flags.  Nothing is compiled here."""
    from repro_torch.kernels import build
    assert "--fmad=false" in build.flags("lockstep_advance")
    for name in ("flash_attn", "decode_attn", "moe_gemm", "rwkv6_scan",
                 "rglru_scan"):
        assert "--fmad=false" not in build.flags(name)
    assert set(build.KERNEL_FLAGS) == {p.stem for p in build.CSRC.glob("*.cu")}
    paths = {name: build.library_path(name) for name in build.KERNEL_FLAGS}
    assert paths["flash_attn"].parent == build.BUILD_DIR
    assert paths["flash_attn"].name.startswith("flash_attn-")
