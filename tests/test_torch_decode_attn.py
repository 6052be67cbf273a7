"""The port's decode attention (B3) against the JAX reference on the CPU:
the plain version against the reference's Pallas kernel (interpret mode)
and its plain version, the serving cache's prefix invariant that lets the
decode path read a full-attention cache by length, and that decode path
against the ``kv_pos``-masked attention and the reference's
``decode_step``.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``.
Tolerances: attention outputs 2e-5 (float32, other summation orders);
logits of the reduced models 1e-4; cache positions exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.decode_attn.kernel import decode_attention as jax_decode_kernel
from repro.kernels.decode_attn.ref import decode_attention_ref as jax_decode_ref
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.env import serve_engine
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.kernels.decode_attn.ref import decode_attention_ref
from repro_torch.models import layers, model as model_lib, transformer
from test_torch_lm import _pair

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


def t(x):
    return torch.as_tensor(np.asarray(x))


# every (G, dh) pair: G in {1, 4, 6} (qwen's 1, dbrx's 6), dh in {16, 24};
# S = 40 leaves a ragged 16-block in the TPU kernel
@pytest.mark.parametrize("g", [1, 4, 6])
@pytest.mark.parametrize("dh", [16, 24])
def test_decode_attn_plain_matches_reference(g, dh):
    rng = np.random.default_rng(10 * g + dh)
    b, kv, s = 4, 2, 40
    q = rng.standard_normal((b, kv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    lengths = np.array([1, 17, 40, 33], np.int32)          # ragged, 1 and S
    ref = jax.jit(jax_decode_ref)(q, k, v, lengths)
    pallas = jax.jit(lambda *a: jax_decode_kernel(*a, block_kv=16,
                                                  interpret=True))(q, k, v, lengths)
    got = da_ops.decode_attn(t(q), t(k), t(v), t(lengths))
    assert got.dtype == torch.float32 and got.shape == q.shape
    for r in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=ATTN_TOL,
                                   rtol=0)


def test_decode_attn_plain_length_zero_strides_and_dtype():
    """Length 0 gives 0, as the TPU kernel's max(l, 1e-30) does (the
    reference's plain version gives NaN there); a (B, S, KV, dh) cache read
    through a transposed view equals the contiguous layout; bf16 in, bf16
    out; the CPU wrapper launches nothing."""
    rng = np.random.default_rng(3)
    b, h, kv, s, dh = 3, 8, 2, 24, 16
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    cache_k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    cache_v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    lengths = np.array([0, 5, 24], np.int32)
    k, v = cache_k.transpose(0, 2, 1, 3), cache_v.transpose(0, 2, 1, 3)
    pallas = jax.jit(lambda *a: jax_decode_kernel(*a, block_kv=8,
                                                  interpret=True))(
        q, np.ascontiguousarray(k), np.ascontiguousarray(v), lengths)
    before = da_ops.LAUNCHES
    got = da_ops.decode_attn(t(q), t(cache_k).transpose(1, 2),
                             t(cache_v).transpose(1, 2), t(lengths))
    assert da_ops.LAUNCHES == before
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATTN_TOL,
                               rtol=0)
    assert torch.equal(got, decode_attention_ref(
        t(q), t(np.ascontiguousarray(k)), t(np.ascontiguousarray(v)),
        t(lengths)))
    out = da_ops.decode_attn(t(q).bfloat16(), t(k).bfloat16(),
                             t(v).bfloat16(), t(lengths))
    assert out.dtype == torch.bfloat16


def _valid_prefix(cache):
    """Per slot row, whether the valid kv_pos entries are exactly the
    prefix 0 .. min(pos, S) - 1, with kv_pos[j] = j below S - 1."""
    kv_pos, pos = cache["kv_pos"], cache["pos"].long()
    s = kv_pos.shape[1]
    n = pos.clamp(max=s)
    idx = torch.arange(s)[None, :]
    ok = ((kv_pos >= 0) == (idx < n[:, None])).all(dim=1)
    inorder = torch.where(idx < (n[:, None] - 1).clamp(max=s - 1),
                          kv_pos == idx, True).all(dim=1)
    return ok & inorder


def test_full_attention_cache_stays_a_prefix_while_serving():
    """The invariant B3's decode path rests on, driven through an
    ``ExpertServer``: slot reuse (five requests on three slots), idle slots
    that decode on past the cache (pos >= S clamps to the last slot) and
    requests that end on the cache length.  After every step the valid
    entries of each slot are exactly 0 .. min(pos, S) - 1, so the next
    decode's min(pos+1, S) slots are those plus the one it writes."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"))
    assert cfg.attention == "full"
    srv = serve_engine.ExpertServer(
        "port", cfg, model_lib.init_params(cfg, seed=2, device="cpu"),
        slots=3, max_len=32)
    rng = np.random.default_rng(4)
    for rid, (p, n) in enumerate(((12, 40), (5, 3), (16, 6), (9, 30), (3, 2))):
        srv.submit(serve_engine.Request(rid=rid, tokens=rng.integers(2, 250, p),
                                        max_new=n, submit_time=1.0))
    steps, clamped, done = 0, False, []
    while srv.has_work():
        done.extend(srv.step())
        steps += 1
        assert bool(_valid_prefix(srv.cache).all()), (steps, srv.cache["kv_pos"])
        np.testing.assert_array_equal(srv.pos, srv.cache["pos"].numpy())
        clamped |= bool((srv.cache["pos"] > 32).any())
    assert len(done) == 5 and len({r.slot for r in done}) == 3   # reuse
    assert any(len(r.generated) < r.max_new for r in done)      # hit max_len
    assert clamped and steps > 20


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-15b",
                                  "dbrx-132b"])
def test_b3_decode_path_equals_kv_pos_path_and_reference(arch, monkeypatch):
    """A padded prefill and 10 decode steps that run past the cache (S=40):
    the decode path through B3 (lengths) gives the logits of the same path
    with the plain kv_pos-masked attention, and of the reference."""
    jcfg, cfg, jparams, model = _pair(arch)
    assert cfg.attention == "full"
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    lengths = np.array([32, 11], np.int32)
    max_len, n_steps = 40, 10

    @jax.jit
    def jrun(p, x, n, steps):
        logits, c = jtf.prefill(p, jcfg, x, max_len, lengths=n)
        outs = []
        for i in range(steps.shape[0]):
            logits, c = jtf.decode_step(p, jcfg, c, steps[i])
            outs.append(logits)
        return outs

    steps = rng.integers(0, cfg.vocab, (n_steps, 2)).astype(np.int32)
    routs = jrun(jparams, toks, lengths, steps)

    def drive():
        _, cache = transformer.prefill(model, cfg, t(toks), max_len,
                                       lengths=t(lengths))
        holder["cache"] = cache
        outs = []
        for i in range(n_steps):
            logits, cache = transformer.decode_step(model, cfg, cache,
                                                    t(steps[i]))
            outs.append(logits)
            assert bool(_valid_prefix(cache).all())
        return outs, cache

    holder = {}
    b3, cache = drive()
    assert int(cache["pos"].max()) > max_len          # clamped at the end

    def kv_pos_attention(q, k, v, lengths):
        c = holder["cache"]
        return layers.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                       c["kv_pos"], c["pos"])

    monkeypatch.setattr(transformer, "decode_attn", kv_pos_attention)
    plain, _ = drive()
    for i in range(n_steps):
        np.testing.assert_allclose(b3[i].numpy(), plain[i].numpy(),
                                   atol=ATTN_TOL, rtol=0)
        np.testing.assert_allclose(b3[i].numpy(), np.asarray(routs[i]),
                                   atol=LOGIT_TOL, rtol=0)
