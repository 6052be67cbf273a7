"""The port's decode attention (B3) against the JAX reference on the CPU:
the plain version against the reference's Pallas kernel (interpret mode)
and its plain version, the serving cache's prefix invariant that lets the
decode path read a full-attention cache by length, and that decode path
against the ``kv_pos``-masked attention and the reference's
``decode_step``.  Then the kernel's algorithm in plain PyTorch
(``decode_attention_split_ref``: packed query rows, key splits, warp and
split merges, P rounded to bf16) against the reference under both masks,
and the split rule.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``.
Tolerances: attention outputs 2e-5 (float32, other summation orders);
logits of the reduced models 1e-4; cache positions exact.  The bf16
algorithm against the reference on the same bf16-rounded inputs computed
in float32: P rounded to bf16 moves each weight by at most 2^-9 of itself,
so the output by at most 2^-9 max|v|, and the output's own rounding adds
at most half an ulp, 2^-8 |o|; the tolerance is twice each,
2^-8 max|v| + 2^-7 |ref|.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.decode_attn.kernel import decode_attention as jax_decode_kernel
from repro.kernels.decode_attn.ref import decode_attention_ref as jax_decode_ref
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.env import serve_engine
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.kernels.decode_attn.ref import (decode_attention_kv_pos_ref,
                                                 decode_attention_ref,
                                                 decode_attention_split_ref,
                                                 decode_attn_plain, split_plan)
from repro_torch.models import model as model_lib, transformer
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
        return decode_attention_kv_pos_ref(q, k, v, c["kv_pos"], c["pos"])

    monkeypatch.setattr(transformer, "decode_attn", kv_pos_attention)
    plain, _ = drive()
    for i in range(n_steps):
        np.testing.assert_allclose(b3[i].numpy(), plain[i].numpy(),
                                   atol=ATTN_TOL, rtol=0)
        np.testing.assert_allclose(b3[i].numpy(), np.asarray(routs[i]),
                                   atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# The kernel's algorithm (decode_attention_split_ref) and its split rule
# ---------------------------------------------------------------------------


def _bf16_round(x):
    return torch.as_tensor(x).bfloat16().float().numpy()


def _bf16_tol(v, ref):
    return 2.0 ** -8 * np.abs(v).max() + 2.0 ** -7 * np.abs(ref)


# (G, dh, KV, S, SMs, splits) at B = 4: every G of the served models (qwen
# 1, danube 4, dbrx 6, recurrentgemma 10, starcoder2 12), every dh (64,
# danube's 120, 128, recurrentgemma's 256) and 1, 2, 3 and 7 splits, which
# the plan takes from the SM count (S = 890 and 394 end in a ragged tile)
SPLIT_CASES = [(1, 64, 2, 890, 132, 7), (4, 120, 2, 394, 12, 3),
               (6, 128, 1, 190, 132, 1), (10, 256, 1, 890, 132, 7),
               (12, 128, 1, 300, 132, 2), (12, 256, 1, 394, 8, 3),
               (4, 64, 2, 64, 132, 1)]


@pytest.mark.parametrize("g,dh,kv,s,n_sm,splits", SPLIT_CASES)
def test_split_algorithm_matches_reference_under_lengths(g, dh, kv, s, n_sm,
                                                         splits):
    """Lengths 0, 1 and S and one drawn, so some splits lie wholly past a
    length; float32 against the reference's plain version and its Pallas
    kernel, bf16 against the plain version on the rounded inputs."""
    rng = np.random.default_rng(g * dh + s)
    b = 4
    assert split_plan(s, b * kv, n_sm)[0] == splits
    q = rng.standard_normal((b, kv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    lengths = np.array([0, 1, s, int(rng.integers(2, s))], np.int32)
    ref = np.asarray(jax.jit(jax_decode_ref)(q, k, v, lengths))
    pallas = np.asarray(jax.jit(lambda *a: jax_decode_kernel(
        *a, block_kv=64, interpret=True))(q, k, v, lengths))
    got = decode_attention_split_ref(t(q), t(k), t(v), t(lengths), n_sm=n_sm)
    assert got.dtype == torch.float32
    assert torch.equal(got[0], torch.zeros_like(got[0]))       # length 0
    np.testing.assert_allclose(got[1:].numpy(), ref[1:], atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATTN_TOL, rtol=0)

    qb, kb, vb = (_bf16_round(x) for x in (q, k, v))
    ref_b = np.asarray(jax.jit(jax_decode_ref)(qb, kb, vb, lengths))
    got_b = decode_attention_split_ref(
        t(qb).bfloat16(), t(kb).bfloat16(), t(vb).bfloat16(), t(lengths),
        n_sm=n_sm)
    assert got_b.dtype == torch.bfloat16
    err = np.abs(got_b.float().numpy()[1:] - ref_b[1:])
    assert (err <= _bf16_tol(vb, ref_b[1:])).all(), float(err.max())


def _ring(b, s, rng):
    """kv_pos (b, s) and pos (b,) of ring caches: slot j holds the latest
    position p <= pos with p = j mod s, -1 where none is; the first ring
    has not wrapped (pos < s), the others have."""
    pos = np.concatenate([[s // 2], rng.integers(s, 3 * s, b - 1)])
    kv_pos = pos[:, None] - (pos[:, None] - np.arange(s)[None, :]) % s
    kv_pos[kv_pos < 0] = -1
    return kv_pos.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("g,dh,kv,s,n_sm,splits", SPLIT_CASES)
def test_split_algorithm_matches_reference_under_kv_pos(g, dh, kv, s, n_sm,
                                                        splits):
    """Rings that have wrapped, and one that has not, against the
    reference's ``layers.decode_attention`` on the (B, S, KV, dh) cache; a
    scalar pos as the recurrent caches hold it; the port's wrapper on the
    CPU (its plain version) agrees."""
    rng = np.random.default_rng(g * dh + s + 1)
    b = 4
    assert split_plan(s, b * kv, n_sm)[0] == splits
    q = rng.standard_normal((b, kv * g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    kv_pos, pos = _ring(b, s, rng)
    k_t, v_t = t(kc).transpose(1, 2), t(vc).transpose(1, 2)
    ref = np.asarray(jax.jit(jlayers.decode_attention)(q, kc, vc, kv_pos, pos))
    got = decode_attention_split_ref(t(q), k_t, v_t, kv_pos=t(kv_pos),
                                     pos=t(pos), n_sm=n_sm)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATTN_TOL, rtol=0)
    plain = da_ops.decode_attn(t(q), k_t, v_t, kv_pos=t(kv_pos), pos=t(pos))
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATTN_TOL, rtol=0)

    one = np.full((1, s), -1, np.int32)                   # a scalar pos
    one[0, : s // 2] = np.arange(s // 2)
    scalar = np.int32(s // 3)
    ref1 = np.asarray(jax.jit(jlayers.decode_attention)(
        q[:1], kc[:1], vc[:1], one, scalar))
    got1 = decode_attention_split_ref(t(q[:1]), k_t[:1], v_t[:1],
                                      kv_pos=t(one), pos=torch.tensor(scalar),
                                      n_sm=n_sm)
    np.testing.assert_allclose(got1.numpy(), ref1, atol=ATTN_TOL, rtol=0)

    qb, kb, vb = (_bf16_round(x) for x in (q, kc, vc))
    ref_b = np.asarray(jax.jit(jlayers.decode_attention)(qb, kb, vb, kv_pos,
                                                         pos))
    got_b = decode_attention_split_ref(
        t(qb).bfloat16(), t(kb).bfloat16().transpose(1, 2),
        t(vb).bfloat16().transpose(1, 2), kv_pos=t(kv_pos), pos=t(pos),
        n_sm=n_sm)
    err = np.abs(got_b.float().numpy() - ref_b)
    assert (err <= _bf16_tol(vb, ref_b)).all(), float(err.max())


def test_a_row_with_no_valid_slot_gives_zero():
    """Under kv_pos, a ring whose slots all lie past pos (or are empty)
    gives 0 in the plain version and in the kernel's algorithm, where the
    reference's plain softmax gives NaN."""
    rng = np.random.default_rng(2)
    q = t(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = t(rng.standard_normal((2, 1, 70, 16)).astype(np.float32))
    kv_pos = torch.full((2, 70), -1, dtype=torch.int32)
    kv_pos[1, :10] = torch.arange(5, 15, dtype=torch.int32)     # all > pos
    pos = torch.tensor([3, 4], dtype=torch.int32)
    for fn in (decode_attn_plain, decode_attention_split_ref):
        out = fn(q, k, k, kv_pos=kv_pos, pos=pos)
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("s", [1, 40, 192, 448, 2048, 4096, 5000])
@pytest.mark.parametrize("blocks", [4, 16, 32, 64, 264])
def test_split_plan_covers_the_keys_from_shapes_alone(s, blocks):
    """Splits of whole 64-key tiles, none empty, that cover S; one split up
    to three tiles (the serving cache of 192 pays no merge launch); at most
    two blocks per SM's worth; the records' shapes."""
    n, per = split_plan(s, blocks)
    assert per % 64 == 0 and (n - 1) * per < s <= n * per
    if s <= 192:
        assert n == 1
    assert n == 1 or blocks * (n - 1) < 2 * 132
    assert n <= max(1, -(-s // 64) // 2)
    expected = {(192, 16): (1, 192), (4096, 16): (16, 256),
                (2048, 4): (16, 128)}
    if (s, blocks) in expected:
        assert (n, per) == expected[(s, blocks)]


def test_wrapper_takes_one_mask():
    q = torch.zeros((1, 2, 16))
    k = torch.zeros((1, 1, 8, 16))
    n = torch.tensor([8], dtype=torch.int32)
    kv_pos = torch.zeros((1, 8), dtype=torch.int32)
    pos = torch.tensor([3], dtype=torch.int32)
    for kw in ({}, {"lengths": n, "kv_pos": kv_pos, "pos": pos},
               {"kv_pos": kv_pos}, {"lengths": n, "pos": pos}):
        with pytest.raises(ValueError):
            da_ops.decode_attn(q, k, k, **kw)
