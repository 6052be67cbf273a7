"""The port's MoE path against the JAX reference on the CPU: the grouped
expert GEMM plain versions (B4a, B4b), routing, slot assignment and
capacity, the MoE layer on carried weights, whole reduced MoE models
(forward, prefill, decode) and an ``ExpertServer`` with an MoE expert.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``
(``tests/conftest.py`` sets its matmul precision to "highest").  Both sides
compute in float32.  Tolerances: expert ids, slots, capacities, cache
positions and served tokens exact; the GEMM plain versions and the MoE
layer 2e-5 of the largest output (a few ulps, other summation orders);
logits and caches of the reduced models 1e-4 (two layers and the
unembedding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.env import serve_engine as jserve
from repro.kernels.moe_gemm.kernel import grouped_gemm, grouped_swiglu
from repro.kernels.moe_gemm.ref import grouped_gemm_ref as jax_gemm_ref
from repro.kernels.moe_gemm.ref import grouped_swiglu_ref as jax_swiglu_ref
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.env import serve_engine
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models import moe, transformer
from test_torch_lm import _check_cache, _close, _pair

MOE_ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
LAYER_TOL = 2e-5


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# B4a / B4b plain versions
# ---------------------------------------------------------------------------

# (E, C, D, F): the serving capacities 4, 5 and 40, D and F that are not
# powers of two, and one F over the TPU kernel's 128-wide block
GEMM_SHAPES = [(4, 5, 16, 24), (2, 40, 64, 128), (3, 4, 48, 40),
               (16, 4, 32, 256)]


@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_grouped_gemm_plain_versions_match_reference(e, c, d, f):
    rng = np.random.default_rng(e * c + d + f)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    h = moe_ops.expert_swiglu(t(x), t(wg), t(wu))
    y = moe_ops.expert_gemm(h, t(wd))
    assert h.shape == (e, c, f) and y.shape == (e, c, d)
    h_ref = jax.jit(jax_swiglu_ref)(x, wg, wu)
    h_pallas = jax.jit(lambda *a: grouped_swiglu(*a, interpret=True))(x, wg, wu)
    for ref in (h_ref, h_pallas):
        np.testing.assert_allclose(h.numpy(), np.asarray(ref), atol=LAYER_TOL,
                                   rtol=0)
    hn = h.numpy()
    y_ref = jax.jit(jax_gemm_ref)(hn, wd)
    y_pallas = jax.jit(lambda *a: grouped_gemm(*a, interpret=True))(hn, wd)
    for ref in (y_ref, y_pallas):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=LAYER_TOL,
                                   rtol=0)


def test_grouped_gemm_wrappers_on_cpu_use_plain_versions_and_keep_dtype():
    rng = np.random.default_rng(1)
    x = t(rng.standard_normal((2, 3, 8)).astype(np.float32)).bfloat16()
    w = t(rng.standard_normal((2, 8, 12)).astype(np.float32)).bfloat16()
    before = (moe_ops.GEMM_LAUNCHES, moe_ops.SWIGLU_LAUNCHES)
    assert moe_ops.expert_gemm(x, w).dtype == torch.bfloat16
    assert moe_ops.expert_swiglu(x, w, w).dtype == torch.bfloat16
    assert (moe_ops.GEMM_LAUNCHES, moe_ops.SWIGLU_LAUNCHES) == before


# ---------------------------------------------------------------------------
# Routing, slots, capacity
# ---------------------------------------------------------------------------


def test_route_topk_breaks_ties_toward_the_lower_expert():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((32, 8)).astype(np.float32)
    logits[0] = [1, 1, 1, 0, 0, 0, 0, 0]          # a three-way tie for first
    logits[1] = [0, 2, 0, 2, 2, 0, 2, 0]          # four equal, top 4
    logits[2] = 0.0                               # all equal
    logits[3, [5, 7]] = 9.0                       # tie for first, high ids
    for k in (1, 2, 4):
        gates, ids, probs = moe.route_topk(t(logits), k)
        rg, rids, rprobs = jax.jit(lambda x: jmoe.route_topk(x, k))(logits)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
        assert ids.dtype == torch.int32
        np.testing.assert_allclose(gates.numpy(), np.asarray(rg), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs),
                                   atol=1e-6, rtol=0)
    _, ids, _ = moe.route_topk(t(logits), 2)
    assert ids[0].tolist() == [0, 1] and ids[2].tolist() == [0, 1]
    assert ids[3].tolist() == [5, 7]


@pytest.mark.parametrize("n_tokens", [1, 4, 5, 40, 128, 1024, 1500])
def test_slot_in_expert_and_capacity_are_exact(n_tokens):
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b"):
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (reduce_config(get_config(arch)),
                           jax_reduce_config(jax_get_config(arch)))):
            assert moe._capacity(n_tokens, cfg) == jmoe._capacity(n_tokens, jcfg)
            rng = np.random.default_rng(n_tokens + cfg.n_experts)
            ids = rng.integers(0, cfg.n_experts,
                               n_tokens * cfg.top_k).astype(np.int32)
            ref = jax.jit(lambda i: jmoe._slot_in_expert(i, jcfg.n_experts))(ids)
            got = moe._slot_in_expert(t(ids), cfg.n_experts)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # dbrx at the serving shapes: a decode of 4 slots and the buckets
    dbrx = get_config("dbrx-132b")
    assert [moe._capacity(n, dbrx) for n in (4, 16, 32, 64, 128)] == \
        [4, 5, 10, 20, 40]


# ---------------------------------------------------------------------------
# The MoE layer on carried weights
# ---------------------------------------------------------------------------


def _moe_params(cfg, jcfg, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    p.load_state_dict({k: t(v) for k, v in jp.items()}, strict=True)
    return jp, p


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n_tokens", [4, 40, 128])
def test_moe_local_matches_reference(arch, n_tokens):
    """Output and aux loss; at 40 and 128 tokens some assignments overflow
    their expert's capacity and are dropped, as in the reference."""
    cfg = reduce_config(get_config(arch))
    jcfg = jax_reduce_config(jax_get_config(arch))
    jp, p = _moe_params(cfg, jcfg, 3)
    rng = np.random.default_rng(n_tokens)
    x = rng.standard_normal((n_tokens, cfg.d_model)).astype(np.float32)
    # half the tokens lean toward expert 0, so it overflows its capacity
    r0 = np.asarray(jp["router"])[:, 0]
    x[: n_tokens // 2] += 4.0 * r0 / np.linalg.norm(r0)
    ref, raux = jax.jit(lambda p, x: jmoe._moe_local(p, x, jcfg))(jp, x)
    got, aux = moe.moe_block(p, t(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    # the reference's expert init (std 1/sqrt(E)) gives outputs of order
    # 10-30 here, so the float32 tolerance scales with the largest one
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LAYER_TOL * scale, rtol=0)
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-6, rtol=0)
    _, ids, _ = moe.route_topk(t(x) @ p.router, cfg.top_k)
    slots = moe._slot_in_expert(ids.reshape(-1), cfg.n_experts)
    dropped = int((slots >= moe._capacity(n_tokens, cfg)).sum())
    if n_tokens >= 40:
        assert dropped > 0


# ---------------------------------------------------------------------------
# Whole reduced MoE models on carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_layout_and_carried_weights(arch):
    """Dense layers first, then MoE layers; the reference's two stacks land
    on them in order, and the router stays float32."""
    _, cfg, jparams, model = _pair(arch)
    assert model.n_dense == cfg.n_dense_layers
    assert [blk.use_moe for blk in model.layers] == \
        [i >= cfg.n_dense_layers for i in range(cfg.n_layers)]
    moe_wq = np.asarray(jparams["moe_layers"]["attn"]["wq"])
    for j in range(cfg.n_layers - cfg.n_dense_layers):
        blk = model.layers[cfg.n_dense_layers + j]
        np.testing.assert_array_equal(blk.attn.wq.numpy(), moe_wq[j])
        assert blk.moe.router.dtype == torch.float32
    if cfg.n_dense_layers:
        np.testing.assert_array_equal(
            model.layers[0].mlp.w_gate.numpy(),
            np.asarray(jparams["dense_layers"]["mlp"]["w_gate"])[0])
    drawn = transformer.init_params(
        dataclasses.replace(cfg, param_dtype="bfloat16"), seed=1, device="cpu")
    last = drawn.layers[-1].moe
    assert last.router.dtype == torch.float32 and last.w_up.dtype == torch.bfloat16
    # the reference's fan-in is the leading axis: std 1/sqrt(E) for experts
    for name in ("w_gate", "w_up", "w_down"):
        std = float(getattr(last, name).float().std())
        assert abs(std - cfg.n_experts ** -0.5) < 0.1 * cfg.n_experts ** -0.5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_prefill_match_reference(arch):
    jcfg, cfg, jparams, model = _pair(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    ref, raux = jax.jit(lambda p, x: jtf.forward(p, jcfg, x))(jparams, toks)
    got, aux = transformer.forward(model, cfg, t(toks))
    _close(got, ref)
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-5, rtol=0)
    assert float(aux) > 0.0

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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_reference(arch):
    """A padded prefill then 8 decode steps (B3's plain version under full
    attention, the MoE layer at T = 2 tokens per step)."""
    jcfg, cfg, jparams, model = _pair(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
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


# ---------------------------------------------------------------------------
# Serving an MoE expert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_expert_server_matches_reference_token_for_token(arch):
    jcfg, cfg, jparams, model = _pair(arch)
    ref_srv = jserve.ExpertServer("ref", jcfg, jparams, slots=2, max_len=64)
    srv = serve_engine.ExpertServer("port", cfg, model, slots=2, max_len=64)
    rng = np.random.default_rng(12)
    prompts = [(rng.integers(2, cfg.vocab, p), n)
               for p, n in ((12, 5), (30, 7), (50, 30), (9, 3), (20, 6))]
    runs = []
    for server, request in ((ref_srv, jserve.Request),
                            (srv, serve_engine.Request)):
        for rid, (toks, max_new) in enumerate(prompts):
            server.submit(request(rid=rid, tokens=toks, max_new=max_new,
                                  submit_time=1.0))
        done = []
        while server.has_work():
            done.extend(server.step())
        runs.append(([(e["kind"], e["x"]) for e in server.iteration_log],
                     [(r.rid, r.slot, [int(x) for x in r.generated])
                      for r in done]))
    assert runs[1] == runs[0]
    assert srv.iterations == {
        kind: sum(k == kind for k, _ in runs[1][0])
        for kind in ("prefill", "decode")}
    np.testing.assert_array_equal(srv.cache["kv_pos"].numpy(),
                                  np.asarray(ref_srv.cache["kv_pos"]))
    np.testing.assert_array_equal(srv.cache["pos"].numpy(),
                                  np.asarray(ref_srv.cache["pos"]))
