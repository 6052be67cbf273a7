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


# B4a's split on the card: (E, C, D, F, SM count).  dbrx's down projection
# at a decode and the largest bucket on 132 SMs; C past one row tile;
# ragged C, D and F; more SMs than units; one SM
PLAN_CASES = [(16, 4, 10752, 6144, 132), (16, 40, 10752, 6144, 132),
              (3, 70, 200, 300, 7), (4, 5, 1000, 1000, 3), (2, 9, 64, 128, 5),
              (1, 1, 8, 8, 132), (5, 7, 1000, 136, 1), (2, 130, 640, 256, 11)]


@pytest.mark.parametrize("e,c,d,f,n_sm", PLAN_CASES)
def test_gemm_plan_covers_every_element_once(e, c, d, f, n_sm):
    """Each (expert, row tile, column tile, contraction chunk) lies in
    exactly one CTA's range, so every (expert, output column, contraction
    row) is summed once; CTAs differ by at most one unit; a tile is
    written whole by one CTA or merged from the slots of the CTAs that cut
    it, each slot written once and merged once.  The CTAs are one per SM
    (at most one per unit) or, within a tenth of that, as many as take the
    tiles whole and alike, and then nothing is merged."""
    from repro_torch.kernels.moe_gemm.ref import TILE_K, TILE_N, gemm_plan

    plan = gemm_plan(e, c, d, f, n_sm)
    tiles = e * plan.ct * plan.nt
    if plan.ctas != min(n_sm, plan.units):
        assert tiles % plan.ctas == 0 and 9 * n_sm <= 10 * plan.ctas < 10 * n_sm
        assert not plan.merges()
    sizes = np.diff(plan.starts)
    assert sizes.max() - sizes.min() <= 1 and sizes.min() >= 1
    units = np.zeros((e, plan.ct, plan.nt, plan.kc), np.int64)
    whole, slots = set(), {}
    for g, tile, lo, hi, slot in plan.segments():
        ei, ci, ni = plan.tile(tile)
        units[ei, ci, ni, lo:hi] += 1
        if slot is None:
            assert (lo, hi) == (0, plan.kc) and tile not in whole
            whole.add(tile)
        else:
            assert slot // 2 == g and slot not in slots
            slots[slot] = tile
    assert (units == 1).all()
    merged = {}
    for tile, tile_slots in plan.merges():
        assert tile not in whole and tile not in merged
        assert all(slots[s] == tile for s in tile_slots)
        merged[tile] = tile_slots
    assert len(whole) + len(merged) == e * plan.ct * plan.nt
    assert sorted(s for v in merged.values() for s in v) == sorted(slots)
    # every element: (E, C, D, F) at the element level for a small case
    if e * c * d * f <= 2e6:
        cover = np.zeros((e, d, f), np.int64)
        for g, tile, lo, hi, slot in plan.segments():
            ei, _, ni = plan.tile(tile)
            cols = slice(ni * TILE_N, min(f, (ni + 1) * TILE_N))
            cover[ei, lo * TILE_K:min(d, hi * TILE_K), cols] += 1
        assert (cover == plan.ct).all()


def test_gemm_plan_gives_dbrx_whole_tiles():
    """dbrx's down projection on 132 SMs: 384 tiles of 256 columns on 128
    CTAs, 3 each, none cut; at one fewer tile the split is per unit."""
    from repro_torch.kernels.moe_gemm.ref import gemm_plan

    plan = gemm_plan(16, 40, 10752, 6144, 132)
    assert (plan.ctas, plan.ct * plan.nt * plan.e, plan.kc) == (128, 384, 168)
    assert not plan.merges() and all(s is None for *_, s in plan.segments())
    odd = gemm_plan(16, 40, 10752, 6144 - 256, 132)          # 368 tiles
    assert odd.ctas == 132 and odd.merges()


def test_gemm_tiled_takes_bf16_with_16_byte_rows():
    from repro_torch.kernels.moe_gemm.ref import gemm_tiled

    assert gemm_tiled(torch.bfloat16, 10752, 6144)
    assert gemm_tiled(torch.bfloat16, 8, 8)
    assert not gemm_tiled(torch.float32, 10752, 6144)
    assert not gemm_tiled(torch.bfloat16, 10752, 6143)
    assert not gemm_tiled(torch.bfloat16, 100, 64)
    assert not gemm_tiled(torch.bfloat16, 0, 64)


# (E, C, D, F, SM count): shapes the reference's Pallas kernel takes
# (C <= 128, F <= 128 or a multiple, D <= 512 or a multiple), each cut into
# ranges that split tiles (and one that does not)
SPLIT_CASES = [(2, 8, 256, 128, 3), (3, 70, 200, 100, 5), (2, 5, 1024, 256, 7),
               (1, 4, 512, 128, 1)]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,n_sm", SPLIT_CASES)
def test_split_algorithm_matches_reference(e, c, d, f, n_sm, dtype):
    """B4a's algorithm on the card in plain PyTorch (per-CTA float32 sums
    over its chunks, cut tiles merged in CTA order) against the
    reference's Pallas ``grouped_gemm`` in interpret mode and its plain
    ``grouped_gemm_ref``.  float32: 2e-5 of the largest output (summation
    order only).  bfloat16 inputs and outputs: one bf16 rounding step,
    2^-7 of each output plus 2^-7 of the largest (the two round float32
    sums taken in other orders)."""
    from repro_torch.kernels.moe_gemm.ref import (gemm_plan,
                                                  grouped_gemm_split_ref)

    rng = np.random.default_rng(e + c + d + f)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    if dtype == "bfloat16":
        xt, wt = t(x).bfloat16(), t(w).bfloat16()
        xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    else:
        xt, wt, xj, wj = t(x), t(w), x, w
    got = grouped_gemm_split_ref(xt, wt, n_sm).float().numpy()
    refs = (jax.jit(jax_gemm_ref)(xj, wj),
            jax.jit(lambda *a: grouped_gemm(*a, interpret=True))(xj, wj))
    for ref in refs:
        ref = np.asarray(ref, np.float32)
        top = float(np.abs(ref).max())
        if dtype == "bfloat16":
            tol = 2.0 ** -7 * (np.abs(ref) + top)
            assert (np.abs(got - ref) <= tol).all()
        else:
            np.testing.assert_allclose(got, ref, atol=LAYER_TOL * top, rtol=0)
    if n_sm > 1:
        assert gemm_plan(e, c, d, f, n_sm).merges()


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
