"""The port's CUDA kernels (B1 lockstep advance, B2 flash attention, B3
decode attention, B4a/B4b grouped expert GEMM and SwiGLU, B5 chunked WKV
scan, B6 RG-LRU scan) against their plain PyTorch versions, and the
serving steps' CUDA graphs against the same steps run eagerly, on the
card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither ``jax`` nor the reference package, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import training
from repro_torch.env import engine, engine_layout as layout, env as env_lib
from repro_torch.env import profiles
from repro_torch import graphs
from repro_torch.env.serve_engine import ExpertServer, Request
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.kernels.decode_attn.ref import (decode_attention_ref,
                                                 decode_attention_split_ref,
                                                 decode_attn_plain, split_plan)
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn.ref import attention_ref, attention_tiled_ref
from repro_torch.kernels.lockstep_advance import ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ref import (grouped_gemm_ref,
                                              grouped_gemm_split_ref,
                                              grouped_swiglu_ref)
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_chunked_ref, rglru_scan_ref
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref, wkv_groups_ref
from repro_torch.launch import steps
from repro_torch.models import model as model_lib, transformer

N, R, W = 6, 4, 4
LAT_L = 0.030
RUN_CAPS = (2, 4, 1, 3, 4, 2)
WAIT_CAPS = (2, 3, 1, 4, 2, 3)
UP = np.array([True, True, False, True, True, True])
ADMIT_MIN = np.array([-1e30, 0.5, -1e30, 0.7, -1e30, -1e30], np.float32)
FIELDS = ("p", "d_true", "score", "pred_s", "pred_d")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _streams(steps, seeds, rate, dev):
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        dt = (rng.exponential(1.0, steps) / rate).astype(np.float32)
        t_next = np.cumsum(dt, dtype=np.float32)
        out.append({
            "t": np.concatenate([[0.0], t_next[:-1]]).astype(np.float32),
            "t_next": t_next,
            "expert": rng.integers(0, N, steps),
            "p": rng.integers(16, 512, steps).astype(np.int32),
            "d_true": rng.integers(8, 300, steps).astype(np.int32),
            "score": rng.uniform(0.2, 0.95, steps).astype(np.float32),
            "pred_s": rng.uniform(0.2, 0.95, steps).astype(np.float32),
            "pred_d": rng.uniform(8.0, 300.0, steps).astype(np.float32)})
    return {k: torch.as_tensor(np.stack([s[k] for s in out], 1)).to(dev)
            for k in out[0]}                                # (T, B)


@pytest.mark.cuda
@pytest.mark.parametrize("admit_order", engine.ADMIT_ORDERS)
def test_kernel_matches_plain_version_on_card(cuda_device, admit_order):
    """The CUDA kernel against the plain loop on the same card, step by
    step over a crowded ragged drive with a down expert and admission
    floors, three envs each with its own t_next."""
    dev = cuda_device
    pool = profiles.make_pool(N, device=dev)
    st = _streams(200, (0, 1, 2), 20.0, dev)
    wc = torch.tensor(WAIT_CAPS, dtype=torch.int32, device=dev)
    kw = dict(admit_order=admit_order, run_caps=RUN_CAPS,
              wait_caps=WAIT_CAPS, up=torch.as_tensor(UP),
              admit_min=torch.as_tensor(ADMIT_MIN))
    q = layout.empty_queues(N, R, W, batch=3, device=dev)
    clocks = torch.zeros((3, N), device=dev)
    launches = ops.LAUNCHES
    for k in range(200):
        q, _ = layout.push_wait(q, st["expert"][k], t=st["t"][k], wait_cap=wc,
                                **{f: st[f][k] for f in FIELDS})
        ref = engine.advance_all(pool, LAT_L, q, clocks, st["t_next"][k],
                                 backend="torch", **kw)
        got = engine.advance_all(pool, LAT_L, q, clocks, st["t_next"][k],
                                 backend="cuda", **kw)
        for key in layout.QUEUE_KEYS:
            assert torch.equal(ref[0][key], got[0][key]), (k, key)
        assert torch.equal(ref[1], got[1]), k
        for key in engine.ACC_KEYS:
            torch.testing.assert_close(got[2][key], ref[2][key], rtol=1e-6,
                                       atol=0)
        q, clocks = got[0], got[1]
    assert ops.LAUNCHES == launches + 200
    assert int(q["run_i"][..., 0].sum()) > 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands_on_card(cuda_device):
    dev = cuda_device
    m = 8
    q = layout.empty_queues(m, R, W, device=dev)
    par = engine.pool_params(profiles.make_pool(m, device=dev))
    args = [q["run_i"], q["run_f"], q["wait_i"], q["wait_f"], par,
            torch.zeros(m, device=dev), torch.ones(m, device=dev)]
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        ops.lockstep_advance(*bad, latency_L=LAT_L)
    bad = list(args)
    bad[6] = torch.ones(m)                        # t_next on the CPU
    with pytest.raises(ValueError):
        ops.lockstep_advance(*bad, latency_L=LAT_L)
    wide = layout.empty_queues(m, 33, W, device=dev)
    with pytest.raises(ValueError):
        ops.lockstep_advance(wide["run_i"], wide["run_f"], *args[2:],
                             latency_L=LAT_L)


@pytest.mark.cuda
def test_env_step_on_card_launches_once_per_step(cuda_device):
    """An env step on the card goes through the kernel exactly once, for
    every expert of every env."""
    dev = cuda_device
    cfg = env_lib.EnvConfig(n_experts=N)
    pool = env_lib.make_env_pool(cfg, device=dev)
    st = env_lib.reset(cfg, pool, torch.Generator(device=dev).manual_seed(0),
                       4)
    before = ops.LAUNCHES
    for k in range(20):
        st, r, _ = env_lib.step(cfg, pool, st,
                                torch.full((4,), k % N + 1, device=dev))
    assert ops.LAUNCHES == before + 20
    assert bool(torch.isfinite(r).all())


# ---------------------------------------------------------------------------
# Flash attention (B2)
# ---------------------------------------------------------------------------

# (H, KV, dh, S, window): each expert's heads at full width (qwen 16/16/64,
# danube 32/8/120 with a window, starcoder2 48/4/128, dbrx 48/8/128), at
# serving buckets and ragged lengths (S < 32, S not a multiple of 32), and
# the reduced configs' small heads.  starcoder2's G = 12 at S = 16 and 100
# packs 12 heads of a position into 64-row tiles, so tiles split a
# position's heads; a window of 37 binds inside a 64-key tile
FLASH_SHAPES = [(16, 16, 64, 16, 0), (32, 8, 120, 40, 0), (48, 4, 128, 128, 0),
                (32, 8, 120, 200, 64), (8, 2, 24, 7, 0), (4, 4, 16, 70, 8),
                (48, 4, 128, 1, 0), (48, 4, 128, 16, 0), (48, 4, 128, 100, 0),
                (48, 8, 128, 128, 0), (48, 4, 128, 200, 37)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the bf16 kernel against its tile algorithm in plain PyTorch: float32
# summation order and ex2.approx move an output by one bf16 rounding step
# at most, 2^-7 of its magnitude (2^-7 absolute under 1)
TILED_REL_TOL = 2.0 ** -7


def _qkv_randn(b, h, kv, s, dh, dtype, dev, seed, layout="bhsd"):
    """q (b, h, s, dh), k, v (b, kv, s, dh); ``layout="bshd"`` makes them
    (B, H, S, dh) views of (B, S, H, dh) tensors, as the model holds them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n in (h, kv, kv):
        if layout == "bshd":
            x = torch.randn((b, s, n, dh), generator=gen, device=dev).transpose(1, 2)
        else:
            x = torch.randn((b, n, s, dh), generator=gen, device=dev)
        out.append(x.to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,dh,s,window", FLASH_SHAPES)
def test_flash_attn_kernel_matches_plain_version_on_card(
        cuda_device, h, kv, dh, s, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(h * s + dh)
    q = torch.randn((2, h, s, dh), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((2, kv, s, dh), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((2, kv, s, dh), generator=gen, device=cuda_device).to(dtype)
    before = fa_ops.LAUNCHES
    for causal in (True, False):
        got = fa_ops.flash_attn(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=FLASH_TOL[dtype])
    assert fa_ops.LAUNCHES == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,dh,s,window", FLASH_SHAPES)
def test_flash_attn_bf16_kernel_matches_tile_algorithm_on_card(
        cuda_device, h, kv, dh, s, window):
    """The bf16 kernel against ``attention_tiled_ref`` (packed rows, key
    tiles with the skip rule, P rounded to bf16) within one rounding step
    of the output, causal and not."""
    q, k, v = _qkv_randn(2, h, kv, s, dh, torch.bfloat16, cuda_device,
                         h * s + dh + 1)
    for causal in (True, False):
        got = fa_ops.flash_attn(q, k, v, causal=causal, window=window).float()
        tiled = attention_tiled_ref(q, k, v, causal=causal,
                                    window=window).float()
        scale = tiled.abs().clamp(min=1.0)
        assert float(((got - tiled).abs() / scale).max()) <= TILED_REL_TOL


@pytest.mark.cuda
def test_flash_attn_bf16_kernel_long_prefill_on_card(cuda_device):
    """starcoder2's heads at S = 4,096, bf16: 64 key tiles deep, the ring
    of K/V stages reused 32 times per block."""
    q, k, v = _qkv_randn(1, 48, 4, 4096, 128, torch.bfloat16, cuda_device, 7)
    got = fa_ops.flash_attn(q, k, v).float()
    torch.testing.assert_close(got, attention_ref(q, k, v).float(), rtol=0,
                               atol=FLASH_TOL[torch.bfloat16])
    tiled = attention_tiled_ref(q, k, v).float()
    scale = tiled.abs().clamp(min=1.0)
    assert float(((got - tiled).abs() / scale).max()) <= TILED_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,dh,s,window", [(48, 4, 128, 100, 0),
                                              (32, 8, 120, 40, 8),
                                              (8, 2, 24, 7, 0)])
def test_flash_attn_kernel_reads_strided_views_on_card(
        cuda_device, h, kv, dh, s, window, dtype):
    """q, k, v as (B, H, S, dh) views of (B, S, H, dh) tensors give the same
    output, bit for bit, as contiguous copies; the output is a (B, H, S,
    dh) view of a (B, S, H, dh) tensor."""
    q, k, v = _qkv_randn(2, h, kv, s, dh, dtype, cuda_device, s + dh,
                         layout="bshd")
    assert not v.is_contiguous()
    got = fa_ops.flash_attn(q, k, v, window=window)
    want = fa_ops.flash_attn(q.contiguous(), k.contiguous(), v.contiguous(),
                             window=window)
    assert torch.equal(got, want)
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
def test_flash_attn_kernel_unequal_lengths_and_empty_rows_on_card(cuda_device):
    """Sq != Skv (a row past the last key sees all keys under causal), and
    a window of 1 with Sq > Skv leaves rows that see nothing: they are 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((1, 8, 50, 64), generator=gen, device=cuda_device)
    k = torch.randn((1, 2, 37, 64), generator=gen, device=cuda_device)
    for causal, window in ((True, 0), (True, 1), (False, 9)):
        got = fa_ops.flash_attn(q, k, k, causal=causal, window=window)
        ref = attention_ref(q, k, k, causal=causal, window=window)
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)
    empty = fa_ops.flash_attn(q, k, k, causal=True, window=1)[:, :, 37:]
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.cuda
def test_flash_attn_wrapper_rejects_bad_operands_on_card(cuda_device):
    q = torch.zeros((1, 4, 16, 64), device=cuda_device)
    k = torch.zeros((1, 2, 16, 64), device=cuda_device)
    with pytest.raises(TypeError):
        fa_ops.flash_attn(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa_ops.flash_attn(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError):                       # head dim 132
        fa_ops.flash_attn(torch.zeros((1, 4, 16, 132), device=cuda_device),
                          torch.zeros((1, 2, 16, 132), device=cuda_device),
                          torch.zeros((1, 2, 16, 132), device=cuda_device))
    with pytest.raises(ValueError):                       # 4 heads on 3
        fa_ops.flash_attn(q, k[:, :1].expand(1, 3, 16, 64).contiguous(),
                          k[:, :1].expand(1, 3, 16, 64).contiguous())
    with pytest.raises(ValueError):
        fa_ops.flash_attn(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError):
        fa_ops.flash_attn(q, k.cpu(), k.cpu())
    with pytest.raises(ValueError):                       # bf16 head dim 20
        fa_ops.flash_attn(*(torch.zeros((1, n, 16, 20), device=cuda_device,
                                        dtype=torch.bfloat16) for n in (4, 2, 2)))
    wide = torch.zeros((1, 2, 16, 68), device=cuda_device,
                       dtype=torch.bfloat16)[..., :64]    # rows of 136 bytes
    with pytest.raises(ValueError):
        fa_ops.flash_attn(q.bfloat16(), wide, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-3-4b",
                                  "starcoder2-15b"])
def test_prefill_on_card_launches_b2_per_layer(cuda_device, arch):
    """A reduced model's prefill on the card goes through the kernel once
    per layer and agrees with the same prefill on the CPU (plain
    attention) on the same weights, in float32."""
    cfg = reduce_config(get_config(arch))
    model = transformer.init_params(cfg, seed=1, device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 40)), dtype=torch.int32)
    lengths = torch.tensor([40, 23], dtype=torch.int32)
    before = fa_ops.LAUNCHES
    got, cache = transformer.prefill(model, cfg, toks.to(cuda_device), 64,
                                     lengths=lengths.to(cuda_device))
    assert fa_ops.LAUNCHES == before + cfg.n_layers
    ref, rcache = transformer.prefill(model.cpu(), cfg, toks, 64,
                                      lengths=lengths)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    assert torch.equal(cache["kv_pos"].cpu(), rcache["kv_pos"])


# ---------------------------------------------------------------------------
# Decode attention (B3)
# ---------------------------------------------------------------------------

# (B, H, KV, dh, S): the full-attention experts' heads (qwen 16/16/64,
# starcoder2 48/4/128, dbrx 48/8/128) at the serving cache, the reduced
# configs' small heads, and a long cache
DECODE_SHAPES = [(4, 16, 16, 64, 192), (4, 48, 4, 128, 192),
                 (4, 48, 8, 128, 192), (3, 8, 2, 24, 40), (2, 4, 4, 16, 7),
                 (2, 48, 4, 128, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,dh,s", DECODE_SHAPES)
def test_decode_attn_kernel_matches_plain_version_on_card(
        cuda_device, b, h, kv, dh, s, dtype):
    """Ragged lengths with 0 and S among them, read through the serving
    cache's (B, S, KV, dh) layout as a transposed view."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * s + dh)
    q = torch.randn((b, h, dh), generator=gen, device=cuda_device).to(dtype)
    cache = torch.randn((2, b, s, kv, dh), generator=gen,
                        device=cuda_device).to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    lengths = torch.as_tensor(np.random.default_rng(s).integers(1, s + 1, b),
                              dtype=torch.int32)
    lengths[0], lengths[-1] = 0, s
    lengths = lengths.to(cuda_device)
    before = da_ops.LAUNCHES
    got = da_ops.decode_attn(q, k, v, lengths)
    ref = decode_attention_ref(q, k, v, lengths)
    assert da_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    contiguous = da_ops.decode_attn(q, k.contiguous(), v.contiguous(), lengths)
    assert torch.equal(contiguous, got)


@pytest.mark.cuda
def test_decode_attn_wrapper_rejects_bad_operands_on_card(cuda_device):
    q = torch.zeros((2, 8, 64), device=cuda_device)
    k = torch.zeros((2, 2, 16, 64), device=cuda_device)
    n = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        da_ops.decode_attn(q, k.bfloat16(), k.bfloat16(), n)
    with pytest.raises(ValueError):                       # int64 lengths
        da_ops.decode_attn(q, k, k, n.long())
    with pytest.raises(ValueError):                       # lengths on the CPU
        da_ops.decode_attn(q, k, k, n.cpu())
    with pytest.raises(ValueError):                       # dh not contiguous
        da_ops.decode_attn(q, k.transpose(2, 3), k.transpose(2, 3), n)
    with pytest.raises(ValueError):                       # 8 heads on 3
        da_ops.decode_attn(q, k[:, :1].expand(2, 3, 16, 64).contiguous(),
                           k[:, :1].expand(2, 3, 16, 64).contiguous(), n)
    with pytest.raises(ValueError):                       # head dim 132
        da_ops.decode_attn(torch.zeros((2, 8, 132), device=cuda_device),
                           torch.zeros((2, 2, 16, 132), device=cuda_device),
                           torch.zeros((2, 2, 16, 132), device=cuda_device), n)


def _ring_kv_pos(b, s, rng):
    """(kv_pos (b, s), pos (b,)) int32 of ring caches that have wrapped:
    slot j holds the latest position p <= pos with p = j mod s, -1 where
    none is; the first row's pos is -1, so it has no valid slot."""
    pos = rng.integers(s // 2, 3 * s, b)
    pos[0] = -1
    j = np.arange(s)[None, :]
    kv_pos = pos[:, None] - (pos[:, None] - j) % s
    kv_pos[kv_pos < 0] = -1
    return (torch.as_tensor(kv_pos, dtype=torch.int32),
            torch.as_tensor(pos, dtype=torch.int32))


# (B, H, KV, dh, S, splits on a 132-SM H100): danube's heads on its
# serving ring (S = 192, one split) and recurrentgemma's on its window
# (2,048: 16 splits of 128 keys), dh 256 at 7 splits with a ragged last
# tile, G = 12 at 3 splits, G = 48 (three row tiles) at 2, the reduced
# configs' small heads, one key, and starcoder2's heads over 4,096 keys
B3_CASES = [(4, 32, 8, 120, 192, 1), (4, 10, 1, 256, 2048, 16),
            (1, 12, 1, 256, 890, 7), (2, 48, 4, 128, 394, 3),
            (2, 48, 1, 128, 300, 2), (3, 8, 2, 24, 40, 1),
            (2, 4, 4, 16, 1, 1), (4, 48, 4, 128, 4096, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["lengths", "kv_pos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,dh,s,splits", B3_CASES)
def test_decode_attn_kernel_matches_plain_versions_in_both_masks_on_card(
        cuda_device, b, h, kv, dh, s, splits, dtype, mask):
    """Against the plain version of the mask (bf16 2e-2, float32 2e-5, as
    B3 has been held since it was ported) and against the kernel's own
    algorithm in plain PyTorch (``decode_attention_split_ref`` with the
    card's SM count: one bf16 rounding step of the output, 2^-7 of its
    magnitude; float32 2e-5); a row with no valid key gives 0."""
    n_sm = da_ops.sm_count(cuda_device.index or 0)
    if n_sm == 132:                                   # the H100 SXM's plan
        assert split_plan(s, b * kv * -(-(h // kv) // 16), n_sm)[0] == splits
    gen = torch.Generator(device=cuda_device).manual_seed(b * s + dh)
    q = torch.randn((b, h, dh), generator=gen, device=cuda_device).to(dtype)
    cache = torch.randn((2, b, s, kv, dh), generator=gen,
                        device=cuda_device).to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    rng = np.random.default_rng(s + h)
    if mask == "lengths":
        lengths = torch.as_tensor(rng.integers(1, s + 1, b), dtype=torch.int32)
        lengths[0], lengths[-1] = 0, s
        kw = {"lengths": lengths.to(cuda_device)}
    else:
        kv_pos, pos = _ring_kv_pos(b, s, rng)
        kw = {"kv_pos": kv_pos.to(cuda_device), "pos": pos.to(cuda_device)}
    before = da_ops.LAUNCHES
    got = da_ops.decode_attn(q, k, v, **kw)
    assert da_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = decode_attn_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    split = decode_attention_split_ref(q, k, v, n_sm=n_sm, **kw).float()
    diff = (got.float() - split).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= FLASH_TOL[dtype]
    else:
        assert float((diff / split.abs().clamp(min=1.0)).max()) <= TILED_REL_TOL
    if mask == "kv_pos" or b > 1:                     # row 0 has no valid key
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    again = da_ops.decode_attn(q, k.contiguous(), v.contiguous(), **kw)
    assert torch.equal(again, got)                    # deterministic merges


# B3's log-sum-exp: the serving ring (danube's heads over 192 slots, one
# split), granite's heads and one KV head over 4,096 slots (16 splits and
# the merge launch) under a lengths mask and as a wrapped ring, and
# recurrentgemma's ring of 2,048
LSE_CASES = [(4, 32, 8, 120, 192, "kv_pos"), (2, 48, 1, 128, 4096, "lengths"),
             (2, 48, 1, 128, 4096, "kv_pos"), (4, 10, 1, 256, 2048, "kv_pos")]
# float32 sums of the same scores in another order and exp2 approximations:
# within 1e-4 of max(1, |lse|)
LSE_REL_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,dh,s,mask", LSE_CASES)
def test_decode_attn_lse_matches_plain_version_on_card(
        cuda_device, b, h, kv, dh, s, mask, dtype):
    """``return_lse=True``: the output is bit-equal to the call without it,
    and the log-sum-exp is the plain version's (and the split algorithm's)
    within ``LSE_REL_TOL``; row 0 has no valid key: output 0, lse -inf."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * s + dh + 1)
    q = torch.randn((b, h, dh), generator=gen, device=cuda_device).to(dtype)
    cache = torch.randn((2, b, s, kv, dh), generator=gen,
                        device=cuda_device).to(dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    rng = np.random.default_rng(s + h + 1)
    if mask == "lengths":
        lengths = torch.as_tensor(rng.integers(1, s + 1, b), dtype=torch.int32)
        lengths[0] = 0
        kw = {"lengths": lengths.to(cuda_device)}
    else:
        kv_pos, pos = _ring_kv_pos(b, s, rng)
        kw = {"kv_pos": kv_pos.to(cuda_device), "pos": pos.to(cuda_device)}
    before = da_ops.LAUNCHES
    got, lse = da_ops.decode_attn(q, k, v, return_lse=True, **kw)
    assert da_ops.LAUNCHES == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(got, da_ops.decode_attn(q, k, v, **kw))
    ref, ref_lse = decode_attn_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    n_sm = da_ops.sm_count(cuda_device.index or 0)
    _, split_lse = decode_attention_split_ref(q, k, v, n_sm=n_sm,
                                              return_lse=True, **kw)
    for want in (ref_lse, split_lse):
        empty = want == float("-inf")
        assert torch.equal(lse == float("-inf"), empty)
        err = (lse[~empty] - want[~empty]).abs()
        assert float((err / want[~empty].abs().clamp(min=1.0)).max()) \
            <= LSE_REL_TOL
    assert bool((lse[0] == float("-inf")).all())
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [192, 4096])
def test_decode_attn_lse_of_rows_with_no_valid_slot_on_card(cuda_device, s):
    """Rows with no valid slot, through one split (192 slots) and through
    the merge launch (4,096): output 0 and lse -inf, no NaN, under
    ``lengths`` of 0 and under a ring whose slots are all empty or all
    past ``pos``."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q = torch.randn((3, 48, 128), generator=gen,
                    device=cuda_device).bfloat16()
    k = torch.randn((3, 1, s, 128), generator=gen,
                    device=cuda_device).bfloat16()
    lengths = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    kv_pos = torch.full((3, s), -1, dtype=torch.int32, device=cuda_device)
    kv_pos[2] = 50                                  # all past pos = 10
    pos = torch.tensor([5, 7, 10], dtype=torch.int32, device=cuda_device)
    for kw in ({"lengths": lengths}, {"kv_pos": kv_pos, "pos": pos}):
        got, lse = da_ops.decode_attn(q, k, k, return_lse=True, **kw)
        assert bool((lse == float("-inf")).all())
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_decode_attn_wrapper_rejects_bad_kv_pos_on_card(cuda_device):
    q = torch.zeros((2, 8, 64), device=cuda_device)
    k = torch.zeros((2, 2, 16, 64), device=cuda_device)
    kv_pos = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    n = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
    for bad_kv_pos, bad_pos in ((kv_pos.long(), pos), (kv_pos.cpu(), pos),
                                (kv_pos[:, :15], pos), (kv_pos[:1], pos),
                                (kv_pos.t().contiguous().t(), pos),
                                (kv_pos, pos.long()), (kv_pos, pos.cpu()),
                                (kv_pos, pos[:1]), (kv_pos, 3)):
        with pytest.raises(ValueError):
            da_ops.decode_attn(q, k, k, kv_pos=bad_kv_pos, pos=bad_pos)
    with pytest.raises(ValueError):                       # two masks
        da_ops.decode_attn(q, k, k, n, kv_pos=kv_pos, pos=pos)
    with pytest.raises(ValueError):                       # no mask
        da_ops.decode_attn(q, k, k)
    with pytest.raises(ValueError):                       # kv_pos, no pos
        da_ops.decode_attn(q, k, k, kv_pos=kv_pos)
    with pytest.raises(ValueError):                       # head dim 264
        z = torch.zeros((2, 2, 16, 264), device=cuda_device)
        da_ops.decode_attn(torch.zeros((2, 8, 264), device=cuda_device), z, z, n)
    scalar = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    da_ops.decode_attn(q, k, k, kv_pos=kv_pos, pos=scalar)  # () pos is taken


# ---------------------------------------------------------------------------
# The serving steps as CUDA graphs
# ---------------------------------------------------------------------------


def _server_launches(srv) -> tuple:
    """Each counter's launches from a server's iterations, in the order of
    ``graphs.COUNTERS``: B2 n_layers per prefill, B3 n_layers per decode,
    B4b and B4a once per MoE layer per prefill and per decode."""
    cfg, it = srv.cfg, srv.iterations
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
    both = (it["prefill"] + it["decode"]) * n_moe
    return (0, it["prefill"] * cfg.n_layers, it["decode"] * cfg.n_layers,
            both, both, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-3-4b",
                                  "dbrx-132b"])
def test_graphed_expert_server_matches_eager_on_card(cuda_device, arch):
    """The same requests through a graphed server and an eager one on the
    same weights give the same iterations and tokens, and each server's
    launches are exactly those its iterations imply (a replay counts its
    capture's launches; the capture itself counts none)."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=3, device=cuda_device)
    rng = np.random.default_rng(4)
    prompts = [(rng.integers(2, cfg.vocab, p), n)
               for p, n in ((12, 5), (30, 7), (40, 30), (9, 3), (100, 6))]
    runs = []
    for graphed in (True, False):
        srv = ExpertServer("s", cfg, params, slots=2, max_len=192,
                           graphs=graphed)
        assert srv.graphed == graphed
        before = graphs.launch_counts()
        for rid, (toks, n) in enumerate(prompts):
            srv.submit(Request(rid=rid, tokens=toks, max_new=n))
        done = []
        while srv.has_work():
            done.extend(srv.step())
        got = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
        assert got == _server_launches(srv), (graphed, got)
        runs.append(([(e["kind"], e["x"]) for e in srv.iteration_log],
                     [(r.rid, r.generated) for r in done]))
        if graphed:
            assert set(srv._graphs) == {"decode", ("prefill", 16),
                                        ("prefill", 32), ("prefill", 64),
                                        ("prefill", 128)}
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_graphed_recurrent_decode_matches_eager_on_card(cuda_device, arch):
    """Ten greedy decode steps replayed from a graph give bit-equal logits
    to the model's step run eagerly on a copy of the cache; a step launches
    B3 once per attention layer (none for RWKV6) and the scans never."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=5, device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(6).integers(2, cfg.vocab,
                                                             (2, 16)),
                           dtype=torch.int32, device=cuda_device)
    _, cache = steps.make_prefill_step(cfg, 32)(params, toks)
    n_attn = sum(1 for p in params.layers if hasattr(p, "wq"))
    eager = lambda p, c, t: model_lib.decode_step(p, cfg, c, t)
    outs = []
    for decode, c in ((steps.make_decode_step(cfg), cache),
                      (eager, steps.clone_cache(cache))):
        tok, logits_seen = toks[:, -1], []
        before = graphs.launch_counts()
        for _ in range(10):
            logits, c = decode(params, c, tok)
            logits_seen.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        got = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
        assert got == (0, 0, 10 * n_attn, 0, 0, 0, 0), (decode, got)
        outs.append(logits_seen)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_graphed_recurrent_decode_serves_every_prompt_from_one_capture(
        cuda_device, arch):
    """Three prompts of one batch shape through one decode step: the first
    call captures, each later prompt's cache is copied into the step's own,
    and every prompt's five steps give the model's eager logits bit for
    bit; the prompts' own caches are left as they were."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=7, device=cuda_device)
    rng = np.random.default_rng(8)
    prefill = steps.make_prefill_step(cfg, 32)
    decode = steps.make_decode_step(cfg)
    for _ in range(3):
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, (2, 16)),
                               dtype=torch.int32, device=cuda_device)
        _, cache = prefill(params, toks)
        kept = steps.clone_cache(cache)
        c, e = cache, steps.clone_cache(cache)
        tok = toks[:, -1]
        for i in range(5):
            got, c = decode(params, c, tok)
            ref, e = model_lib.decode_step(params, cfg, e, tok)
            assert torch.equal(got, ref), i
            tok = got.argmax(-1).to(torch.int32)
        assert len(decode.graphs) == 1
        for a, b in zip(_cache_leaves(cache), _cache_leaves(kept)):
            assert torch.equal(a, b)


def _cache_leaves(c):
    if isinstance(c, (dict, list)):
        return [y for x in (c.values() if isinstance(c, dict) else c)
                for y in _cache_leaves(x)]
    return [c]


# ---------------------------------------------------------------------------
# Grouped expert GEMM and SwiGLU (B4a, B4b)
# ---------------------------------------------------------------------------

# (E, C, D, F): dbrx's decode and C=40 buckets at a cut depth, the serving
# capacities 5, 10 and 20, C=64 (one block's most rows) and 70 (two row
# tiles), and ragged tails in C, D and F (D or F not a multiple of 16
# bytes' worth of elements takes the element-wise copies)
MOE_SHAPES = [(16, 4, 6144, 1024), (16, 40, 512, 1280), (4, 5, 100, 130),
              (3, 10, 64, 7), (2, 20, 33, 257), (1, 1, 8, 4), (2, 9, 70, 132),
              (1, 64, 24, 256), (2, 70, 40, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", MOE_SHAPES)
def test_moe_gemm_kernels_match_plain_versions_on_card(cuda_device, e, c, d,
                                                       f, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(e * c + d + f)
    x = torch.randn((e, c, d), generator=gen, device=cuda_device).to(dtype)
    wg, wu = ((torch.randn((e, d, f), generator=gen, device=cuda_device)
               / d ** 0.5).to(dtype) for _ in range(2))
    wd = (torch.randn((e, f, d), generator=gen, device=cuda_device)
          / f ** 0.5).to(dtype)
    before = (moe_ops.GEMM_LAUNCHES, moe_ops.SWIGLU_LAUNCHES)
    h = moe_ops.expert_swiglu(x, wg, wu)
    y = moe_ops.expert_gemm(h, wd)
    assert (moe_ops.GEMM_LAUNCHES, moe_ops.SWIGLU_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert h.dtype == dtype and h.shape == (e, c, f) and y.shape == (e, c, d)
    # outputs reach ~20 (products of unit normals), where a bf16 rounding
    # step is 2^-3: each element is held to atol + rtol * |ref|
    for got, ref in ((h, grouped_swiglu_ref(x, wg, wu)),
                     (y, grouped_gemm_ref(h, wd))):
        torch.testing.assert_close(got.float(), ref.float(),
                                   rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.cuda
def test_moe_gemm_wrappers_reject_bad_operands_on_card(cuda_device):
    x = torch.zeros((2, 4, 16), device=cuda_device)
    w = torch.zeros((2, 16, 8), device=cuda_device)
    with pytest.raises(TypeError):
        moe_ops.expert_gemm(x, w.bfloat16())
    with pytest.raises(TypeError):
        moe_ops.expert_gemm(x.double(), w.double())
    with pytest.raises(ValueError):                       # D mismatch
        moe_ops.expert_gemm(x, torch.zeros((2, 15, 8), device=cuda_device))
    with pytest.raises(ValueError):                       # E mismatch
        moe_ops.expert_swiglu(x, w[:1], w[:1])
    with pytest.raises(ValueError):                       # gate/up differ
        moe_ops.expert_swiglu(x, w, torch.zeros((2, 16, 9), device=cuda_device))
    with pytest.raises(ValueError):
        moe_ops.expert_gemm(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        moe_ops.expert_gemm(x, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_prefill_and_decode_on_card_launch_b3_b4(cuda_device, arch):
    """A reduced MoE model on the card: a prefill launches B4b and B4a once
    per MoE layer (and B2 once per layer); each decode step launches B3 once
    per layer and B4b, B4a once per MoE layer.  Logits agree with the same
    steps on the CPU (plain versions) on the same weights, in float32."""
    cfg = reduce_config(get_config(arch))
    n_moe = cfg.n_layers - cfg.n_dense_layers
    model = transformer.init_params(cfg, seed=1, device=cuda_device)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)),
                           dtype=torch.int32)
    lengths = torch.tensor([40, 23], dtype=torch.int32)
    steps = torch.as_tensor(rng.integers(0, cfg.vocab, (6, 2)),
                            dtype=torch.int32)
    counts = lambda: (fa_ops.LAUNCHES, da_ops.LAUNCHES, moe_ops.SWIGLU_LAUNCHES,
                      moe_ops.GEMM_LAUNCHES)
    before = counts()
    got, cache = transformer.prefill(model, cfg, toks.to(cuda_device), 64,
                                     lengths=lengths.to(cuda_device))
    assert tuple(a - b for a, b in zip(counts(), before)) == \
        (cfg.n_layers, 0, n_moe, n_moe)
    cpu = transformer.init_params(cfg, seed=1, device="cpu")
    cpu.load_state_dict(model.state_dict())
    ref, rcache = transformer.prefill(cpu, cfg, toks, 64, lengths=lengths)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    for i in range(6):
        before = counts()
        got, cache = transformer.decode_step(model, cfg, cache,
                                             steps[i].to(cuda_device))
        assert tuple(a - b for a, b in zip(counts(), before)) == \
            (0, cfg.n_layers, n_moe, n_moe)
        ref, rcache = transformer.decode_step(cpu, cfg, rcache, steps[i])
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    assert torch.equal(cache["kv_pos"].cpu(), rcache["kv_pos"])


# ---------------------------------------------------------------------------
# Chunked WKV scan (B5) and RG-LRU scan (B6)
# ---------------------------------------------------------------------------

# (B, H, T, K, V, chunk): rwkv6-7b's heads (64 x 64, chunk 32) at B=4 and
# at B=1 (B*H below the SM count: V split over two blocks), a tail chunk
# (T=100), chunk > T, V != K, chunk 64 and the reduced config's heads
WKV_SHAPES = [(4, 64, 128, 64, 64, 32), (1, 64, 100, 64, 64, 32),
              (2, 3, 5, 64, 64, 32), (2, 3, 70, 64, 32, 16),
              (1, 2, 130, 48, 64, 64), (2, 4, 64, 16, 16, 8)]
# float32: the chunked algorithm against the token recurrence differs by
# float32 rounding of cumulative decays of up to ~240 (a few 1e-6 of
# outputs of up to ~100); bf16: one rounding of y (2^-8 relative), the
# state stays float32
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _wkv_inputs(b, h, n, kd, vd, gen, dev, dtype):
    r, k = (torch.randn((b, h, n, kd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    v = torch.randn((b, h, n, vd), generator=gen, device=dev).to(dtype)
    expo = (torch.randn((b, h, n, kd), generator=gen, device=dev) - 0.6)
    dlog = -torch.exp(expo.clamp(-8.0, 2.0))          # the model's range
    u = torch.randn((h, kd), generator=gen, device=dev) * 0.3
    return r, k, v, dlog, u


def _within(got, ref, tol):
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,kd,vd,chunk", WKV_SHAPES)
def test_wkv_kernel_matches_token_recurrence_on_card(cuda_device, b, h, n, kd,
                                                     vd, chunk, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(b * h + n + kd)
    r, k, v, dlog, u = _wkv_inputs(b, h, n, kd, vd, gen, cuda_device, dtype)
    before = wkv_ops.LAUNCHES
    y, state = wkv_ops.wkv(r, k, v, dlog, u.to(dtype), chunk=chunk)
    assert wkv_ops.LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == v.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, kd, vd)
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, dlog, u.to(dtype))
    _within(y, y_ref, WKV_TOL[dtype])
    _within(state, s_ref, WKV_TOL[torch.float32])


@pytest.mark.cuda
def test_wkv_kernel_reads_the_models_layout_on_card(cuda_device):
    """r, k, v, dlog as (B, T, H, K) tensors handed over transposed: read in
    place through strides; y comes back in the same layout."""
    b, n, h, kd = 2, 96, 8, 64
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    r, k, v, dlog, u = _wkv_inputs(b, h, n, kd, kd, gen, cuda_device,
                                   torch.bfloat16)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (r, k, v, dlog)]
    y, state = wkv_ops.wkv(*views, u, chunk=32)
    assert y.transpose(1, 2).is_contiguous()
    y_ref, s_ref = wkv_ops.wkv(r, k, v, dlog, u, chunk=32)
    assert torch.equal(y, y_ref) and torch.equal(state, s_ref)


@pytest.mark.cuda
def test_wkv_wrapper_rejects_bad_operands_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    r, k, v, dlog, u = _wkv_inputs(1, 2, 16, 64, 64, gen, cuda_device,
                                   torch.float32)
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, k.bfloat16(), v, dlog, u)
    with pytest.raises(TypeError):                        # dlog in bf16
        wkv_ops.wkv(r, k, v, dlog.bfloat16(), u)
    with pytest.raises(ValueError):                       # u's heads
        wkv_ops.wkv(r, k, v, dlog, u[:1])
    with pytest.raises(ValueError):                       # chunk over 64
        long = _wkv_inputs(1, 2, 130, 64, 64, gen, cuda_device, torch.float32)
        wkv_ops.wkv(*long, chunk=128)
    with pytest.raises(ValueError):                       # K over 64
        big = torch.zeros((1, 2, 16, 128), device=cuda_device)
        wkv_ops.wkv(big, big, big, big, torch.zeros((2, 128), device=cuda_device))
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k, v, dlog.transpose(2, 3).contiguous().transpose(2, 3), u)
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k, v, dlog, u.cpu())


# both sides of the wrapper's switch at each shape: the default plan, and a
# group of 32 tokens (the three passes wherever T > 32) or of 4,096 (one
# walk); (B, H, T, K, V, group), with K = 50 where rows are not 16-byte
# multiples (element loads instead of cp.async)
WKV_SWITCH = [(4, 64, 128, 64, 64, 32), (1, 64, 100, 64, 64, 32),
              (1, 64, 1000, 64, 64, 4096), (2, 3, 70, 64, 32, 32),
              (2, 3, 70, 50, 36, 32), (1, 2, 300, 48, 64, 4096),
              (2, 4, 33, 16, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,kd,vd,group", WKV_SWITCH)
def test_wkv_kernel_matches_plain_versions_across_the_switch_on_card(
        cuda_device, b, h, n, kd, vd, group, dtype, monkeypatch):
    """The kernel with ``GROUP`` set to ``group``, against the token
    recurrence and against its own algorithm in plain PyTorch
    (``wkv_groups_ref`` with the same group), and against the default
    plan's call: one launch counted, whatever the kernels per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * h + n + kd + 7)
    r, k, v, dlog, u = _wkv_inputs(b, h, n, kd, vd, gen, cuda_device, dtype)
    y_def, s_def = wkv_ops.wkv(r, k, v, dlog, u.to(dtype))
    monkeypatch.setattr(wkv_ops, "GROUP", group)
    before = wkv_ops.LAUNCHES
    y, state = wkv_ops.wkv(r, k, v, dlog, u.to(dtype))
    assert wkv_ops.LAUNCHES == before + 1
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, dlog, u.to(dtype))
    _within(y, y_ref, WKV_TOL[dtype])
    _within(state, s_ref, WKV_TOL[torch.float32])
    y_alg, s_alg = wkv_groups_ref(r, k, v, dlog, u.to(dtype), group=group)
    _within(y, y_alg, WKV_TOL[dtype])
    _within(state, s_alg, WKV_TOL[torch.float32])
    _within(y, y_def, WKV_TOL[dtype])
    _within(state, s_def, WKV_TOL[torch.float32])
    assert wkv_ops.kernels_per_call(n) == (1 if n <= group else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [wkv_ops.GROUP, 32])
def test_wkv_kernel_reads_the_models_layout_in_groups_on_card(cuda_device,
                                                              group,
                                                              monkeypatch):
    """(B, T, H, K) tensors handed over transposed, one walk and three
    passes alike: bit-equal to the same call on contiguous copies."""
    b, n, h, kd = 2, 200, 8, 64
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    r, k, v, dlog, u = _wkv_inputs(b, h, n, kd, kd, gen, cuda_device,
                                   torch.bfloat16)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (r, k, v, dlog)]
    monkeypatch.setattr(wkv_ops, "GROUP", group)
    y, state = wkv_ops.wkv(*views, u)
    y_ref, s_ref = wkv_ops.wkv(r, k, v, dlog, u)
    assert torch.equal(y, y_ref) and torch.equal(state, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["clip", "deep"])
@pytest.mark.parametrize("group", [wkv_ops.GROUP, 32])
def test_wkv_kernel_extreme_decays_on_card(cuda_device, decay, group, dtype,
                                           monkeypatch):
    """dlog = -e^2 everywhere (the model's clip), or -40 on every 5th row
    (far below it): finite, and within the tolerances of the token
    recurrence."""
    b, h, n, kd = 2, 4, 160, 64
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    r, k, v, dlog, u = _wkv_inputs(b, h, n, kd, kd, gen, cuda_device, dtype)
    if decay == "clip":
        dlog = torch.full_like(dlog, -float(np.exp(2.0)))
    else:
        dlog[:, :, ::5] = -40.0
    monkeypatch.setattr(wkv_ops, "GROUP", group)
    y, state = wkv_ops.wkv(r, k, v, dlog, u.to(dtype))
    assert bool(torch.isfinite(y.float()).all() & torch.isfinite(state).all())
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, dlog, u.to(dtype))
    _within(y, y_ref, WKV_TOL[dtype])
    _within(state, s_ref, WKV_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 700])
def test_wkv_kernel_graphed_equals_eager_on_card(cuda_device, n):
    """One call captured in a CUDA graph (one walk at T=128, three passes
    at T=700) and replayed on new inputs copied into its buffers: bit-equal
    to the same call run eagerly."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    bufs = _wkv_inputs(2, 8, n, 64, 64, gen, cuda_device, torch.bfloat16)
    u = bufs[-1]
    wkv_ops.wkv(*bufs[:4], u)                      # build and set up eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wkv_ops.wkv(*bufs[:4], u)
    new = _wkv_inputs(2, 8, n, 64, 64, gen, cuda_device, torch.bfloat16)
    for dst, src in zip(bufs, new):
        dst.copy_(src)
    graph.replay()
    y, state = wkv_ops.wkv(*bufs[:4], u)
    assert torch.equal(out[0], y) and torch.equal(out[1], state)


# (B, T, W): recurrentgemma-2b's width at B=4, ragged T and W, one step
LRU_SHAPES = [(4, 128, 2560), (1, 37, 100), (2, 1, 64), (3, 300, 33)]
LRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,w", LRU_SHAPES)
def test_lru_kernel_matches_plain_version_on_card(cuda_device, b, n, w, dtype):
    """A non-zero h0 and some log_a > 0, which the wrapper clamps to 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * n + w)
    log_a = (-torch.rand((b, n, w), generator=gen, device=cuda_device) * 2
             + 0.1).to(dtype)
    x = torch.randn((b, n, w), generator=gen, device=cuda_device).to(dtype)
    h0 = torch.randn((b, w), generator=gen, device=cuda_device)
    assert bool((log_a > 0).any())
    before = lru_ops.LAUNCHES
    got = lru_ops.lru(log_a, x, h0)
    assert lru_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _within(got, rglru_scan_ref(log_a.clamp(max=0.0), x, h0), LRU_TOL[dtype])


# (B, T, W, chunk): both sides of the wrapper's switch, forced (None: the
# wrapper's own plan)
LRU_SWITCH = [(4, 128, 2560, 32), (1, 4096, 2560, None), (1, 4096, 256, 4096),
              (2, 300, 33, 64), (3, 65, 100, 64), (2, 7, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,w,chunk", LRU_SWITCH)
def test_lru_kernel_matches_plain_versions_across_the_switch_on_card(
        cuda_device, b, n, w, chunk, dtype, monkeypatch):
    """The kernel with its ``plan`` forced to ``chunk`` (a chunk of T or
    more is the single walk) against the serial plain version and the
    two-pass one."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * n + w + 3)
    log_a = (-torch.rand((b, n, w), generator=gen, device=cuda_device) * 8
             + 0.05).to(dtype)
    x = torch.randn((b, n, w), generator=gen, device=cuda_device).to(dtype)
    h0 = torch.randn((b, w), generator=gen, device=cuda_device)
    if chunk is not None:
        monkeypatch.setattr(lru_ops, "plan", lambda n_t: chunk)
    before = lru_ops.LAUNCHES
    got = lru_ops.lru(log_a, x, h0)
    assert lru_ops.LAUNCHES == before + 1
    _within(got, rglru_scan_ref(log_a.clamp(max=0.0), x, h0), LRU_TOL[dtype])
    _within(got, rglru_chunked_ref(log_a, x, h0, lru_ops.plan(n)),
            LRU_TOL[dtype])
    assert lru_ops.kernels_per_call(n) == (1 if n <= lru_ops.plan(n) else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 16])
def test_lru_kernel_extreme_decays_on_card(cuda_device, chunk, monkeypatch):
    """log_a = -80 on every 7th step (a decay that underflows to 0):
    finite, and equal to the plain version within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    log_a = -torch.rand((2, 200, 96), generator=gen, device=cuda_device) * 2
    log_a[:, ::7] = -80.0
    x = torch.randn((2, 200, 96), generator=gen, device=cuda_device)
    h0 = torch.randn((2, 96), generator=gen, device=cuda_device)
    if chunk is not None:
        monkeypatch.setattr(lru_ops, "plan", lambda n_t: chunk)
    got = lru_ops.lru(log_a, x, h0)
    assert bool(torch.isfinite(got).all())
    _within(got, rglru_scan_ref(log_a, x, h0), LRU_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1000])
def test_lru_kernel_graphed_equals_eager_on_card(cuda_device, n):
    """One call captured in a CUDA graph (the single walk at T=128, two
    passes at T=1,000) and replayed on new inputs: bit-equal to eager."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    mk = lambda: (-torch.rand((2, n, 512), generator=gen, device=cuda_device),
                  torch.randn((2, n, 512), generator=gen, device=cuda_device),
                  torch.randn((2, 512), generator=gen, device=cuda_device))
    bufs = mk()
    lru_ops.lru(*bufs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lru_ops.lru(*bufs)
    for dst, src in zip(bufs, mk()):
        dst.copy_(src)
    graph.replay()
    assert torch.equal(out, lru_ops.lru(*bufs))
    assert lru_ops.kernels_per_call(n) == (1 if n <= lru_ops.SINGLE_T else 2)


@pytest.mark.cuda
def test_lru_wrapper_rejects_bad_operands_on_card(cuda_device):
    z = torch.zeros((2, 8, 16), device=cuda_device)
    h0 = torch.zeros((2, 16), device=cuda_device)
    with pytest.raises(TypeError):
        lru_ops.lru(z, z.bfloat16(), h0)
    with pytest.raises(TypeError):
        lru_ops.lru(z, z, h0.bfloat16())
    with pytest.raises(ValueError):
        lru_ops.lru(z, z, h0[:1])
    with pytest.raises(ValueError):
        lru_ops.lru(z, z.transpose(1, 2).contiguous().transpose(1, 2), h0)
    with pytest.raises(ValueError):
        lru_ops.lru(z, z, h0.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("which", range(5))
def test_wkv_wrapper_refuses_a_gradient_on_card(cuda_device, which):
    """B5 has a backward in neither package: with gradients enabled and
    one input that requires one (r, k, v, the decay or u), the wrapper
    raises, naming the training forward, and launches nothing; under
    ``torch.no_grad()`` the same inputs run the kernel and agree with the
    token recurrence."""
    gen = torch.Generator(device=cuda_device).manual_seed(which)
    args = list(_wkv_inputs(2, 4, 64, 64, 64, gen, cuda_device,
                            torch.float32))
    args[which] = args[which].clone().requires_grad_(True)
    before = wkv_ops.LAUNCHES
    with pytest.raises(NotImplementedError, match="training forward"):
        wkv_ops.wkv(*args)
    assert wkv_ops.LAUNCHES == before
    with torch.no_grad():
        y, state = wkv_ops.wkv(*args)
        y_ref, s_ref = rwkv6_scan_ref(*args)
    assert wkv_ops.LAUNCHES == before + 1 and not y.requires_grad
    _within(y, y_ref, WKV_TOL[torch.float32])
    _within(state, s_ref, WKV_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("which", range(3))
def test_lru_wrapper_refuses_a_gradient_on_card(cuda_device, which):
    """B6 likewise: with gradients enabled and one input that requires
    one (log_a, b or h0) the wrapper raises, naming the training forward,
    and launches nothing; under ``torch.no_grad()`` it runs and agrees
    with the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(which)
    args = [-torch.rand((2, 96, 256), generator=gen, device=cuda_device),
            torch.randn((2, 96, 256), generator=gen, device=cuda_device),
            torch.randn((2, 256), generator=gen, device=cuda_device)]
    args[which] = args[which].clone().requires_grad_(True)
    before = lru_ops.LAUNCHES
    with pytest.raises(NotImplementedError, match="training forward"):
        lru_ops.lru(*args)
    assert lru_ops.LAUNCHES == before
    with torch.no_grad():
        got = lru_ops.lru(*args)
        want = rglru_scan_ref(*args)
    assert lru_ops.LAUNCHES == before + 1 and not got.requires_grad
    _within(got, want, LRU_TOL[torch.float32])


# ---------------------------------------------------------------------------
# Redesigned B1 at every group width, B4a's split kernel, and the routing
# loop and recurrent prefill replayed from CUDA graphs
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 5, 8, 32])
def test_kernel_bit_exact_at_every_width_on_card(cuda_device, width):
    """The kernel against the plain loop with R = W = ``width`` (one lane
    group of 8 per row up to 8 slots, a warp past it) and with R and W
    apart, under all four admission orders: a crowded drive with a down
    expert and admission floors, so the wide queues fill."""
    dev = cuda_device
    pool = profiles.make_pool(N, device=dev)
    st = _streams(120, (3, 4, 5), 60.0, dev)
    for r, w in ((width, width), (width, max(1, 9 - width))):
        for order in engine.ADMIT_ORDERS:
            kw = dict(admit_order=order, up=torch.as_tensor(UP),
                      admit_min=torch.as_tensor(ADMIT_MIN))
            q = layout.empty_queues(N, r, w, batch=3, device=dev)
            clocks = torch.zeros((3, N), device=dev)
            for k in range(120):
                q, _ = layout.push_wait(q, st["expert"][k], t=st["t"][k],
                                        **{f: st[f][k] for f in FIELDS})
                ref = engine.advance_all(pool, LAT_L, q, clocks,
                                         st["t_next"][k], backend="torch", **kw)
                got = engine.advance_all(pool, LAT_L, q, clocks,
                                         st["t_next"][k], backend="cuda", **kw)
                for key in layout.QUEUE_KEYS:
                    assert torch.equal(ref[0][key], got[0][key]), (r, w, k, key)
                assert torch.equal(ref[1], got[1]), (r, w, k)
                for key in engine.ACC_KEYS:
                    if key in ("done", "viol"):
                        assert torch.equal(got[2][key], ref[2][key])
                    else:
                        torch.testing.assert_close(got[2][key], ref[2][key],
                                                   rtol=1e-6, atol=0)
                q, clocks = got[0], got[1]
            assert int(q["wait_i"][..., 0].sum()) > 0, (r, w, order)


# (E, C, D, F): dbrx's down projection at every serving capacity, and
# ragged shapes the split path takes (C, D, F not multiples of the tiles;
# C past one row tile) and one it does not (F not a multiple of 8)
B4A_SHAPES = [(16, c, 10752, 6144) for c in (4, 5, 10, 20, 40)] + [
    (3, 70, 200, 1000), (5, 7, 1000, 136), (2, 9, 64, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", B4A_SHAPES)
def test_grouped_gemm_split_kernel_on_card(cuda_device, e, c, d, f):
    """B4a in bf16 within 2e-2 + 2e-2 |ref| of its plain version, as close
    to the split algorithm in plain PyTorch, and bit-equal over two calls
    (the split and the merge order are fixed)."""
    gen = torch.Generator(device=cuda_device).manual_seed(e + c + d + f)
    x = torch.randn((e, c, d), generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn((e, d, f), generator=gen, device=cuda_device)
         / d ** 0.5).bfloat16()
    got = moe_ops.expert_gemm(x, w)
    again = moe_ops.expert_gemm(x, w)
    assert torch.equal(got, again)
    tol = FLASH_TOL[torch.bfloat16]
    for ref in (grouped_gemm_ref(x, w),
                grouped_gemm_split_ref(x, w, moe_ops.sm_count(cuda_device))):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_fmt,n,n_envs", [("padded", 6, 4),
                                              ("segments", 64, 3)])
def test_graphed_evaluate_matches_eager_on_card(cuda_device, obs_fmt, n,
                                                n_envs):
    """Every policy routed with each step replayed from a CUDA graph and
    with eager steps, from the same seeds: the same metrics and final env
    state bit for bit, B1 once per step in both; the segments setting has
    ragged caps."""
    from repro_torch.core import sac
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(n, ragged_caps=obs_fmt == "segments",
                                   device=cuda_device)
    model = sac.init_params(route.sac_config(env_cfg), seed=2,
                            device=cuda_device)
    for pol in route.make_policies(env_cfg, model, obs_fmt=obs_fmt):
        runs = []
        for graphed in (True, False):
            before = ops.LAUNCHES
            m, state = training.evaluate(env_cfg, pool, pol, n_steps=40,
                                         n_envs=n_envs, return_state=True,
                                         graphs=graphed)
            assert ops.LAUNCHES - before == 40, (pol.name, graphed)
            runs.append((m, state))
        (mg, sg), (me, se) = runs
        assert mg == me, pol.name
        _assert_same_state(sg, se, pol.name)


def _assert_same_state(a, b, what):
    for k, x in a.items():
        if k in ("gen", "shard"):          # the generator; a shard view
            continue
        if isinstance(x, dict):
            _assert_same_state(x, b[k], (what, k))
        elif x is not None:
            assert torch.equal(x, b[k]), (what, k)


@pytest.mark.cuda
def test_graphed_evaluate_on_injected_draws_on_card(cuda_device):
    """With every draw injected, the graphed loop copies each step's draws
    into its buffers before the replay: the same final state as the eager
    loop on the same draws, and the draws themselves untouched."""
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(6, device=cuda_device)
    steps_n, b = 30, 2
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    state = env_lib.reset(env_cfg, pool, gen, b)
    draws = {"pending0": {k: v.clone() for k, v in state["pending"].items()},
             "clock": torch.cumsum(torch.rand((steps_n, b), generator=gen,
                                              device=cuda_device) * 0.4, 0),
             "pending": {}}
    rows = [env_lib._new_request(env_cfg, pool, gen, b) for _ in range(steps_n)]
    draws["pending"] = {k: torch.stack([r[k] for r in rows])
                        for k in rows[0]}
    kept = {k: v.clone() for k, v in draws["pending0"].items()}
    pol = route.make_policies(env_cfg)[3]                      # QLL
    (mg, sg), (me, se) = (training.evaluate(
        env_cfg, pool, pol, n_steps=steps_n, n_envs=b, draws=draws,
        return_state=True, graphs=g) for g in (True, False))
    assert mg == me
    _assert_same_state(sg, se, "draws")
    for k, v in kept.items():
        assert torch.equal(draws["pending0"][k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_graphed_recurrent_prefill_matches_eager_on_card(cuda_device, arch):
    """Prompts of two shapes through one prefill step: the first call of a
    shape runs eagerly and captures, later calls replay; every replay's
    logits and cache equal the model's eager prefill bit for bit, a
    returned cache survives the next replay, and each call counts its scan
    launches once."""
    overrides = {"window": 16} if arch == "recurrentgemma-2b" else {}
    cfg = reduce_config(get_config(arch), **overrides)
    params = model_lib.init_params(cfg, seed=10, device=cuda_device)
    rng = np.random.default_rng(11)
    prefill = steps.make_prefill_step(cfg, 64)
    per_call = (cfg.n_layers if cfg.family == "ssm" else
                sum(1 for p in params.layers if not hasattr(p, "wq")))
    slot = graphs.COUNTERS.index(("rwkv6_scan" if cfg.family == "ssm"
                                  else "rglru_scan", "LAUNCHES"))
    held = []
    for shape in ((2, 32), (1, 64), (2, 32), (2, 32), (1, 64)):
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, shape),
                               dtype=torch.int32, device=cuda_device)
        before = graphs.launch_counts()
        logits, cache = prefill(params, toks)
        assert graphs.launch_counts()[slot] - before[slot] == per_call
        ref_logits, ref_cache = model_lib.prefill(params, cfg, toks, 64)
        assert torch.equal(logits, ref_logits), shape
        for a, b in zip(_cache_leaves(cache), _cache_leaves(ref_cache)):
            assert torch.equal(a, b), shape
        held.append((cache, steps.clone_cache(cache)))
    assert len(prefill.graphs) == 2
    for cache, copy in held:
        for a, b in zip(_cache_leaves(cache), _cache_leaves(copy)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_recurrent_prefill_drops_the_least_recent_shape(
        cuda_device, monkeypatch):
    """A prefill step that holds one capture: each change of prompt shape
    runs eagerly and captures anew (dropping the other shape's graph in
    their shared pool), a repeat replays, and every call equals the
    model's eager prefill bit for bit."""
    cfg = reduce_config(get_config("rwkv6-7b"))
    params = model_lib.init_params(cfg, seed=14, device=cuda_device)
    rng = np.random.default_rng(15)
    monkeypatch.setattr(steps, "MAX_PREFILL_GRAPHS", 1)
    prefill = steps.make_prefill_step(cfg, 64)
    for shape in ((2, 32), (1, 64), (1, 64), (2, 32), (2, 32), (1, 64)):
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, shape),
                               dtype=torch.int32, device=cuda_device)
        logits, cache = prefill(params, toks)
        assert [k[0] for k in prefill.graphs] == [shape]
        ref_logits, ref_cache = model_lib.prefill(params, cfg, toks, 64)
        assert torch.equal(logits, ref_logits), shape
        for a, b in zip(_cache_leaves(cache), _cache_leaves(ref_cache)):
            assert torch.equal(a, b), shape


# ---------------------------------------------------------------------------
# Router training, scenarios and failover on the card
# ---------------------------------------------------------------------------


def _same_train_state(a, b):
    got = b.tensors()
    for k, x in a.tensors().items():
        assert torch.equal(x, got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("obs_fmt,scenario", [("padded", None),
                                              ("segments", "rolling_outage")])
def test_graphed_training_equals_eager_on_card(cuda_device, obs_fmt,
                                               scenario):
    """Every collect step and update replayed from CUDA graphs against the
    same iterations run eagerly, from the same seeds: parameters, moments,
    buffer, env state and observation bit-equal; B1 once per collect
    step."""
    from repro_torch.core import features, sac
    from repro_torch.env.failover import FailoverConfig
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(6, device=cuda_device, scenario=scenario,
                                   failover=(FailoverConfig(shed_watermark=0.9)
                                             if scenario else None))
    sac_cfg = sac.SACConfig(n_run_edges=features.seg_run_rows(env_cfg)
                            if obs_fmt == "segments" else None)
    tc = training.TrainConfig(n_envs=4, collect_steps=3, updates_per_iter=3,
                              batch_size=32, buffer_capacity=100,
                              warmup_transitions=30, iterations=8,
                              obs_fmt=obs_fmt, seed=3)
    states = []
    for graphed in (True, False):
        st = training.init_train_state(env_cfg, sac_cfg, tc, pool)
        it_fn = training.make_iteration(env_cfg, tc, pool, st,
                                        graphs=graphed)
        before = ops.LAUNCHES
        auxs = [it_fn(i) for i in range(tc.iterations)]
        assert ops.LAUNCHES - before == tc.iterations * tc.collect_steps
        assert (it_fn.update_graph is not None) == graphed
        states.append((st, [{k: float(v) for k, v in a.items()}
                            for a in auxs]))
    (sg, ag), (se, ae) = states
    assert ag == ae
    assert ag[-1]["critic_loss"] != 0.0
    _same_train_state(sg, se)
    assert int(sg.buf["size"]) == 96 and int(sg.buf["ptr"]) == 96


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["QLL", "SQF", "SAC"])
def test_graphed_scenario_failover_routing_equals_eager_on_card(cuda_device,
                                                                policy):
    """A rolling outage with failover and shedding: the routing loop
    replayed from a CUDA graph against eager steps, bit-equal metrics and
    final state (retry buffer included)."""
    import dataclasses

    from repro_torch.core import sac
    from repro_torch.env.failover import FailoverConfig
    from repro_torch.env.workload import WorkloadConfig
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(
        6, device=cuda_device, scenario="rolling_outage",
        failover=FailoverConfig(retry_budget=2, shed_watermark=0.9))
    env_cfg = dataclasses.replace(env_cfg, workload=WorkloadConfig(rate=8.0))
    model = sac.init_params(route.sac_config(env_cfg), seed=1,
                            device=cuda_device)
    pol = next(p for p in route.make_policies(env_cfg, model)
               if p.name == policy)
    runs = []
    for graphed in (True, False):
        before = ops.LAUNCHES
        runs.append(training.evaluate(env_cfg, pool, pol, n_steps=300,
                                      n_envs=4, return_state=True,
                                      graphs=graphed))
        assert ops.LAUNCHES - before == 300
    (mg, sg), (me, se) = runs
    assert mg == me
    _assert_same_state(sg, se, policy)
    if policy != "SAC":             # untrained, the router may drop all
        assert mg["retried"] > 0


@pytest.mark.cuda
def test_kernel_under_live_scenario_channels_matches_plain_on_card(
        cuda_device):
    """The env under a scripted outage, straggler, flash crowd and cap
    claim, with failover and a shed watermark, stepped through B1 and
    through the plain loop from the same seeds: the live ``up``,
    ``k_scale`` (folded into k1/k2) and ``admit_min`` channels and current
    caps give the same state bit for bit."""
    import dataclasses

    from repro_torch import scenarios
    from repro_torch.env.failover import FailoverConfig
    from repro_torch.env.workload import WorkloadConfig

    name = "_card_test_live_channels"
    if name not in scenarios.names():
        scenarios.register(scenarios.ScenarioSpec(
            name=name, horizon=40.0, events=(
                scenarios.FlashCrowd(t0=2.0, t1=10.0, mult=3.0),
                scenarios.ExpertDown(expert=1, t0=4.0, t1=12.0),
                scenarios.CapClaim(expert=0, t0=6.0, t1=30.0, run_cap=1,
                                   wait_cap=1),
                scenarios.Slowdown(expert=4, t0=2.0, t1=25.0, factor=2.5))))
    base = env_lib.EnvConfig(scenario=name,
                             failover=FailoverConfig(shed_watermark=0.6),
                             workload=WorkloadConfig(rate=8.0))
    pool = env_lib.make_env_pool(base, device=cuda_device)
    states = []
    for backend in ("cuda", "torch"):
        cfg = dataclasses.replace(base, engine_backend=backend)
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        st = env_lib.reset(cfg, pool, gen, 4)
        acts = torch.Generator(device=cuda_device).manual_seed(5)
        before = ops.LAUNCHES
        for _ in range(400):
            a = torch.randint(0, 7, (4,), generator=acts, device=cuda_device)
            st, _, _ = env_lib.step(cfg, pool, st, a)
        assert ops.LAUNCHES - before == (400 if backend == "cuda" else 0)
        states.append(st)
    _assert_same_state(states[0], states[1], "stress")
    s = states[0]["stats"]
    assert float(s["shed"].sum()) > 0 and float(s["evicted"].sum()) > 0
    assert float(states[0]["clock"].min()) > 12.0      # past the outage


# ---------------------------------------------------------------------------
# Sharded training and the sharded engine in a world of one NCCL rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_world():
    """A world of one NCCL rank on the card (``launch/mesh.py``), ended
    after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on GPUs only")
    from repro_torch.launch import mesh as mesh_lib

    dev = mesh_lib.init_world("cuda")
    yield dev
    mesh_lib.close_world()


@pytest.mark.cuda
@pytest.mark.parametrize("data", [None, 1], ids=["expert", "data1_expert"])
def test_sharded_training_in_a_world_of_one_equals_unsharded_on_card(
        nccl_world, data):
    """Graphed iterations on ``make_train_mesh(data=...)`` (the insert and
    sample through the shard bodies and their collectives, on ``data=1``
    the envs' gather too, captured in the graphs) against graphed
    unsharded iterations from the same seeds: every tensor and ``aux``
    bit-equal, B1 once per collect step."""
    from repro_torch.core import sac
    from repro_torch.launch import mesh as mesh_lib, route

    env_cfg, pool = route.make_env(6, device=nccl_world)
    tc = training.TrainConfig(n_envs=4, collect_steps=3, updates_per_iter=3,
                              batch_size=32, buffer_capacity=100,
                              warmup_transitions=30, iterations=8, seed=3)
    runs = []
    for mesh in (None, mesh_lib.make_train_mesh(data=data)):
        st = training.init_train_state(env_cfg, sac.SACConfig(), tc, pool,
                                       mesh=mesh)
        it_fn = training.make_iteration(env_cfg, tc, pool, st, mesh=mesh)
        before = ops.LAUNCHES
        auxs = [{k: float(v) for k, v in it_fn(i).items()}
                for i in range(tc.iterations)]
        assert ops.LAUNCHES - before == tc.iterations * tc.collect_steps
        assert it_fn.update_graph is not None
        runs.append((st, auxs))
    (plain, a_plain), (sharded, a_sharded) = runs
    assert a_plain == a_sharded and a_plain[-1]["critic_loss"] != 0.0
    _same_train_state(plain, sharded)


@pytest.mark.cuda
def test_shard_engine_in_a_world_of_one_equals_cuda_on_card(nccl_world):
    """QLL routed through ``engine_backend="shard"`` (B1 on the rank's
    experts, then the all-gather), graphed, against ``"cuda"``: bit-equal
    state and metrics; its first 40 steps against the plain loop as the
    rank's body, eager."""
    import dataclasses

    from repro_torch.launch import route

    env_cfg, pool = route.make_env(6, backend="cuda", device=nccl_world)
    shard = dataclasses.replace(env_cfg, engine_backend="shard")
    loops = {}
    for name, cfg, steps, graphed in (
            ("cuda", env_cfg, 200, True), ("shard", shard, 200, True),
            ("shard40", shard, 40, True),
            ("plain40", dataclasses.replace(shard, shard_body="torch"), 40,
             False)):
        qll = next(p for p in route.make_policies(cfg) if p.name == "QLL")
        loop = training.RoutingLoop(cfg, pool, qll, 4)
        before = ops.LAUNCHES
        loop.run(steps, graphed)
        assert ops.LAUNCHES - before == (0 if name == "plain40" else steps)
        loops[name] = loop
    _assert_same_state(loops["cuda"].state, loops["shard"].state, "shard")
    assert loops["cuda"].metrics() == loops["shard"].metrics()
    _assert_same_state(loops["shard40"].state, loops["plain40"].state,
                       "plain")


# ---------------------------------------------------------------------------
# The LM model mesh in a world of one NCCL rank
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_sharded_at_model_one_matches_local_on_card(nccl_world, dtype):
    """``_moe_sharded`` on a 1 x 1 mesh (every expert, the whole
    capacity, here one that drops) through B4b and B4a against
    ``_moe_local``: the same expert buffers; the combine in float32 and
    rounded once, against the local path's adds in the activation dtype;
    ``aux`` equal; B4b and B4a once each."""
    import types

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe

    cfg = reduce_config(get_config("dbrx-132b"), capacity_factor=0.5)
    gen = torch.Generator(device=nccl_world).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=gen, device=nccl_world)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = types.SimpleNamespace(router=rnd(d, e) / d ** 0.5,
                              w_gate=(rnd(e, d, f) / d ** 0.5).to(dtype),
                              w_up=(rnd(e, d, f) / d ** 0.5).to(dtype),
                              w_down=(rnd(e, f, d) / f ** 0.5).to(dtype))
    x = rnd(96, d).to(dtype)
    mesh = mesh_lib.make_host_mesh(1, 1)
    before = (moe_ops.SWIGLU_LAUNCHES, moe_ops.GEMM_LAUNCHES)
    y, aux = moe._moe_sharded(p, x, cfg, mesh)
    assert (moe_ops.SWIGLU_LAUNCHES, moe_ops.GEMM_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    y_loc, aux_loc = moe._moe_local(p, x, cfg)
    assert y.dtype == dtype and torch.equal(aux, aux_loc)
    scale = float(y_loc.float().abs().max())
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6
    assert float((y.float() - y_loc.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_data_parallel_at_data_one_matches_local_on_card(nccl_world,
                                                             dtype):
    """``_moe_data_parallel`` on a 1 x 1 mesh (the routing counts gathered
    over a data axis of one, a capacity that drops) through B4b and B4a
    against ``_moe_local``: the same expert buffers, so the same output;
    ``aux`` from the probabilities' sum over T against their mean."""
    import types

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe

    cfg = reduce_config(get_config("dbrx-132b"), capacity_factor=0.5)
    gen = torch.Generator(device=nccl_world).manual_seed(6)
    rnd = lambda *s: torch.randn(s, generator=gen, device=nccl_world)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = types.SimpleNamespace(router=rnd(d, e) / d ** 0.5,
                              w_gate=(rnd(e, d, f) / d ** 0.5).to(dtype),
                              w_up=(rnd(e, d, f) / d ** 0.5).to(dtype),
                              w_down=(rnd(e, f, d) / f ** 0.5).to(dtype))
    x = rnd(96, d).to(dtype)
    mesh = mesh_lib.make_host_mesh(1, 1)
    before = (moe_ops.SWIGLU_LAUNCHES, moe_ops.GEMM_LAUNCHES)
    y, aux = moe._moe_data_parallel(p, x, cfg, mesh)
    assert (moe_ops.SWIGLU_LAUNCHES, moe_ops.GEMM_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    y_loc, aux_loc = moe._moe_local(p, x, cfg)
    assert y.dtype == dtype and torch.equal(y, y_loc)
    torch.testing.assert_close(aux, aux_loc, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_lm_mesh_in_a_world_of_one_equals_no_mesh_on_card(nccl_world):
    """Reduced qwen1.5-0.5b, 3 graphed trainer steps on a 1 x 1 mesh
    (``Trainer(mesh=)``: the policy, a ``ShardedLM``, the collectives in
    the graph) against the meshless trainer: every tensor and metric
    bit-equal.  Reduced dbrx-132b's prefill and 3 decode steps under a
    1 x 1 policy against the same steps without one, graphed: bit-equal."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import io as model_io
    from repro_torch.train import checkpoint, trainer as trainer_lib

    mesh = mesh_lib.make_host_mesh(1, 1)
    cfg = reduce_config(get_config("qwen1.5-0.5b"))
    runs = []
    for m in (None, mesh):
        tr = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(total_steps=3),
                                 mesh=m, device=nccl_world,
                                 log_fn=lambda *a: None)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4), mesh=m,
                           device=nccl_world)
        st = tr.init_state(seed=0)
        metrics = []
        for i in range(3):
            st, out = tr._step_fn(st, data.batch(i))
            metrics.append({k: float(v) for k, v in out.items()})
        assert len(tr._step_fn.graphs) == 1
        runs.append((checkpoint._flatten(trainer_lib.tree(st)), metrics))
    (a, ma), (b, mb) = runs
    assert ma == mb and set(a) == set(b)
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], list) else [a[k]],
                        b[k] if isinstance(b[k], list) else [b[k]]):
            assert torch.equal(x, y), k

    cfg = reduce_config(get_config("dbrx-132b"))
    model = model_lib.init_params(cfg, seed=1, device=nccl_world)
    sp = model_io.ShardedLM(model, cfg, mesh, train=False)
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)),
                           dtype=torch.int32, device=nccl_world)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 2)),
                          dtype=torch.int32, device=nccl_world)
    outs = []
    for params, pol in ((model, None), (sp, policy)):
        prefill = steps.make_prefill_step(cfg, 32, pol)
        decode = steps.make_decode_step(cfg, pol)
        prefill(params, toks)
        logits, cache = prefill(params, toks)          # a replay
        got = [logits]
        for t in nxt:
            logits, cache = decode(params, cache, t)
            got.append(logits)
        outs.append(torch.stack(got))
    assert torch.equal(outs[0], outs[1])


# every rank's training bodies' gradients, merged, against the whole
# layer's, each of its largest magnitude (float32, as on the CPU)
RANK_GRAD_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_recurrent_rank_bodies_backward_to_the_whole_layer_on_card(
        cuda_device, arch):
    """Reduced rwkv6-7b's layer and reduced recurrentgemma-2b's superblock
    (6 query heads, 3 a rank) trained on both ranks of a model axis of 2,
    composed in one process (``tests/torch_rank_grads.py``) over 2 x 64
    tokens on the card: the input's gradient and every weight's, merged
    over the ranks, equal the whole layer's."""
    import torch_rank_grads as trg
    from repro_torch.models import rglru, rwkv6

    over = {"n_heads": 6, "window": 16} if arch != "rwkv6-7b" else {}
    cfg = reduce_config(get_config(arch), **over)
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device=cuda_device)
    x = rand(2, 64, cfg.d_model)
    if arch == "rwkv6-7b":
        layer = rwkv6.init_params(cfg, seed=42, device=cuda_device).layers[0]
        c = rand(2, 2, 64, cfg.d_model)
        run = lambda m: trg.rwkv6_layer(layer, cfg, x, m, c)
    else:
        model = rglru.init_params(cfg, seed=43, device=cuda_device)
        c = rand(2, 64, cfg.d_model)
        run = lambda m: trg.rglru_superblock(model, cfg, x, m, c)
    gx_want, want = run(1)
    gx, got = run(2)
    scale = float(gx_want.abs().max())
    assert float((gx - gx_want).abs().max()) <= RANK_GRAD_TOL * scale
    assert trg.worst(got, want) <= RANK_GRAD_TOL


# ---------------------------------------------------------------------------
# The enc-dec family at whisper's head shapes (16 query heads over 16 KV
# heads of 64: G = 1)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(150, 150), (48, 150), (100, 1500)])
def test_flash_attn_kernel_unmasked_at_g1_on_card(cuda_device, sq, skv,
                                                  dtype):
    """B2 without the causal mask at G = 1, dh 64, as the encoder (Sq =
    Skv) and the cross-attention (Sq != Skv) call it, with Skv not a
    multiple of the 64-key tile: against ``attention_ref`` and, in bf16,
    the tile algorithm, through the model's (B, S, H, dh) views."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + skv)
    q = torch.randn((2, sq, 16, 64), generator=gen,
                    device=cuda_device).to(dtype).transpose(1, 2)
    k, v = (torch.randn((2, skv, 16, 64), generator=gen,
                        device=cuda_device).to(dtype).transpose(1, 2)
            for _ in range(2))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attn(q, k, v, causal=False)
    assert fa_ops.LAUNCHES == before + 1 and got.shape == q.shape
    ref = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        tiled = attention_tiled_ref(q, k, v, causal=False).float()
        scale = tiled.abs().clamp(min=1.0)
        assert float(((got.float() - tiled).abs() / scale).max()) \
            <= TILED_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_on_a_padded_cross_cache_at_g1_on_card(
        cuda_device, dtype):
    """B3 at G = 1 (16/16 x 64) over a cross cache of 1,600 slots that
    holds 1,500 encoder positions and large garbage past them, masked by
    ``lengths = enc_len``: the plain version over the 1,500 slots alone,
    within its tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    b, h, dh, s, enc_len = 4, 16, 64, 1600, 1500
    q = torch.randn((b, h, dh), generator=gen, device=cuda_device).to(dtype)
    cache = torch.randn((2, b, s, h, dh), generator=gen,
                        device=cuda_device).to(dtype)
    cache[:, :, enc_len:] = 1e4
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    lengths = torch.full((b,), enc_len, dtype=torch.int32, device=cuda_device)
    got = da_ops.decode_attn(q, k, v, lengths)
    ref = decode_attn_plain(q, k[:, :, :enc_len], v[:, :, :enc_len],
                            lengths)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=FLASH_TOL[dtype])


@pytest.mark.cuda
def test_graphed_encdec_prefill_and_decode_match_eager_on_card(cuda_device):
    """Reduced whisper: ``make_prefill_step`` on ``{"frames"}`` (eager,
    then a replay) equals ``model.prefill`` bit for bit; ten greedy decode
    steps replayed from a graph give bit-equal logits and cache to the
    model's step run eagerly on a copy; a prefill launches B2 once per
    encoder layer, a decode step B3 twice per decoder layer."""
    cfg = reduce_config(get_config("whisper-medium"))
    params = model_lib.init_params(cfg, seed=5, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    frames = torch.randn((2, 40, cfg.d_model), generator=gen,
                         device=cuda_device)
    prefill = steps.make_prefill_step(cfg, 48)
    fa = graphs.COUNTERS.index(("flash_attn", "LAUNCHES"))
    for _ in range(2):
        before = graphs.launch_counts()
        cache = prefill(params, {"frames": frames})
        assert graphs.launch_counts()[fa] - before[fa] == cfg.n_enc_layers
    want = model_lib.prefill(params, cfg, {"frames": frames}, 48)
    for k in want:
        assert torch.equal(cache[k], want[k]), k
    eager = lambda p, c, t: model_lib.decode_step(p, cfg, c, t)
    outs = []
    for decode, c in ((steps.make_decode_step(cfg), cache),
                      (eager, steps.clone_cache(cache))):
        tok = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        seen = []
        before = graphs.launch_counts()
        for _ in range(10):
            logits, c = decode(params, c, tok)
            seen.append(logits)
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        got = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
        assert got == (0, 0, 20 * cfg.n_layers, 0, 0, 0, 0), (decode, got)
        outs.append((torch.stack(seen), c))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k
