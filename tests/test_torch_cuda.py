"""The port's CUDA kernels (B1 lockstep advance, B2 flash attention) against
their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither ``jax`` nor the reference package, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.env import engine, engine_layout as layout, env as env_lib
from repro_torch.env import profiles
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lockstep_advance import ops
from repro_torch.models import transformer

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
# danube 32/8/120 with a window, starcoder2 48/4/128), at serving buckets
# and ragged lengths (S < 32, S not a multiple of 32), and the reduced
# configs' small heads
FLASH_SHAPES = [(16, 16, 64, 16, 0), (32, 8, 120, 40, 0), (48, 4, 128, 128, 0),
                (32, 8, 120, 200, 64), (8, 2, 24, 7, 0), (4, 4, 16, 70, 8),
                (48, 4, 128, 1, 0)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
