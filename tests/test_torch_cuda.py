"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports neither ``jax`` nor the reference package, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.env import engine, engine_layout as layout, env as env_lib
from repro_torch.env import profiles
from repro_torch.kernels.lockstep_advance import ops

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
