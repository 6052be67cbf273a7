"""Edge-expert heterogeneity profiles (port of ``repro/env/profiles.py``).

``make_pool`` draws from the same numpy generator in the same order as the
reference, so the pool is bit-identical.  ``sample_request`` draws from a
``torch.Generator`` and is batched over envs; its numbers differ from
``jax.random``'s, so the tests hold it by distribution or inject draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class ExpertPool:
    """Tensors describing N heterogeneous edge experts (all float32)."""

    n_experts: int
    n_types: int
    quality_mean: torch.Tensor   # (N, T)
    quality_std: torch.Tensor    # (N, T)
    log_len_mean: torch.Tensor   # (N, T)
    log_len_std: torch.Tensor    # (N, T)
    k1: torch.Tensor             # (N,) prefill seconds per prompt token
    k2: torch.Tensor             # (N,) decode seconds per queued token
    mem_capacity: torch.Tensor   # (N,) bytes of KV memory
    mem_per_token: torch.Tensor  # (N,) bytes per resident token
    max_output: int = 300


def make_pool(n_experts: int = 6, n_types: int = 8, seed: int = 0,
              speed_spread: float = 2.5, device=None) -> ExpertPool:
    """Heterogeneous pool: per-expert base quality and task specialization,
    verbose vs terse output lengths, and k1/k2 latency gradients spread by
    compute speed (see the reference for the calibration notes).  On
    ``device``, the CUDA device by default (``repro_torch.device.resolve``)."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    base_q = rng.uniform(0.58, 0.72, size=(n_experts, 1))
    spec = np.zeros((n_experts, n_types))
    for n in range(n_experts):
        strong = rng.choice(n_types, size=max(1, n_types // 3), replace=False)
        spec[n, strong] += rng.uniform(0.12, 0.22)
        weak = rng.choice(n_types, size=max(1, n_types // 4), replace=False)
        spec[n, weak] -= rng.uniform(0.10, 0.20)
    quality = np.clip(base_q + spec + rng.normal(0, 0.01, spec.shape), 0.2, 0.97)

    verbosity = rng.uniform(np.log(60.0), np.log(220.0), size=(n_experts, 1))
    type_len = rng.uniform(-0.35, 0.35, size=(1, n_types))
    log_len_mean = verbosity + type_len
    log_len_std = rng.uniform(0.12, 0.28, size=(n_experts, n_types))

    speed = np.exp(rng.uniform(0.0, np.log(speed_spread), size=n_experts))
    k1 = 0.00025 / speed
    k2 = 0.000032 / speed
    mem_capacity = rng.uniform(1.0e9, 2.0e9, size=n_experts)
    mem_per_token = np.full(n_experts, 0.8e6) * rng.uniform(0.8, 1.2, n_experts)

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ExpertPool(
        n_experts=n_experts, n_types=n_types,
        quality_mean=f32(quality),
        quality_std=f32(np.full_like(quality, 0.05)),
        log_len_mean=f32(log_len_mean),
        log_len_std=f32(log_len_std),
        k1=f32(k1), k2=f32(k2),
        mem_capacity=f32(mem_capacity),
        mem_per_token=f32(mem_per_token),
    )


def memory_caps(pool: ExpertPool, run_cap: int, wait_cap: int,
                *, min_cap: int = 1):
    """Ragged per-expert queue capacities from the pool's memory spread:
    ``ceil(width * mem / max_mem)`` floored at ``min_cap``; the
    largest-memory expert keeps the packed widths.  Returns (run_caps,
    wait_caps) as (N,) numpy int32 (static shape data)."""
    mem = pool.mem_capacity.detach().cpu().numpy().astype(np.float64)
    frac = mem / mem.max()
    rc = np.clip(np.ceil(frac * run_cap), min_cap, run_cap).astype(np.int32)
    wc = np.clip(np.ceil(frac * wait_cap), min_cap, wait_cap).astype(np.int32)
    return rc, wc


def sample_request(pool: ExpertPool, gen: torch.Generator, batch: int) -> dict:
    """Draw one request per env: latent type (B,), prompt length (B,), and
    per-expert ground-truth score / output length (B, N)."""
    dev = pool.k1.device
    n = pool.n_experts
    ttype = torch.randint(0, pool.n_types, (batch,), generator=gen, device=dev)
    z = torch.randn((batch,), generator=gen, device=dev)
    p_len = torch.clamp(torch.exp(z * 0.7 + 4.5), 16.0, 512.0).to(torch.int32)
    qm = pool.quality_mean.t()[ttype]                      # (B, N)
    qs = pool.quality_std.t()[ttype]
    q = qm + qs * torch.randn((batch, n), generator=gen, device=dev)
    score = torch.clamp(q, 0.0, 1.0)
    ln = pool.log_len_mean.t()[ttype] + pool.log_len_std.t()[ttype] * \
        torch.randn((batch, n), generator=gen, device=dev)
    out_len = torch.clamp(torch.exp(ln), 8.0,
                          float(pool.max_output)).to(torch.int32)
    return {"type": ttype.to(torch.int32), "p_len": p_len, "score": score,
            "out_len": out_len}
