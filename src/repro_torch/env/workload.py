"""Request arrival processes (port of ``repro/env/workload.py``), batched
over envs and drawn from a ``torch.Generator``.

* ``poisson``   — exponential inter-arrivals at rate λ.
* ``realworld`` — BurstGPT-like: diurnal modulation times a two-state
  (calm/burst) Markov intensity, normalized so the long-run rate is ~λ.

Both take an optional ``rate_mult (B,)``: a scenario's workload
multiplier at each env's clock (``scenarios.at_time``), applied on top
of the process's own rate.  ``None`` skips the multiply.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    kind: str = "poisson"       # poisson | realworld
    rate: float = 5.0           # λ requests / s
    diurnal_period: float = 600.0
    diurnal_amp: float = 0.5
    burst_rate_mult: float = 4.0
    burst_on_prob: float = 0.02   # per arrival: calm -> burst
    burst_off_prob: float = 0.25  # per arrival: burst -> calm


def init_state(batch: int, device=None) -> dict:
    """Calm workload state for ``batch`` envs on ``device`` (the CUDA device
    by default)."""
    return {"burst": torch.zeros((batch,), dtype=torch.bool,
                                 device=resolve(device))}


def current_rate(cfg: WorkloadConfig, state: dict, t: torch.Tensor,
                 rate_mult=None) -> torch.Tensor:
    """(B,) instantaneous arrival rate at clocks ``t (B,)``."""
    if cfg.kind == "poisson":
        rate = torch.full_like(t, cfg.rate, dtype=torch.float32)
        return rate if rate_mult is None else rate * rate_mult
    diurnal = 1.0 + cfg.diurnal_amp * torch.sin(
        2.0 * math.pi * t / cfg.diurnal_period)
    burst = torch.where(state["burst"], cfg.burst_rate_mult, 1.0)
    # the chain flips per arrival, so normalize by the TIME-weighted rate
    # multiplier (burst arrivals occupy 1/mult as much wall-clock)
    p_on = cfg.burst_on_prob / (cfg.burst_on_prob + cfg.burst_off_prob)
    t_burst = p_on / cfg.burst_rate_mult
    time_frac = t_burst / (t_burst + (1.0 - p_on))
    norm = 1.0 + time_frac * (cfg.burst_rate_mult - 1.0)
    rate = cfg.rate * diurnal * burst / norm
    return rate if rate_mult is None else rate * rate_mult


def next_arrival(cfg: WorkloadConfig, state: dict, t: torch.Tensor,
                 gen: torch.Generator, rate_mult=None,
                 rows: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Returns (dt (B,) to the next arrival, new workload state).  With
    ``rows=(lo, n)`` the B envs are ``lo .. lo + B`` of ``n``: each draw is
    made for all ``n`` and cut to them."""
    rate = torch.clamp(current_rate(cfg, state, t, rate_mult), min=1e-3)
    b = rate.shape[0]
    n, lo = (b, 0) if rows is None else (rows[1], rows[0])
    draw = torch.empty((n,), dtype=rate.dtype, device=rate.device)
    dt = draw.exponential_(generator=gen)[lo:lo + b] / rate
    if cfg.kind == "poisson":
        return dt, state
    u = torch.rand((n,), generator=gen, device=rate.device)[lo:lo + b]
    burst = state["burst"]
    flip_on = ~burst & (u < cfg.burst_on_prob)
    flip_off = burst & (u < cfg.burst_off_prob)
    return dt, {"burst": (burst | flip_on) & ~flip_off}
