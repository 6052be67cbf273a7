"""Scenario runtime (port of ``repro/scenarios/runtime.py``), batched over
the leading env axis.

``at_time`` turns each env's clock into its current conditions with one
clipped gather per table; ``evict_beyond_cap`` enforces a cap shrink on
the packed queues (the engine only masks against the current caps; this
is the one place a scenario changes queue state, at the step boundary).

``compiled`` and ``for_cfg`` cache the tables per (scenario, queue
geometry, device): every step, and every CUDA graph that replays one,
reads the same tensors, which keep their storage for the process's life.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.env.engine_layout import (RI_VALID, WI_VALID, run_valid,
                                           slot_valid, wait_valid)
from repro_torch.scenarios import spec as spec_lib
from repro_torch.scenarios.compile import ScenarioTensors, compile_spec


def at_time(st: ScenarioTensors, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Conditions at clocks ``t (B,)``: ``rate_mult (B,)``, ``up``,
    ``run_cap``, ``wait_cap`` and ``k_scale`` each (B, N).  Past the
    horizon the last bucket holds."""
    idx = torch.clamp((t / st.dt[0]).to(torch.int32), 0,
                      st.rate_mult.shape[0] - 1).long()
    return {"rate_mult": st.rate_mult[idx], "up": st.up[idx],
            "run_cap": st.run_cap[idx], "wait_cap": st.wait_cap[idx],
            "k_scale": st.k_scale[idx]}


def evict_beyond_cap(queues: dict, run_cap: torch.Tensor,
                     wait_cap: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """Invalidate every live slot at or beyond the current caps ((B, N)
    or (N,)); returns ``(queues, n_evicted (B,) float32)``.  With caps at
    the packed widths the queue values come back unchanged."""
    run_ok = slot_valid(run_cap, queues["run_i"].shape[-2])
    wait_ok = slot_valid(wait_cap, queues["wait_i"].shape[-2])
    rv, wv = run_valid(queues), wait_valid(queues)
    evicted = ((rv & ~run_ok).to(torch.float32).sum((-1, -2))
               + (wv & ~wait_ok).to(torch.float32).sum((-1, -2)))
    run_i, wait_i = queues["run_i"].clone(), queues["wait_i"].clone()
    run_i[..., RI_VALID] = (rv & run_ok).to(torch.int32)
    wait_i[..., WI_VALID] = (wv & wait_ok).to(torch.int32)
    return {**queues, "run_i": run_i, "wait_i": wait_i}, evicted


@functools.lru_cache(maxsize=None)
def _compiled(name, n_experts, run_width, wait_width, base_run_caps,
              base_wait_caps, device: str) -> ScenarioTensors:
    return compile_spec(spec_lib.get(name), n_experts, run_width,
                        wait_width, base_run_caps, base_wait_caps,
                        device=device)


def compiled(name: str, n_experts: int, run_width: int, wait_width: int,
             base_run_caps: Optional[Tuple[int, ...]] = None,
             base_wait_caps: Optional[Tuple[int, ...]] = None,
             device=None) -> ScenarioTensors:
    """Registry lookup and compile, cached on the whole key (the CUDA
    device by default)."""
    dev = str(torch.device("cuda" if device is None else device))
    return _compiled(name, n_experts, run_width, wait_width,
                     None if base_run_caps is None else tuple(base_run_caps),
                     None if base_wait_caps is None
                     else tuple(base_wait_caps), dev)


def for_cfg(cfg, device=None) -> Optional[ScenarioTensors]:
    """The tables for an ``EnvConfig``-shaped config on ``device``, or None
    when it scripts no scenario.  An unknown name raises ``KeyError``."""
    name = getattr(cfg, "scenario", None)
    if not name:
        return None
    return compiled(name, cfg.n_experts, cfg.run_cap, cfg.wait_cap,
                    getattr(cfg, "run_caps", None),
                    getattr(cfg, "wait_caps", None), device=device)


def availability(cfg, t: torch.Tensor) -> Optional[torch.Tensor]:
    """The (B, N) up mask at clocks ``t (B,)``, or None without a
    scenario."""
    st = for_cfg(cfg, t.device)
    if st is None:
        return None
    return at_time(st, t)["up"]
