"""Policy evaluation (port of ``repro/core/training.py``'s ``evaluate``).

Router training (replay, AdamW, the SAC losses and the collect/update
iteration) comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import features
from repro_torch.device import generator
from repro_torch.env import env as env_lib


@torch.no_grad()
def evaluate(env_cfg: env_lib.EnvConfig, pool, policy, n_steps: int = 5000,
             seed: int = 1234, n_envs: int = 4, *,
             draws: Optional[dict] = None, return_state: bool = False):
    """Run ``policy`` on ``n_envs`` envs for ``n_steps`` routing decisions
    each, on the pool's device; returns the paper metrics averaged over
    envs, as floats (and the final env state with ``return_state``).

    ``draws`` injects every random draw of the envs: ``{"pending0": first
    pending request, "clock": (n_steps, B) arrival times, "pending": each
    field stacked (n_steps, B, ...)}``.  Without it the envs draw from a
    generator seeded with ``seed``; the policy's own draws use a second
    one.  A policy with ``obs_fmt=None`` gets no observation."""
    dev = pool.k1.device
    env_gen = generator(dev, seed)
    act_gen = generator(dev, seed + 1)
    state = env_lib.reset(env_cfg, pool, env_gen, n_envs,
                          pending=None if draws is None else draws["pending0"])
    pstate = policy.init_state(n_envs, dev)
    rew_sum = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
    for i in range(n_steps):
        obs = (None if policy.obs_fmt is None else
               features.build_obs(env_cfg, pool, state, fmt=policy.obs_fmt))
        a, pstate = policy.act(pstate, state, obs, act_gen)
        step_draws = None if draws is None else {
            "clock": draws["clock"][i],
            "pending": {k: v[i] for k, v in draws["pending"].items()}}
        state, r, _ = env_lib.step(env_cfg, pool, state, a, draws=step_draws)
        rew_sum += r
    metrics = env_lib.episode_metrics(state)
    out = {k: float(v.mean()) for k, v in metrics.items()}
    out["mean_reward"] = float((rew_sum / n_steps).mean())
    return (out, state) if return_state else out
