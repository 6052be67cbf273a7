"""Policy evaluation (port of ``repro/core/training.py``'s ``evaluate``).

The reference runs ``evaluate`` as ``jax.jit(jax.vmap(run_one))`` over a
``lax.scan`` of routing steps.  On CUDA the port runs each routing step as
one CUDA graph (``RoutingLoop``): the env state, the policy state and the
reward sum live in static tensors that a step updates in place, the first
step runs eagerly (it makes what a capture cannot: constants copied from
the host, loaded libraries) and is then captured, and every later step
replays the capture.  The env's and the policy's generators are registered
with the graph, so a replay draws what the eager step would.  On the CPU,
and with ``graphs=False`` on CUDA, the same steps run eagerly; both give
the same metrics and final state bit for bit.

Router training (replay, AdamW, the SAC losses and the collect/update
iteration) comes with the training slice.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core import features
from repro_torch.device import generator
from repro_torch.env import env as env_lib
from repro_torch.graphs import StepGraph

# entries of an env state that a step never replaces
_FIXED = ("gen", "par", "wait_caps")


def _own(tree):
    """A copy of every tensor of a state tree but the fixed entries, so
    the copy's tensors are the loop's alone to update in place."""
    return {k: (x if k in _FIXED or x is None else
                _own(x) if isinstance(x, dict) else x.clone())
            for k, x in tree.items()}


def _copy_(dst: dict, src: dict) -> None:
    """``src`` into ``dst``'s tensors, in place (the fixed entries and
    tensors a step returned unchanged are skipped)."""
    for k, d in dst.items():
        if k in _FIXED:
            continue
        s = src[k]
        if isinstance(d, dict):
            _copy_(d, s)
        elif d is not s:
            d.copy_(s)


class RoutingLoop:
    """``n_envs`` envs routed by ``policy`` over static tensors: ``state``
    (the env state), ``pstate`` (the policy's) and ``rew_sum`` keep their
    storage, and ``step`` updates them in place.  ``run(n, graphs=True)``
    on CUDA runs the first step eagerly, captures ``step`` as a CUDA graph
    and replays it; otherwise every step runs eagerly.

    ``draws`` injects every random draw of the envs, as ``evaluate`` takes
    it; each step's draws are copied into static buffers before the step.
    """

    def __init__(self, env_cfg: env_lib.EnvConfig, pool, policy,
                 n_envs: int, seed: int = 1234, *,
                 draws: Optional[dict] = None):
        dev = pool.k1.device
        self.cfg, self.pool, self.policy = env_cfg, pool, policy
        self.env_gen = generator(dev, seed)
        self.act_gen = generator(dev, seed + 1)
        state = env_lib.reset(env_cfg, pool, self.env_gen, n_envs,
                              pending=None if draws is None
                              else draws["pending0"])
        self.state = _own(state)
        self.pstate = _own(policy.init_state(n_envs, dev))
        self.rew_sum = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
        self.draws = draws
        self.draw_buf = None if draws is None else {
            "clock": torch.empty_like(draws["clock"][0], device=dev),
            "pending": {k: torch.empty_like(v[0], device=dev)
                        for k, v in draws["pending"].items()}}
        self.steps = 0
        self.graph: Optional[StepGraph] = None

    # the step's three layers, each over the static tensors
    def observe(self):
        if self.policy.obs_fmt is None:
            return None
        return features.build_obs(self.cfg, self.pool, self.state,
                                  fmt=self.policy.obs_fmt)

    def act(self, obs) -> torch.Tensor:
        a, pstate = self.policy.act(self.pstate, self.state, obs, self.act_gen)
        _copy_(self.pstate, pstate)
        return a

    def apply(self, action: torch.Tensor) -> None:
        state, r, _ = env_lib.step(self.cfg, self.pool, self.state, action,
                                   draws=self.draw_buf)
        _copy_(self.state, state)
        self.rew_sum.add_(r)

    def step(self) -> None:
        self.apply(self.act(self.observe()))

    def capture(self) -> StepGraph:
        """``step`` as a CUDA graph (once)."""
        if self.graph is None:
            self.graph = StepGraph(self.step,
                                   generators=(self.env_gen, self.act_gen))
        return self.graph

    def run(self, n_steps: int, graphs: bool = True) -> None:
        capture = graphs and self.rew_sum.is_cuda
        for _ in range(n_steps):
            if self.draws is not None:
                self.draw_buf["clock"].copy_(self.draws["clock"][self.steps])
                for k, buf in self.draw_buf["pending"].items():
                    buf.copy_(self.draws["pending"][k][self.steps])
            if capture and self.graph is not None:
                self.graph.replay()
            else:
                self.step()
                if capture:
                    self.capture()
            self.steps += 1

    def metrics(self) -> dict:
        out = {k: float(v.mean())
               for k, v in env_lib.episode_metrics(self.state).items()}
        out["mean_reward"] = float((self.rew_sum / self.steps).mean())
        return out


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def evaluate(env_cfg: env_lib.EnvConfig, pool, policy, n_steps: int = 5000,
             seed: int = 1234, n_envs: int = 4, *,
             draws: Optional[dict] = None, return_state: bool = False,
             graphs: bool = True, timing: Optional[dict] = None):
    """Run ``policy`` on ``n_envs`` envs for ``n_steps`` routing decisions
    each, on the pool's device; returns the paper metrics averaged over
    envs, as floats (and the final env state with ``return_state``).

    ``draws`` injects every random draw of the envs: ``{"pending0": first
    pending request, "clock": (n_steps, B) arrival times, "pending": each
    field stacked (n_steps, B, ...)}``.  Without it the envs draw from a
    generator seeded with ``seed``; the policy's own draws use a second
    one.  A policy with ``obs_fmt=None`` gets no observation.

    On CUDA every step after the first is a CUDA graph replay
    (``RoutingLoop``); with ``graphs=False``, and on the CPU, every step
    runs eagerly.  ``timing``, a dict, receives the synchronised seconds of
    the first step (with the capture, when graphed) as ``first_s`` and of
    the rest as ``rest_s``."""
    if n_steps < 1:
        raise ValueError("n_steps must be at least 1")
    dev = pool.k1.device
    t0 = _sync(dev)
    loop = RoutingLoop(env_cfg, pool, policy, n_envs, seed, draws=draws)
    loop.run(1, graphs)
    t1 = _sync(dev)
    loop.run(n_steps - 1, graphs)
    if timing is not None:
        timing["first_s"] = t1 - t0
        timing["rest_s"] = _sync(dev) - t1
    out = loop.metrics()
    return (out, loop.state) if return_state else out
