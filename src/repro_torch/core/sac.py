"""Discrete Soft Actor-Critic with the HAN in front (port of the serving half
of ``repro/core/sac.py``): the parameter tree, ``embed``,
``actor_logits`` and ``act``.  ``losses``/``polyak`` come with the training
slice.

The actor and twin critics are 2-layer MLPs on the arrived-request
embedding.  ``SAC`` holds the reference's whole parameter tree (actor,
critics, their targets, both HANs, ``log_alpha``) so a checkpoint carries
over whole; serving reads only ``han`` and ``actor``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.han import HAN, HANConfig
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class SACConfig:
    n_actions: int = 7            # N experts + drop
    hidden: int = 64
    gamma: float = 0.97
    tau: float = 0.005
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    entropy_target_frac: float = 0.35
    init_alpha: float = 0.2
    use_han: bool = True          # False -> Baseline RL (flat expert feats)
    flat_dim: int = 18            # N * 3 expert-level features
    han: HANConfig = HANConfig()
    # run-edge rows at the head of segment-layout obs["req"]
    # (features.seg_run_rows(env_cfg)); needed for obs_fmt="segments"
    n_run_edges: Optional[int] = None
    run_caps: Optional[Tuple[int, ...]] = None
    wait_caps: Optional[Tuple[int, ...]] = None


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, gen: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch.randn((d_in, d_out), generator=gen)
                              * math.sqrt(2.0 / d_in))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense layers with ReLU between them (``x @ w + b``, weights (in, out))."""

    def __init__(self, dims, gen: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(Dense(a, b, gen)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lyr in enumerate(self.layers):
            x = lyr(x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x


class SAC(nn.Module):
    def __init__(self, cfg: SACConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.han.hidden if cfg.use_han else cfg.flat_dim
        dims = (d_in, cfg.hidden, cfg.n_actions)
        self.actor = MLP(dims, gen)
        self.q1 = MLP(dims, gen)
        self.q2 = MLP(dims, gen)
        self.log_alpha = nn.Parameter(
            torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32))
        if cfg.use_han:
            self.han = HAN(cfg.han, gen)
            self.han_critic = HAN(cfg.han, gen)
        self.q1_target = MLP(dims, gen)
        self.q2_target = MLP(dims, gen)
        self.q1_target.load_state_dict(self.q1.state_dict())
        self.q2_target.load_state_dict(self.q2.state_dict())
        if cfg.use_han:
            self.han_critic_target = HAN(cfg.han, gen)
            self.han_critic_target.load_state_dict(
                self.han_critic.state_dict())


def init_params(cfg: SACConfig, seed: int = 0, device=None) -> SAC:
    """Fresh parameters drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (so the weights do not depend on the device), then moved to
    ``device`` (the CUDA device by default)."""
    gen = torch.Generator().manual_seed(int(seed))
    return SAC(cfg, gen).to(resolve(device))


def embed(sac: SAC, obs: dict, *, which: str = "actor") -> torch.Tensor:
    """Batched obs -> (B, D) state embedding; dispatches on the obs layout
    (padded ``run``/``wait`` vs segments ``req``)."""
    cfg = sac.cfg
    if not cfg.use_han:
        return obs["expert"][..., :3].reshape(obs["expert"].shape[0], -1)
    han = sac.han if which == "actor" else getattr(sac, which)
    if "req" in obs:
        if cfg.n_run_edges is None:
            raise ValueError("segment-layout obs need SACConfig.n_run_edges "
                             "(= features.seg_run_rows(env_cfg))")
        return han.forward_segments(obs, n_run=cfg.n_run_edges,
                                    run_caps=cfg.run_caps,
                                    wait_caps=cfg.wait_caps)[0]
    return han(obs)[0]


def actor_logits(sac: SAC, obs: dict) -> torch.Tensor:
    return sac.actor(embed(sac, obs, which="actor"))


@torch.no_grad()
def act(sac: SAC, obs: dict, gen: Optional[torch.Generator] = None, *,
        greedy: bool = False) -> torch.Tensor:
    """(B,) int64 actions: the argmax of the actor's logits, or a sample
    from their softmax drawn with ``gen``."""
    logits = actor_logits(sac, obs)
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
