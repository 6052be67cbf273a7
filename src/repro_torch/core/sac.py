"""Discrete Soft Actor-Critic with the HAN in front (port of
``repro/core/sac.py``): the parameter tree, ``embed``, ``actor_logits``,
``act`` (greedy, or sampled by Gumbel-max as ``jax.random.categorical``
samples), and the training half: ``losses`` (twin critics against a
target with the gradient stopped, actor, temperature), ``polyak`` and
``trainable``.

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


def gumbel(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1),
    as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def act(sac: SAC, obs: dict, gen: Optional[torch.Generator] = None, *,
        greedy: bool = False, noise: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """(B,) int64 actions: the argmax of the actor's logits, or a sample
    from their softmax by Gumbel-max, ``argmax(logits + g)`` with ``g``
    drawn from ``gen`` (or given as ``noise``, shaped like the logits).
    A draw on the device with no host sync: a CUDA graph replays it."""
    logits = actor_logits(sac, obs)
    if greedy:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        noise = gumbel(logits.shape, gen, logits.device)
    return torch.argmax(logits + noise, dim=-1)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TARGET_KEYS = ("q1_target", "q2_target", "han_critic_target")
AUX_KEYS = ("critic_loss", "actor_loss", "alpha", "entropy", "q_mean")


def _q_values(sac: SAC, obs: dict, *, target: bool):
    cfg = sac.cfg
    which = "han_critic_target" if target else "han_critic"
    z = embed(sac, obs, which=which if cfg.use_han else "actor")
    q1 = (sac.q1_target if target else sac.q1)(z)
    q2 = (sac.q2_target if target else sac.q2)(z)
    return q1, q2


def losses(sac: SAC, batch: dict):
    """(total loss, aux) on ``batch`` (obs, action (B,), reward (B,),
    next_obs, discount (B,)).  The critic target is computed without a
    gradient; ``aux`` holds ``AUX_KEYS``, detached."""
    cfg = sac.cfg
    alpha = torch.exp(sac.log_alpha)
    target_entropy = cfg.entropy_target_frac * math.log(float(cfg.n_actions))

    with torch.no_grad():
        next_logits = actor_logits(sac, batch["next_obs"])
        next_pi = torch.softmax(next_logits, dim=-1)
        next_logpi = torch.log_softmax(next_logits, dim=-1)
        q1_t, q2_t = _q_values(sac, batch["next_obs"], target=True)
        v_next = (next_pi * (torch.minimum(q1_t, q2_t)
                             - alpha * next_logpi)).sum(-1)
        y = batch["reward"] + cfg.gamma * batch["discount"] * v_next

    q1, q2 = _q_values(sac, batch["obs"], target=False)
    a = batch["action"].long()[:, None]
    q1_a = q1.gather(1, a)[:, 0]
    q2_a = q2.gather(1, a)[:, 0]
    critic_loss = (torch.square(q1_a - y) + torch.square(q2_a - y)).mean()

    logits = actor_logits(sac, batch["obs"])
    pi = torch.softmax(logits, dim=-1)
    logpi = torch.log_softmax(logits, dim=-1)
    q_min = torch.minimum(q1, q2).detach()
    actor_loss = (pi * (alpha.detach() * logpi - q_min)).sum(-1).mean()

    entropy = -(pi * logpi).sum(-1)
    alpha_loss = sac.log_alpha * (entropy - target_entropy).detach().mean()

    total = critic_loss + actor_loss + alpha_loss
    aux = {"critic_loss": critic_loss.detach(),
           "actor_loss": actor_loss.detach(), "alpha": alpha.detach(),
           "entropy": entropy.detach().mean(), "q_mean": q_min.mean()}
    return total, aux


def grads(loss: torch.Tensor, params) -> list:
    """d loss / d params, zeros for parameters the loss does not reach
    (the last HAN layer's request and expert updates), as the reference's
    ``value_and_grad`` gives them."""
    out = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, out)]


def trainable(sac: SAC) -> dict:
    """The trained parameters by ``state_dict`` name: all but the target
    critics, which ``polyak`` moves."""
    return {k: p for k, p in sac.named_parameters()
            if k.split(".")[0] not in TARGET_KEYS}


@torch.no_grad()
def polyak(sac: SAC) -> None:
    """Move each target critic toward its critic by ``tau``, in place."""
    pairs = [(sac.q1_target, sac.q1), (sac.q2_target, sac.q2)]
    if sac.cfg.use_han:
        pairs.append((sac.han_critic_target, sac.han_critic))
    for tgt, src in pairs:
        for t, s in zip(tgt.parameters(), src.parameters()):
            t.lerp_(s, sac.cfg.tau)
