"""AdamW with float32 moments (port of the AdamW half of
``repro/train/optimizer.py``), updating parameters in place.

``lr_schedule`` is linear warmup then cosine decay to a floor of 0.1 of
the peak; gradients are clipped by their global norm; weight decay
applies to parameters of two or more dimensions only.  The step count is
a device tensor (``AdamW.step``) that the learning rate and the bias
corrections read on the device, so a CUDA graph of an update uses the
step it holds at each replay.  Adafactor, the LM trainer's optimizer, is
not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(prog, 0.0, 1.0)))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm,
                                     0.1 + 0.9 * cos)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    sq = [torch.square(x.to(torch.float32)).sum() for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float):
    """(tensors scaled by ``min(1, max_norm / norm)``, norm)."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(x.to(torch.float32) * scale).to(x.dtype) for x in tensors], norm


class AdamW:
    """AdamW over ``params`` (name -> parameter), moments ``m``/``v`` by
    the same names in float32, ``step`` an int32 device scalar."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: OptimizerConfig):
        self.cfg = cfg
        self.params = dict(params)
        dev = next(iter(self.params.values())).device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=dev)
        self.m = {k: zeros(p) for k, p in self.params.items()}
        self.v = {k: zeros(p) for k, p in self.params.items()}
        self.step = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> dict:
        """One step with ``grads`` in the order of ``params``, in place;
        returns ``{"grad_norm", "lr"}`` (device scalars)."""
        cfg = self.cfg
        grads, gnorm = clip_by_global_norm(list(grads), cfg.grad_clip)
        lr = lr_schedule(cfg, self.step)
        t = (self.step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        for (k, p), g in zip(self.params.items(), grads):
            g = g.to(torch.float32)
            m, v = self.m[k], self.v[k]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if p.dim() >= 2:                       # decay matrices only
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return {"grad_norm": gnorm, "lr": lr}
