"""Routing policies (port of ``repro/core/routers.py``), batched over envs:
the paper's baselines and the QoS-aware SAC router.

* BERT Router (BR)     — argmax of the predicted generation score.
* Round-Robin (RR)     — cyclic assignment.
* Shortest Queue (SQF) — argmin(|running| + |waiting|).
* QLL                  — best predicted score among experts within ``slack``
                         of the least-loaded one.
* SAC                  — the HAN + actor router.

A policy is ``act(pstate, env_state, obs, gen) -> (actions (B,), pstate)``.
Its ``obs_fmt`` names the observation layout it reads; the heuristics
read the env state alone (``obs_fmt=None``), so no observation is built
for them and ``obs`` is None.
The reference's scenario- and failover-aware branches are not ported yet:
passing an ``env_cfg`` that scripts either raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import sac as sac_lib
from repro_torch.device import constant
from repro_torch.env import engine_layout as layout


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    init_state: Callable   # (batch, device) -> policy state
    act: Callable          # (pstate, env_state, obs, gen) -> (actions, pstate)
    obs_fmt: Optional[str] = None   # None: the policy reads no observation


def _check_env_cfg(env_cfg) -> None:
    if env_cfg is None:
        return
    if getattr(env_cfg, "scenario", None) is not None:
        raise NotImplementedError("scenario-aware routing is not ported yet")
    if getattr(env_cfg, "failover", None) is not None:
        raise NotImplementedError("failover-aware routing is not ported yet")


def _no_state(batch, device):
    return {}


def round_robin(n_experts: int) -> Policy:
    def init_state(batch, device):
        return {"i": torch.zeros((batch,), dtype=torch.int64, device=device)}

    def act(pstate, env_state, obs, gen):
        return (pstate["i"] % n_experts) + 1, {"i": pstate["i"] + 1}

    return Policy("RR", init_state, act)


def _total_caps(caps):
    """Per-expert total slots (a tuple) from (run_caps, wait_caps), or None."""
    if caps is None:
        return None
    return tuple(float(r) + float(w) for r, w in zip(*caps))


def _queue_load(env_state, total):
    """(B, N) load: queue length (uniform fleet) or occupancy |Q|/cap
    (ragged fleet, so a full 1-slot expert reads as loaded)."""
    q = env_state["queues"]
    qlen = layout.run_valid(q).sum(-1) + layout.wait_valid(q).sum(-1)
    if total is None:
        return qlen
    return qlen.to(torch.float32) / constant(total, torch.float32, qlen.device)


def shortest_queue(n_experts: int, caps=None, env_cfg=None) -> Policy:
    """Least-loaded routing; ``caps=(run_caps, wait_caps)`` switches the
    load signal to per-expert occupancy on ragged fleets."""
    _check_env_cfg(env_cfg)
    total = _total_caps(caps)

    def act(pstate, env_state, obs, gen):
        return torch.argmin(_queue_load(env_state, total), dim=-1) + 1, pstate

    return Policy("SQF", _no_state, act)


def bert_router() -> Policy:
    """Greedy predicted-score routing (the paper's BR baseline)."""
    def act(pstate, env_state, obs, gen):
        return torch.argmax(env_state["pending"]["pred_s"], dim=-1) + 1, pstate

    return Policy("BR", _no_state, act)


def quality_least_loaded(slack: int = 2, caps=None, env_cfg=None) -> Policy:
    """QLL: among experts whose load is within ``slack`` of the minimum,
    the best predicted score.  With ``caps`` the load is occupancy, the
    slack is ``slack`` slots of each expert's own capacity, and an expert
    whose in-cap wait queue is full is never eligible; with no eligible
    expert the policy drops (action 0)."""
    _check_env_cfg(env_cfg)
    total = _total_caps(caps)
    wait_caps = None if caps is None else tuple(int(w) for w in caps[1])

    def act(pstate, env_state, obs, gen):
        load = _queue_load(env_state, total)
        lo = load.min(-1, keepdim=True).values
        if caps is None:
            ok = load <= lo + slack
        else:
            dev = load.device
            wlen = layout.wait_valid(env_state["queues"]).sum(-1)
            ok = ((load <= lo + slack / constant(total, torch.float32, dev))
                  & (wlen < constant(wait_caps, torch.int64, dev)))
        pred = env_state["pending"]["pred_s"]
        a = torch.argmax(torch.where(ok, pred, -1.0), dim=-1) + 1
        return torch.where(ok.any(-1), a, 0), pstate

    return Policy("QLL", _no_state, act)


def sac_policy(name: str, sac: sac_lib.SAC, *, greedy: bool = True,
               obs_fmt: str = "padded") -> Policy:
    def act(pstate, env_state, obs, gen):
        return sac_lib.act(sac, obs, gen, greedy=greedy), pstate

    return Policy(name, _no_state, act, obs_fmt=obs_fmt)
