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

Given an ``env_cfg`` that scripts a scenario, SQF and QLL route around
down experts (and QLL around experts whose current wait caps are full);
given one whose failover arms a shed watermark, both drop a request that
the env would shed anyway (``_overload_drop``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import scenarios
from repro_torch.core import sac as sac_lib
from repro_torch.device import constant
from repro_torch.env import env as env_lib


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    init_state: Callable   # (batch, device) -> policy state
    act: Callable          # (pstate, env_state, obs, gen) -> (actions, pstate)
    obs_fmt: Optional[str] = None   # None: the policy reads no observation


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
    run, wait = env_lib.queue_counts(env_state, "router load")
    return _load(run + wait, total)


def _load(qlen, total):
    if total is None:
        return qlen
    return qlen.to(torch.float32) / constant(total, torch.float32, qlen.device)


def _scenario_cur(env_cfg, env_state):
    """The scenario's current conditions (``scenarios.at_time``), or None
    when ``env_cfg`` scripts no scenario."""
    st = (None if env_cfg is None
          else scenarios.for_cfg(env_cfg, env_state["clock"].device))
    if st is None:
        return None
    return scenarios.at_time(st, env_state["clock"])


def _overload_drop(env_cfg, env_state, action):
    """Drop (action 0) where the fleet sits at or above the failover shed
    watermark and the request's best predicted score is below the shed
    floor: the env would shed it at admission anyway.  The identity
    without a failover config or watermark."""
    fo = getattr(env_cfg, "failover", None) if env_cfg is not None else None
    if fo is None or fo.shed_watermark is None:
        return action
    from repro_torch.env import failover as failover_lib
    occ = failover_lib.fleet_occupancy(env_cfg, env_state)
    dev = occ.device
    mark = constant((fo.shed_watermark,), torch.float32, dev)
    floor = constant((fo.shed_pred_s,), torch.float32, dev)
    best_s = env_state["pending"]["pred_s"].max(-1).values
    doomed = (occ >= mark) & (best_s < floor)
    return torch.where(doomed, 0, action)


def shortest_queue(n_experts: int, caps=None, env_cfg=None) -> Policy:
    """Least-loaded routing; ``caps=(run_caps, wait_caps)`` switches the
    load signal to per-expert occupancy on ragged fleets.  Under a
    scenario a down expert reads as infinitely loaded, and with the whole
    fleet down the policy drops."""
    total = _total_caps(caps)

    def act(pstate, env_state, obs, gen):
        load = _queue_load(env_state, total)
        cur = _scenario_cur(env_cfg, env_state)
        if cur is None:
            a = torch.argmin(load, dim=-1) + 1
        else:
            up = cur["up"]
            load = torch.where(up, load.to(torch.float32), torch.inf)
            a = torch.where(up.any(-1), torch.argmin(load, dim=-1) + 1, 0)
        return _overload_drop(env_cfg, env_state, a), pstate

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
    expert the policy drops (action 0).  Under a scenario a down expert is
    never eligible, the load floor is taken over up experts, and the full
    wait queue test uses the current wait caps."""
    total = _total_caps(caps)
    wait_caps = None if caps is None else tuple(int(w) for w in caps[1])

    def act(pstate, env_state, obs, gen):
        run, wlen = env_lib.queue_counts(env_state, "router load")
        load = _load(run + wlen, total)
        cur = _scenario_cur(env_cfg, env_state)
        if cur is not None:
            load = torch.where(cur["up"], load.to(torch.float32), torch.inf)
        lo = load.min(-1, keepdim=True).values
        if caps is None:
            ok = load <= lo + slack
        else:
            dev = load.device
            ok = ((load <= lo + slack / constant(total, torch.float32, dev))
                  & (wlen < constant(wait_caps, torch.int64, dev)))
        if cur is not None:
            ok = ok & cur["up"] & (wlen < cur["wait_cap"])
        pred = env_state["pending"]["pred_s"]
        a = torch.argmax(torch.where(ok, pred, -1.0), dim=-1) + 1
        a = torch.where(ok.any(-1), a, 0)
        return _overload_drop(env_cfg, env_state, a), pstate

    return Policy("QLL", _no_state, act)


def sac_policy(name: str, sac: sac_lib.SAC, *, greedy: bool = True,
               obs_fmt: str = "padded") -> Policy:
    def act(pstate, env_state, obs, gen):
        return sac_lib.act(sac, obs, gen, greedy=greedy), pstate

    return Policy(name, _no_state, act, obs_fmt=obs_fmt)
