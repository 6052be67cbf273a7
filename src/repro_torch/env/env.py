"""QoS-aware LLM routing environment (port of ``repro/env/env.py``),
batched over a leading env axis ``B``.

One env step = one routing decision per env:
  1. the pending request is routed (action 0 = drop, 1..N = expert) into
     the chosen expert's waiting queue (full queue => drop);
  2. the impact penalty (Eq. 15/16) is scored on that expert's running
     queue;
  3. the next arrival and the next pending request are drawn;
  4. every expert of every env advances to its env's next arrival, in one
     engine call (one kernel launch on the CUDA backend);
  5. reward = sum(completed phi) - penalty - drop_penalty * dropped.

``reset`` packs the fleet's static engine parameters once (``state["par"]``,
with ``state["wait_caps"]``) and ``step`` reuses them.  ``step`` makes no
host sync of its own (the ``"torch"`` engine backend syncs inside its
loop; the ``"cuda"`` backend does not).  Draws come from
the ``torch.Generator`` in ``state["gen"]``; ``step(..., draws=...)``
injects the next clock and pending request instead, which is how the
tests hold the port against the reference on identical draws.

The reference's scenarios (``cfg.scenario``) and failover (``cfg.failover``)
are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import constant, resolve
from repro_torch.env import engine, engine_layout as layout, profiles, workload
from repro_torch.env.profiles import ExpertPool

STAT_KEYS = ("phi", "lat", "score", "wait", "done", "viol",
             "dropped", "routed", "evicted")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_experts: int = 6
    run_cap: int = 5
    wait_cap: int = 5
    latency_L: float = 0.030          # 30 ms / token (paper default)
    n_types: int = 8
    n_buckets: int = 10
    max_output: int = 300
    max_prompt: int = 512
    score_pred_noise: float = 0.08
    len_pred_noise: float = 0.18
    workload: workload.WorkloadConfig = workload.WorkloadConfig()
    seed: int = 0
    drop_penalty: float = 0.8
    use_oracle_predictions: bool = False
    impact_mode: str = "paper"        # "paper" (Eq. 15) | "projected"
    engine_backend: Optional[str] = None  # None | "torch" | "cuda"
    admit_order: str = "fifo"
    run_caps: Optional[Tuple[int, ...]] = None
    wait_caps: Optional[Tuple[int, ...]] = None
    scenario: Optional[str] = None
    failover: Optional[object] = None


def _check_supported(cfg: EnvConfig) -> None:
    if cfg.scenario is not None:
        raise NotImplementedError("scenarios are not ported yet")
    if cfg.failover is not None:
        raise NotImplementedError("failover is not ported yet")


def make_env_pool(cfg: EnvConfig, device=None) -> ExpertPool:
    """The config's expert pool on ``device`` (the CUDA device by default)."""
    return profiles.make_pool(cfg.n_experts, cfg.n_types, seed=cfg.seed,
                              device=device)


def queue_caps(cfg: EnvConfig, device=None):
    """(run_caps, wait_caps) as (N,) int32 tensors, or (None, None) for a
    uniform fleet; a one-sided ragged config fills the other side with its
    packed width.  Validated against the packed widths."""
    if cfg.run_caps is None and cfg.wait_caps is None:
        return None, None
    out = []
    for caps, width, side in ((cfg.run_caps, cfg.run_cap, "run"),
                              (cfg.wait_caps, cfg.wait_cap, "wait")):
        if caps is None:
            caps = (width,) * cfg.n_experts
        if len(caps) != cfg.n_experts:
            raise ValueError(f"{side}_caps has {len(caps)} entries for "
                             f"n_experts={cfg.n_experts}")
        if not all(1 <= c <= width for c in caps):
            raise ValueError(f"{side}_caps must lie in [1, {width}] (the "
                             f"packed width); got {caps}")
        out.append(constant(caps, torch.int32, resolve(device)))
    return tuple(out)


def with_ragged_caps(cfg: EnvConfig, pool: Optional[ExpertPool] = None,
                     *, min_cap: int = 1) -> EnvConfig:
    """A copy of ``cfg`` with memory-derived ragged capacities."""
    # the capacities are host data: a pool on the CPU gives the same ones
    pool = pool if pool is not None else make_env_pool(cfg, device="cpu")
    rc, wc = profiles.memory_caps(pool, cfg.run_cap, cfg.wait_cap,
                                  min_cap=min_cap)
    return dataclasses.replace(cfg, run_caps=tuple(int(c) for c in rc),
                               wait_caps=tuple(int(c) for c in wc))


# ---------------------------------------------------------------------------
# Bucketized predictions (paper §V-B1)
# ---------------------------------------------------------------------------


def bucketize_score(cfg: EnvConfig, s: torch.Tensor) -> torch.Tensor:
    b = torch.clamp((s * cfg.n_buckets).to(torch.int32), 0, cfg.n_buckets - 1)
    return (b.to(torch.float32) + 0.5) / cfg.n_buckets


def bucketize_len(cfg: EnvConfig, d: torch.Tensor) -> torch.Tensor:
    width = cfg.max_output / cfg.n_buckets
    b = torch.clamp((d / width).to(torch.int32), 0, cfg.n_buckets - 1)
    return (b.to(torch.float32) + 0.5) * width


def predict(cfg: EnvConfig, gen: torch.Generator, score: torch.Tensor,
            out_len: torch.Tensor):
    """Noisy bucketized predictions of (score, length) per expert."""
    if cfg.use_oracle_predictions:
        return bucketize_score(cfg, score), bucketize_len(cfg, out_len)
    noise = lambda: torch.randn(score.shape, generator=gen,
                                device=score.device)
    s_noisy = score + cfg.score_pred_noise * noise()
    d_noisy = out_len.to(torch.float32) * torch.exp(
        cfg.len_pred_noise * noise())
    return (bucketize_score(cfg, torch.clamp(s_noisy, 0.0, 1.0)),
            bucketize_len(cfg, torch.clamp(d_noisy, 1.0,
                                           float(cfg.max_output))))


def _new_request(cfg: EnvConfig, pool: ExpertPool, gen: torch.Generator,
                 batch: int) -> dict:
    r = profiles.sample_request(pool, gen, batch)
    r["pred_s"], r["pred_d"] = predict(cfg, gen, r["score"],
                                       r["out_len"].to(torch.float32))
    return r


def reset(cfg: EnvConfig, pool: ExpertPool, gen: torch.Generator,
          batch: int, *, pending: Optional[dict] = None) -> dict:
    """A batch of ``batch`` fresh envs on the pool's device.  ``pending``
    injects the first pending request (fields (B,) / (B, N)) instead of
    drawing it."""
    _check_supported(cfg)
    dev = pool.k1.device
    zeros = lambda: torch.zeros((batch,), dtype=torch.float32, device=dev)
    run_caps, wait_caps = queue_caps(cfg, device=dev)
    return {
        "gen": gen,
        "par": engine.pool_params(pool, run_caps, wait_caps).repeat(batch, 1),
        "wait_caps": wait_caps,
        "clock": zeros(),
        "expert_clock": torch.zeros((batch, cfg.n_experts),
                                    dtype=torch.float32, device=dev),
        "queues": layout.empty_queues(cfg.n_experts, cfg.run_cap,
                                      cfg.wait_cap, batch=batch, device=dev),
        "wl": workload.init_state(batch, device=dev),
        "pending": (dict(pending) if pending is not None
                    else _new_request(cfg, pool, gen, batch)),
        "stats": {k: zeros() for k in STAT_KEYS},
    }


def _pick(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) -> x[b, n[b]] (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), n]


def impact_penalty(cfg: EnvConfig, pool: ExpertPool, state: dict,
                   action: torch.Tensor) -> torch.Tensor:
    """Eq. 15/16 second term per env: the estimated QoS loss among the
    chosen expert's running requests, from the predictors' view."""
    q = state["queues"]
    n = torch.clamp(action - 1, 0, cfg.n_experts - 1).long()
    t = state["clock"][:, None]
    k1 = pool.k1[n][:, None]
    k2 = pool.k2[n][:, None]
    p_j = state["pending"]["p_len"].to(torch.float32)[:, None]
    d_j = _pick(state["pending"]["pred_d"], n)[:, None]

    valid = _pick(layout.run_valid(q), n)                  # (B, R)
    d_cur = _pick(layout.run_d_cur(q), n).to(torch.float32)
    t_arrive = _pick(layout.run_t_arrive(q), n)
    d_hat = torch.maximum(_pick(layout.run_pred_d(q), n), d_cur + 1.0)
    rem = torch.clamp(d_hat - d_cur, min=0.0)
    K = torch.minimum(rem, d_j)
    extra = k1 * p_j + k2 * (K * p_j + 0.5 * K * (K + 1.0))
    if cfg.impact_mode == "paper":
        l_plus = extra / torch.clamp(d_hat, min=1.0)
        l_cur = (t - t_arrive) / torch.clamp(d_cur, min=1.0)
        l_est = l_cur + l_plus
    else:  # "projected": estimate the FINAL per-token latency instead
        elapsed = t - t_arrive
        run_tok = _pick(layout.run_p(q), n).to(torch.float32) + d_cur
        queue_tokens = torch.where(valid, run_tok, 0.0).sum(-1,
                                                            keepdim=True)
        est_remaining = rem * k2 * queue_tokens
        l_est = (elapsed + est_remaining + extra) / torch.clamp(d_hat,
                                                                min=1.0)
    would_violate = valid & (l_est >= cfg.latency_L)
    penalty = torch.where(would_violate, _pick(layout.run_pred_s(q), n),
                          0.0).sum(-1)
    return torch.where(action > 0, penalty, 0.0)


def _admit(cfg: EnvConfig, state: dict, action: torch.Tensor):
    """Push each env's pending request into expert (action-1)'s waiting
    queue.  Returns (queues, dropped (B,) float32)."""
    r = state["pending"]
    n = torch.clamp(action - 1, 0, cfg.n_experts - 1).long()
    queues, pushed = layout.push_wait(
        state["queues"], n, p=r["p_len"], d_true=_pick(r["out_len"], n),
        score=_pick(r["score"], n), pred_s=_pick(r["pred_s"], n),
        pred_d=_pick(r["pred_d"], n), t=state["clock"], gate=action > 0,
        wait_cap=state["wait_caps"])
    dropped = (action == 0) | ((action > 0) & ~pushed)
    return queues, dropped.to(torch.float32)


def step(cfg: EnvConfig, pool: ExpertPool, state: dict,
         action: torch.Tensor, *, draws: Optional[dict] = None):
    """One routing decision per env; ``action`` is (B,) int.  Returns
    (state, reward (B,), info).

    ``draws`` injects what the step would otherwise draw: ``{"clock": (B,)
    next arrival time, "pending": next pending request}``."""
    _check_supported(cfg)
    action = action.to(torch.int64)
    penalty = impact_penalty(cfg, pool, state, action)
    queues, dropped = _admit(cfg, state, action)

    gen = state["gen"]
    wl_state = state["wl"]
    if draws is None:
        dt, wl_state = workload.next_arrival(cfg.workload, wl_state,
                                             state["clock"], gen)
        t_next = state["clock"] + dt
    else:
        t_next = draws["clock"]

    queues, clocks, acc = engine.advance_all(
        pool, cfg.latency_L, queues, state["expert_clock"], t_next,
        backend=cfg.engine_backend, admit_order=cfg.admit_order,
        par=state["par"])
    acc = {k: v.sum(-1) for k, v in acc.items()}           # over experts

    reward = acc["phi"] - penalty - cfg.drop_penalty * dropped
    stats = dict(state["stats"])
    for k in ("phi", "lat", "score", "wait", "done", "viol"):
        stats[k] = stats[k] + acc[k]
    stats["dropped"] = stats["dropped"] + dropped
    stats["routed"] = stats["routed"] + (action > 0).to(torch.float32)

    pending = (dict(draws["pending"]) if draws is not None
               else _new_request(cfg, pool, gen, action.shape[0]))
    new_state = {"gen": gen, "par": state["par"],
                 "wait_caps": state["wait_caps"],
                 "clock": t_next, "expert_clock": clocks,
                 "queues": queues, "wl": wl_state, "pending": pending,
                 "stats": stats}
    info = {"reward": reward, "penalty": penalty, "completions": acc["done"],
            "phi": acc["phi"]}
    return new_state, reward, info


def episode_metrics(state: dict) -> dict:
    """Per-env paper metrics: average QoS and latency per token over
    completed requests, plus the counters (each (B,))."""
    s = state["stats"]
    done = torch.clamp(s["done"], min=1.0)
    return {
        "avg_qos": s["phi"] / done,
        "avg_latency_per_token": s["lat"] / done,
        "avg_wait": s["wait"] / done,
        "avg_score": s["score"] / done,
        "violation_rate": s["viol"] / done,
        "completed": s["done"],
        "dropped": s["dropped"],
        "routed": s["routed"],
        "evicted": s["evicted"],
    }
