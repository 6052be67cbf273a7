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

With ``cfg.scenario`` (a name in ``repro_torch.scenarios``) each env's
conditions are looked up at its clock at the start of the step and hold
for the step: beyond-cap occupants are evicted, admission and the advance
run against the current caps and availability, stragglers' k1/k2 are
scaled and the next arrival comes at the scenario's rate.  With
``cfg.failover`` (``env.failover``) the step is lookup -> drain-failed ->
evict -> readmit -> gated admit -> advance, as in the reference.  Both
build the engine's parameter pack afresh each step; without them the pack
from ``reset`` serves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import scenarios
from repro_torch.device import constant, resolve
from repro_torch.env import engine, engine_layout as layout, failover
from repro_torch.env import profiles, workload
from repro_torch.env.failover import FailoverConfig
from repro_torch.env.profiles import ExpertPool

STAT_KEYS = ("phi", "lat", "score", "wait", "done", "viol",
             "dropped", "routed", "evicted")
# failover accounting: shed (removed by budget, deadline, overflow or
# overload), retried (entered the retry buffer), redispatched (re-admitted)
FAILOVER_STAT_KEYS = ("shed", "retried", "redispatched")


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
    # a named scenario of ``repro_torch.scenarios`` (None: stationary
    # workload, always-up fleet; "always_up" is byte-identical to None)
    scenario: Optional[str] = None
    # the failure-aware request lifecycle (None: requests on a down expert
    # freeze in place)
    failover: Optional[FailoverConfig] = None


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
    drawing it.  An unknown scenario name raises ``KeyError`` here."""
    dev = pool.k1.device
    scenarios.for_cfg(cfg, dev)
    zeros = lambda: torch.zeros((batch,), dtype=torch.float32, device=dev)
    run_caps, wait_caps = queue_caps(cfg, device=dev)
    stat_keys = STAT_KEYS + (FAILOVER_STAT_KEYS if cfg.failover else ())
    state = {
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
        "stats": {k: zeros() for k in stat_keys},
    }
    if cfg.failover is not None:
        state["retry_buf"] = failover.empty_buffer(
            batch, cfg.failover.buffer_cap, dev)
    return state


def _pick(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) -> x[b, n[b]] (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), n]


def impact_penalty(cfg: EnvConfig, pool: ExpertPool, state: dict,
                   action: torch.Tensor, up=None) -> torch.Tensor:
    """Eq. 15/16 second term per env: the estimated QoS loss among the
    chosen expert's running requests, from the predictors' view.

    Routing to a down expert (``up (B, N)``, by default the scenario's
    availability at each env's clock) is charged as a violation of every
    running request there plus the routed request itself."""
    if up is None:
        up = scenarios.availability(cfg, state["clock"])
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
    run_s = _pick(layout.run_pred_s(q), n)
    penalty = torch.where(would_violate, run_s, 0.0).sum(-1)
    if up is not None:
        doomed = (torch.where(valid, run_s, 0.0).sum(-1)
                  + _pick(state["pending"]["pred_s"], n))
        penalty = torch.where(_pick(up, n), penalty, doomed)
    return torch.where(action > 0, penalty, 0.0)


def _admit(cfg: EnvConfig, state: dict, action: torch.Tensor, up=None,
           wait_caps=None, admit_min=None):
    """Push each env's pending request into expert (action-1)'s waiting
    queue, against the current ``up``/``wait_caps`` (a down expert admits
    nothing: the push becomes a drop) and the overload floor ``admit_min``
    (a routed request predicted below it is shed).  Returns (queues,
    dropped, shed), each count (B,) float32."""
    r = state["pending"]
    n = torch.clamp(action - 1, 0, cfg.n_experts - 1).long()
    if wait_caps is None:
        wait_caps = state["wait_caps"]
    pred_s = _pick(r["pred_s"], n)
    gate = action > 0
    if up is not None:
        gate = gate & _pick(up, n)
    shed = torch.zeros_like(gate)
    if admit_min is not None:
        shed = (action > 0) & (pred_s < _pick(admit_min, n))
        gate = gate & ~shed
    queues, pushed = layout.push_wait(
        state["queues"], n, p=r["p_len"], d_true=_pick(r["out_len"], n),
        score=_pick(r["score"], n), pred_s=pred_s,
        pred_d=_pick(r["pred_d"], n), t=state["clock"], gate=gate,
        wait_cap=wait_caps)
    dropped = (action == 0) | ((action > 0) & ~shed & ~pushed)
    return queues, dropped.to(torch.float32), shed.to(torch.float32)


def step(cfg: EnvConfig, pool: ExpertPool, state: dict,
         action: torch.Tensor, *, draws: Optional[dict] = None):
    """One routing decision per env; ``action`` is (B,) int.  Returns
    (state, reward (B,), info).  Under a scenario or failover the step
    follows the reference's order (module docstring).

    ``draws`` injects what the step would otherwise draw: ``{"clock": (B,)
    next arrival time, "pending": next pending request}``."""
    action = action.to(torch.int64)
    dev = state["clock"].device
    st = scenarios.for_cfg(cfg, dev)
    fo = cfg.failover
    run_caps, wait_caps = queue_caps(cfg, device=dev)
    up = k_scale = rate_mult = None
    queues = state["queues"]
    zeros = torch.zeros_like(state["clock"])
    evicted = shed = retried = redispatched = zeros
    if st is not None:
        cur = scenarios.at_time(st, state["clock"])
        run_caps, wait_caps = cur["run_cap"], cur["wait_cap"]
        up, k_scale, rate_mult = cur["up"], cur["k_scale"], cur["rate_mult"]

    full = lambda width: torch.full((cfg.n_experts,), width,
                                    dtype=torch.int32, device=dev)
    admit_min, retry_buf = None, state.get("retry_buf")
    if fo is not None:
        up_now = up if up is not None else torch.ones_like(
            state["expert_clock"], dtype=torch.bool)
        # drain before evict: stranded work on an expert that is down and
        # cap-shrunk is retried, not evicted
        queues, retry_buf, retried, shed = failover.drain_failed(
            queues, retry_buf, up_now, state["clock"], cfg.latency_L, fo)
    if st is not None:
        queues, evicted = scenarios.evict_beyond_cap(queues, run_caps,
                                                     wait_caps)
    if fo is not None:
        wc_now = wait_caps if wait_caps is not None else full(cfg.wait_cap)
        queues, retry_buf, redispatched, n_shed = failover.readmit(
            queues, retry_buf, up_now, state["clock"], wc_now,
            cfg.latency_L, fo, admit_order=cfg.admit_order)
        shed = shed + n_shed
        if fo.shed_watermark is not None:
            rc_now = run_caps if run_caps is not None else full(cfg.run_cap)
            occ = failover.occupancy(queues, rc_now, wc_now)
            admit_min = failover.admit_min_of(occ, fo, cfg.n_experts)

    state = {**state, "queues": queues}
    penalty = impact_penalty(cfg, pool, state, action, up=up)
    queues, dropped, arr_shed = _admit(cfg, state, action, up=up,
                                       wait_caps=wait_caps,
                                       admit_min=admit_min)
    shed = shed + arr_shed

    gen = state["gen"]
    wl_state = state["wl"]
    if draws is None:
        dt, wl_state = workload.next_arrival(cfg.workload, wl_state,
                                             state["clock"], gen, rate_mult)
        t_next = state["clock"] + dt
    else:
        t_next = draws["clock"]

    if st is None and admit_min is None:
        par = state["par"]                  # the fleet's static pack
    else:
        par = engine.pool_params(pool, run_caps, wait_caps, up, k_scale,
                                 admit_min)
    queues, clocks, acc = engine.advance_all(
        pool, cfg.latency_L, queues, state["expert_clock"], t_next,
        backend=cfg.engine_backend, admit_order=cfg.admit_order, par=par)
    acc = {k: v.sum(-1) for k, v in acc.items()}           # over experts

    reward = acc["phi"] - penalty - cfg.drop_penalty * dropped
    if fo is not None:
        reward = reward - fo.shed_penalty * shed
    stats = dict(state["stats"])
    for k in ("phi", "lat", "score", "wait", "done", "viol"):
        stats[k] = stats[k] + acc[k]
    stats["dropped"] = stats["dropped"] + dropped
    stats["routed"] = stats["routed"] + (action > 0).to(torch.float32)
    stats["evicted"] = stats["evicted"] + evicted
    if fo is not None:
        stats["shed"] = stats["shed"] + shed
        stats["retried"] = stats["retried"] + retried
        stats["redispatched"] = stats["redispatched"] + redispatched

    pending = (dict(draws["pending"]) if draws is not None
               else _new_request(cfg, pool, gen, action.shape[0]))
    new_state = {"gen": gen, "par": state["par"],
                 "wait_caps": state["wait_caps"],
                 "clock": t_next, "expert_clock": clocks,
                 "queues": queues, "wl": wl_state, "pending": pending,
                 "stats": stats}
    if fo is not None:
        new_state["retry_buf"] = retry_buf
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
        **{k: s[k] for k in FAILOVER_STAT_KEYS if k in s},
    }
