"""Failure-aware request lifecycle (port of ``repro/env/failover.py``),
batched over the leading env axis: in-flight failover, retry budgets with
exponential backoff, and overload shedding.

With ``EnvConfig.failover`` set, one env step is

    lookup -> drain-failed -> evict -> readmit -> gated admit -> advance

  * **drain-failed** — every request on a down expert (run and wait
    queues) leaves its queue for the bounded retry buffer
    (``drain_failed``), before eviction, so stranded work on an expert
    that is down and cap-shrunk is retried and not evicted.  A request is
    shed instead when its incremented retry count exceeds
    ``retry_budget``, when it is past its predicted deadline ``t_arrive +
    L * pred_d``, or when the buffer is full.  A buffered request may be
    re-admitted from ``t_drain + backoff_base * 2**(retry - 1)``.
  * **readmit** — up to ``max_redispatch`` eligible retries per step,
    best first by the env's ``admit_order`` key, each to the least-loaded
    up expert with a free in-cap wait slot (``readmit``); entries past
    their deadline are shed first.  A drained run-side request loses its
    decode progress but keeps its ``t_arrive``.
  * **overload shedding** — with ``shed_watermark`` set, fleet occupancy
    at or above it sets the per-expert admission floor ``admit_min =
    shed_pred_s``: arrivals predicted below it are shed at the admit gate
    and queued waiters below it are deferred by the engine; below the
    watermark the floor is ``-INF``.

Every request is always in one place:
``arrivals == completed + dropped + evicted + shed + in flight`` (queues
and retry buffer).

Deadlines are ``fma(L, pred_d, t_arrive)``, one rounding, as the
reference's compiled step computes them (``engine.fma_f32``).  Nothing
here syncs with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import constant
from repro_torch.env.engine import INF, admit_sort_key, fma_f32
from repro_torch.env.engine_layout import (
    RI_P, RI_D_TRUE, RI_RETRY, RI_VALID, RUN_F_CH,
    WI_P, WI_D_TRUE, WI_RETRY, WI_VALID,
    WF_PRED_D, WF_PRED_S, WF_SCORE, WF_T_ARRIVE, WAIT_F_CH,
    push_wait, run_valid, slot_valid, wait_valid,
)

# Retry-buffer int channel order; the float channels are the wait side's
# WF_* order, so ``engine.admit_sort_key`` ranks the buffer directly.
BUF_VALID, BUF_P, BUF_D_TRUE, BUF_RETRY = 0, 1, 2, 3
BUF_I_CH = 4


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Failure-aware lifecycle knobs (module docstring).  ``shed_watermark
    =None`` disables overload shedding; drain, retry and backoff still
    run."""
    retry_budget: int = 2        # max re-dispatches per request
    backoff_base: float = 0.05   # seconds; t_elig = t + base * 2**(retry-1)
    buffer_cap: int = 16         # retry-buffer slots per env
    max_redispatch: int = 4      # retries re-admitted per env step
    shed_watermark: Optional[float] = None  # fleet occupancy in (0, 1]
    shed_pred_s: float = 0.45    # admission floor while over the watermark
    shed_penalty: float = 0.4

    def __post_init__(self):
        if self.retry_budget < 0 or self.buffer_cap < 1:
            raise ValueError(
                f"retry_budget must be >= 0 and buffer_cap >= 1; got "
                f"{self.retry_budget}, {self.buffer_cap}")
        if self.backoff_base < 0 or self.max_redispatch < 0:
            raise ValueError(
                f"backoff_base and max_redispatch must be >= 0; got "
                f"{self.backoff_base}, {self.max_redispatch}")
        if self.shed_watermark is not None and not (
                0.0 < self.shed_watermark <= 1.0):
            raise ValueError(
                f"shed_watermark must lie in (0, 1] or be None; got "
                f"{self.shed_watermark}")


def empty_buffer(batch: int, cap: int, device) -> dict:
    """An empty retry buffer per env: ``buf_i (B, cap, BUF_I_CH)`` int32,
    ``buf_f (B, cap, WAIT_F_CH)`` float32 (WF_* order), ``buf_t (B, cap)``
    float32 eligibility times."""
    z = lambda *shape, dt: torch.zeros((batch, cap) + shape, dtype=dt,
                                       device=device)
    return {"buf_i": z(BUF_I_CH, dt=torch.int32),
            "buf_f": z(WAIT_F_CH, dt=torch.float32),
            "buf_t": z(dt=torch.float32)}


def in_buffer(buf: dict) -> torch.Tensor:
    """(B,) float32 count of live retry-buffer entries."""
    return (buf["buf_i"][..., BUF_VALID] > 0).to(torch.float32).sum(-1)


def _deadline(fields: torch.Tensor, latency_L: float) -> torch.Tensor:
    return fma_f32(latency_L, fields[..., WF_PRED_D], fields[..., WF_T_ARRIVE])


def drain_failed(queues: dict, buf: dict, up: torch.Tensor, t: torch.Tensor,
                 latency_L: float, cfg: FailoverConfig):
    """Drain every request on a down expert (``up (B, N)``) into the retry
    buffer; shed budget-exhausted, past-deadline and overflow candidates.
    Returns ``(queues, buf, n_buffered (B,), n_shed (B,))``."""
    ri, rf = queues["run_i"], queues["run_f"]
    wi, wf = queues["wait_i"], queues["wait_f"]
    b = ri.shape[0]
    cap = buf["buf_i"].shape[1]
    down = ~up.to(torch.bool)                                 # (B, N)
    run_cand = (ri[..., RI_VALID] > 0) & down[..., None]      # (B, N, R)
    wait_cand = (wi[..., WI_VALID] > 0) & down[..., None]     # (B, N, W)

    # run-major then wait-major candidates; run_f's first WAIT_F_CH
    # channels are the wait side's [score, pred_s, pred_d, t_arrive]
    flat = lambda x: x.reshape(b, -1)
    cand = torch.cat([flat(run_cand), flat(wait_cand)], 1)   # (B, M)
    cat_i = lambda r, w: torch.cat([flat(r), flat(w)], 1)
    p = cat_i(ri[..., RI_P], wi[..., WI_P])
    d_true = cat_i(ri[..., RI_D_TRUE], wi[..., WI_D_TRUE])
    retry_new = cat_i(ri[..., RI_RETRY], wi[..., WI_RETRY]) + 1
    fields = torch.cat([rf.reshape(b, -1, RUN_F_CH)[..., :WAIT_F_CH],
                        wf.reshape(b, -1, WAIT_F_CH)], 1)     # (B, M, 4)

    past_deadline = t[:, None] > _deadline(fields, latency_L)
    shed_now = cand & ((retry_new > cfg.retry_budget) | past_deadline)
    surv = cand & ~shed_now

    # survivors go to the free slots in slot order; the excess overflows
    # and is shed.  Unplaced rows scatter into a sentinel row at ``cap``.
    free = buf["buf_i"][..., BUF_VALID] == 0                  # (B, cap)
    n_free = free.to(torch.int32).sum(-1, keepdim=True)
    order = torch.argsort((~free).to(torch.uint8), dim=-1, stable=True)
    rank = torch.cumsum(surv.to(torch.int32), -1) - 1         # (B, M)
    placed = surv & (rank < n_free)
    dest = torch.where(placed,
                       order.gather(1, torch.clamp(rank, 0, cap - 1).long()),
                       cap)

    rows_i = torch.stack([torch.ones_like(p), p, d_true, retry_new], -1)
    rows_t = t[:, None] + cfg.backoff_base * torch.exp2(
        (retry_new - 1).to(torch.float32))

    def put(dst, rows):
        pad = torch.cat([dst, torch.zeros_like(dst[:, :1])], 1)
        idx = dest.reshape(dest.shape + (1,) * (rows.dim() - 2))
        return pad.scatter(1, idx.expand(rows.shape), rows)[:, :cap]

    buf = {"buf_i": put(buf["buf_i"], rows_i),
           "buf_f": put(buf["buf_f"], fields),
           "buf_t": put(buf["buf_t"], rows_t)}
    run_i, wait_i = ri.clone(), wi.clone()
    run_i[..., RI_VALID] = torch.where(run_cand, 0, ri[..., RI_VALID])
    wait_i[..., WI_VALID] = torch.where(wait_cand, 0, wi[..., WI_VALID])
    queues = {**queues, "run_i": run_i, "wait_i": wait_i}
    n_buffered = placed.to(torch.float32).sum(-1)
    n_shed = (shed_now.to(torch.float32).sum(-1)
              + (surv & ~placed).to(torch.float32).sum(-1))
    return queues, buf, n_buffered, n_shed


def readmit(queues: dict, buf: dict, up: torch.Tensor, t: torch.Tensor,
            wait_caps: torch.Tensor, latency_L: float, cfg: FailoverConfig,
            *, admit_order: str = "fifo"):
    """Re-admit up to ``cfg.max_redispatch`` backoff-eligible retries per
    env, best first by the ``admit_order`` key, each to the least-loaded up
    expert with a free in-cap wait slot (``wait_caps`` (N,) or (B, N)).
    Entries past their deadline are shed first.  Returns ``(queues, buf,
    n_readmitted (B,), n_shed (B,))``."""
    buf_i, buf_f, buf_t = buf["buf_i"], buf["buf_f"], buf["buf_t"]
    b = buf_i.shape[0]
    bidx = torch.arange(b, device=buf_i.device)
    upv = up.to(torch.bool)
    w_width = queues["wait_i"].shape[-2]

    valid = buf_i[..., BUF_VALID] > 0
    expired = valid & (t[:, None] > _deadline(buf_f, latency_L))
    n_shed = expired.to(torch.float32).sum(-1)
    buf_i = buf_i.clone()
    buf_i[..., BUF_VALID] = (valid & ~expired).to(torch.int32)

    sort_key = admit_sort_key(buf_f, admit_order, latency_L)  # (B, cap)
    in_cap = slot_valid(wait_caps, w_width)                   # (.., N, W)
    n_re = torch.zeros((b,), dtype=torch.float32, device=buf_i.device)
    for _ in range(cfg.max_redispatch):
        elig = (buf_i[..., BUF_VALID] > 0) & (t[:, None] >= buf_t)
        idx = torch.argmin(torch.where(elig, sort_key, INF), dim=-1)
        wvq = wait_valid(queues)
        has_free = (~wvq & in_cap).any(-1) & upv              # (B, N)
        load = ((wvq & in_cap).sum(-1)
                + run_valid(queues).sum(-1)).to(torch.float32)
        tgt = torch.argmin(torch.where(has_free, load, INF), dim=-1)
        do = elig.any(-1) & has_free.any(-1)
        row_i, row_f = buf_i[bidx, idx], buf_f[bidx, idx]
        queues, pushed = push_wait(
            queues, tgt, p=row_i[:, BUF_P], d_true=row_i[:, BUF_D_TRUE],
            score=row_f[:, WF_SCORE], pred_s=row_f[:, WF_PRED_S],
            pred_d=row_f[:, WF_PRED_D],
            t=row_f[:, WF_T_ARRIVE],   # keep the original arrival time
            gate=do, wait_cap=wait_caps, retry=row_i[:, BUF_RETRY])
        buf_i[bidx, idx, BUF_VALID] = torch.where(
            pushed, 0, buf_i[bidx, idx, BUF_VALID])
        n_re = n_re + pushed.to(torch.float32)
    return queues, {"buf_i": buf_i, "buf_f": buf_f, "buf_t": buf_t}, \
        n_re, n_shed


def occupancy(queues: dict, run_caps: torch.Tensor, wait_caps: torch.Tensor
              ) -> torch.Tensor:
    """(B,) fleet occupancy in [0, 1]: valid in-cap slots over live
    capacity (caps (N,) or (B, N))."""
    rv = run_valid(queues) & slot_valid(run_caps, queues["run_i"].shape[-2])
    wv = wait_valid(queues) & slot_valid(wait_caps,
                                         queues["wait_i"].shape[-2])
    used = (rv.to(torch.float32).sum((-1, -2))
            + wv.to(torch.float32).sum((-1, -2)))
    live = torch.clamp((run_caps.sum(-1) + wait_caps.sum(-1)).to(
        torch.float32), min=1.0)
    return used / live


def admit_min_of(occ: torch.Tensor, cfg: FailoverConfig, n_experts: int
                 ) -> torch.Tensor:
    """The (B, N) admission floor: ``shed_pred_s`` where occupancy is at or
    above the watermark (both compared in float32), ``-INF`` below."""
    mark = constant((cfg.shed_watermark,), torch.float32, occ.device)
    floor = torch.where(occ >= mark, cfg.shed_pred_s, -INF).to(torch.float32)
    return floor[:, None].expand(occ.shape[0], n_experts)


def fleet_occupancy(cfg, state: dict) -> torch.Tensor:
    """(B,) occupancy for an ``EnvConfig``-shaped config and env state,
    against the current scenario caps when a scenario is scripted."""
    from repro_torch import scenarios
    from repro_torch.env import env as env_lib

    dev = state["clock"].device
    run_caps, wait_caps = env_lib.queue_caps(cfg, device=dev)
    st = scenarios.for_cfg(cfg, dev)
    if st is not None:
        cur = scenarios.at_time(st, state["clock"])
        run_caps, wait_caps = cur["run_cap"], cur["wait_cap"]
    n = cfg.n_experts
    full = lambda width: torch.full((n,), width, dtype=torch.int32,
                                    device=dev)
    if run_caps is None:
        run_caps = full(cfg.run_cap)
    if wait_caps is None:
        wait_caps = full(cfg.wait_cap)
    return occupancy(state["queues"], run_caps, wait_caps)
