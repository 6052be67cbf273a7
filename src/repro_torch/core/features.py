"""Request-level features (Eq. 6) and the raw-graph observation (port of
``repro/core/features.py``), batched over a leading env axis ``B``.

Request nodes carry (p, s_hat, d_hat, mem, d_cur, l_cur, retry); the
retry count is normalised by the failover retry budget (1 without
failover, where every count is 0).  Expert nodes carry (e_n, |run|
occupancy, |wait| occupancy, the pending request's per-expert (s_hat,
d_hat), k1, k2, up, cap fraction): ``up`` is the expert's availability at
the env's clock and the cap fraction its current live slots over its
baseline caps, from the config's scenario (both 1 without one).

Layouts (``fmt=``):

  * ``"padded"``   — ``run (B, N, R, F)`` / ``wait (B, N, W, F)`` with masks;
  * ``"segments"`` — one edge list ``req (B, E, F)`` with ``req_mask``:
    run rows first, then wait rows, both expert-major; on a ragged fleet
    the dead beyond-cap slots are dropped (E = sum of caps).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.device import constant
from repro_torch.env import engine_layout as layout

REQ_FEATS = 7
EXP_FEATS = 9

(REQ_P, REQ_PRED_S, REQ_PRED_D, REQ_MEM, REQ_D_CUR, REQ_LAT,
 REQ_RETRY) = range(7)


def build_obs(cfg, pool, state: dict, *, fmt: str = "padded") -> dict:
    """The heterogeneous-graph observation of every env, in ``fmt``."""
    if fmt not in ("padded", "segments"):
        raise ValueError(f"unknown obs fmt {fmt!r}")
    q = state["queues"]
    t = state["clock"][:, None, None]                     # (B, 1, 1)
    L = cfg.latency_L
    mo = float(cfg.max_output)
    mp = float(cfg.max_prompt)
    r = state["pending"]
    run_valid = layout.run_valid(q)
    wait_valid = layout.wait_valid(q)
    run_p = layout.run_p(q)
    run_d_cur = layout.run_d_cur(q)
    wait_pred_d = layout.wait_pred_d(q)
    # tokens -> memory fraction as ONE ratio, as the reference computes it
    mem_frac = pool.mem_per_token / pool.mem_capacity     # (N,)
    fo = getattr(cfg, "failover", None)
    retry_norm = float(max(fo.retry_budget, 1)) if fo is not None else 1.0

    d_cur = run_d_cur.to(torch.float32)
    run_mem = (run_p + run_d_cur).to(torch.float32) * mem_frac[:, None]
    l_cur = (t - layout.run_t_arrive(q)) / torch.clamp(d_cur, min=1.0)
    run_f = torch.stack([
        run_p.to(torch.float32) / mp,
        layout.run_pred_s(q),
        layout.run_pred_d(q) / mo,
        run_mem,
        d_cur / mo,
        l_cur / L,
        layout.run_retry(q).to(torch.float32) / retry_norm,
    ], dim=-1)
    run_f = torch.where(run_valid[..., None], run_f, 0.0)

    w_wait = (t - layout.wait_t_arrive(q)) / torch.clamp(wait_pred_d, min=1.0)
    zeros = torch.zeros_like(w_wait)
    wait_f = torch.stack([
        layout.wait_p(q).to(torch.float32) / mp,
        layout.wait_pred_s(q),
        wait_pred_d / mo,
        zeros,                                   # not yet resident
        zeros,                                   # d_cur = 0
        w_wait / L,                              # projected per-token wait
        layout.wait_retry(q).to(torch.float32) / retry_norm,
    ], dim=-1)
    wait_f = torch.where(wait_valid[..., None], wait_f, 0.0)

    tok = torch.where(run_valid, run_p + run_d_cur, 0)
    e_n = tok.sum(-1).to(torch.float32) * mem_frac
    run_caps = getattr(cfg, "run_caps", None)
    wait_caps = getattr(cfg, "wait_caps", None)
    n_exp = run_valid.shape[-2]
    dev = run_f.device
    # per-expert baseline caps (the packed widths on a uniform fleet)
    base = lambda caps, width: constant(
        caps if caps is not None else (width,) * n_exp, torch.float32, dev)
    base_rc = base(run_caps, run_valid.shape[-1])
    base_wc = base(wait_caps, wait_valid.shape[-1])
    if run_caps is None and wait_caps is None:
        occ_run = run_valid.to(torch.float32).mean(-1)
        occ_wait = wait_valid.to(torch.float32).mean(-1)
    else:
        # ragged fleet: occupancy relative to each expert's OWN cap
        occ_run = run_valid.to(torch.float32).sum(-1) / base_rc
        occ_wait = wait_valid.to(torch.float32).sum(-1) / base_wc

    st = scenarios.for_cfg(cfg, dev)
    if st is None:
        up_f = cap_frac = torch.ones_like(e_n)
    else:
        cur = scenarios.at_time(st, state["clock"])
        up_f = cur["up"].to(torch.float32)
        cap_frac = ((cur["run_cap"] + cur["wait_cap"]).to(torch.float32)
                    / (base_rc + base_wc))
    exp_f = torch.stack([
        e_n, occ_run, occ_wait,
        r["pred_s"], r["pred_d"] / mo,
        (pool.k1 * 1e3).expand_as(e_n), (pool.k2 * 1e4).expand_as(e_n),
        up_f, cap_frac,
    ], dim=-1)

    zero = torch.zeros_like(r["pred_s"][:, 0])
    arr_f = torch.stack([
        r["p_len"].to(torch.float32) / mp,
        r["pred_s"].mean(-1),
        r["pred_d"].mean(-1) / mo,
        zero, zero, zero, zero,
    ], dim=-1)

    obs = {"expert": exp_f, "run": run_f, "wait": wait_f,
           "run_mask": run_valid, "wait_mask": wait_valid, "arrived": arr_f}
    if fmt == "padded":
        return obs
    return to_segments(obs, run_caps=run_caps, wait_caps=wait_caps)


def _ragged_rows(caps: tuple, width: int) -> np.ndarray:
    """Flat row indices into an expert-major (N*width,) layout keeping each
    expert's first cap[n] slots."""
    return np.concatenate([n * width + np.arange(c)
                           for n, c in enumerate(caps)])


def to_segments(obs: dict, *, run_caps=None, wait_caps=None) -> dict:
    """Padded -> segment layout (run edges, then wait edges, expert-major;
    beyond-cap rows dropped on a ragged fleet)."""
    b, n, r = obs["run"].shape[:3]
    w = obs["wait"].shape[2]
    run_flat = obs["run"].reshape(b, n * r, -1)
    wait_flat = obs["wait"].reshape(b, n * w, -1)
    run_mask = obs["run_mask"].reshape(b, -1)
    wait_mask = obs["wait_mask"].reshape(b, -1)
    rows = lambda caps, width: constant((tuple(caps), width), torch.int64,
                                        run_flat.device, make=_ragged_rows)
    if run_caps is not None:
        idx = rows(run_caps, r)
        run_flat, run_mask = run_flat[:, idx], run_mask[:, idx]
    if wait_caps is not None:
        idx = rows(wait_caps, w)
        wait_flat, wait_mask = wait_flat[:, idx], wait_mask[:, idx]
    return {"expert": obs["expert"],
            "req": torch.cat([run_flat, wait_flat], dim=1),
            "req_mask": torch.cat([run_mask, wait_mask], dim=1),
            "arrived": obs["arrived"]}


def seg_run_rows(cfg) -> int:
    """Run-edge rows at the head of ``obs["req"]``."""
    caps = getattr(cfg, "run_caps", None)
    if caps is not None:
        return int(sum(caps))
    return cfg.n_experts * cfg.run_cap


def flat_expert_obs(obs: dict) -> torch.Tensor:
    """Baseline-RL state: (e_n, |run|, |wait|) per expert, flattened per
    env -> (B, 3N)."""
    return obs["expert"][..., :3].reshape(obs["expert"].shape[0], -1)
