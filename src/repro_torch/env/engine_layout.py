"""Packed SoA queue layout for the scheduling engine (layout layer).

Port of ``repro/env/engine_layout.py``; the channel order is identical:

    run_i   (..., N, R, RUN_I_CH)  int32    [valid, p, d_true, d_cur, retry]
    run_f   (..., N, R, RUN_F_CH)  float32  [score, pred_s, pred_d, t_arrive, t_admit]
    wait_i  (..., N, W, WAIT_I_CH) int32    [valid, p, d_true, retry]
    wait_f  (..., N, W, WAIT_F_CH) float32  [score, pred_s, pred_d, t_arrive]

The leading ``...`` is the env axis ``B`` (the reference vmaps over envs;
the port writes the axis out).  ``valid`` is 0/1 int32 and invalid slots
may hold stale fields: every consumer masks through the valid channel.

Per-expert capacities: slot j of expert n exists iff ``j < cap[n]``
(``slot_valid``); slots at or beyond the cap are never valid and are
masked out of every admission and selection.  With caps equal to the
packed widths every mask is all-True.

The TPU lane-fold (``fold_channels``) of the reference has no counterpart:
it existed only for the TPU's (8, 128) tile.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve

RI_VALID, RI_P, RI_D_TRUE, RI_D_CUR, RI_RETRY = 0, 1, 2, 3, 4
RUN_I_CH = 5
RF_SCORE, RF_PRED_S, RF_PRED_D, RF_T_ARRIVE, RF_T_ADMIT = 0, 1, 2, 3, 4
RUN_F_CH = 5
WI_VALID, WI_P, WI_D_TRUE, WI_RETRY = 0, 1, 2, 3
WAIT_I_CH = 4
WF_SCORE, WF_PRED_S, WF_PRED_D, WF_T_ARRIVE = 0, 1, 2, 3
WAIT_F_CH = 4

# Channel order of the (rows, PAR_CH) float32 per-expert parameter pack the
# lockstep kernel reads: pool scalars, ragged caps, availability and the
# admission floor.  Caps are small ints and ``up`` is 0/1, both exact in
# float32.
(PAR_K1, PAR_K2, PAR_MEM_CAP, PAR_MPT, PAR_RUN_CAP, PAR_WAIT_CAP,
 PAR_UP, PAR_ADMIT_MIN) = range(8)
PAR_CH = 8
# Capacity sentinel for capacity-free packs: exact in float32 and far above
# any packed width, so ``iota < PAR_CAP_FREE`` is all-True.
PAR_CAP_FREE = float(2 ** 24)

QUEUE_KEYS = ("run_i", "run_f", "wait_i", "wait_f")


def empty_queues(n: int, r: int, w: int, *, batch: int = None,
                 device=None) -> dict:
    """Empty queues shaped (N, ...) or, with ``batch``, (B, N, ...), on
    ``device`` (the CUDA device by default)."""
    device = resolve(device)
    lead = (n,) if batch is None else (batch, n)
    z = lambda *shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    return {"run_i": z(r, RUN_I_CH, dt=torch.int32),
            "run_f": z(r, RUN_F_CH, dt=torch.float32),
            "wait_i": z(w, WAIT_I_CH, dt=torch.int32),
            "wait_f": z(w, WAIT_F_CH, dt=torch.float32)}


def slot_valid(caps: torch.Tensor, width: int) -> torch.Tensor:
    """(..., N, width) bool mask of live slots for capacities ``caps
    (..., N)`` (a scenario's current caps carry the env axis)."""
    caps = torch.as_tensor(caps, dtype=torch.int32)
    return torch.arange(width, device=caps.device) < caps[..., None]


def queues_from_numpy(q: dict, device=None) -> dict:
    """Queue dict of numpy arrays (e.g. the reference's, via ``np.asarray``)
    -> tensors on ``device`` (the CUDA device by default), dtypes
    unchanged."""
    device = resolve(device)
    return {k: torch.as_tensor(np.asarray(q[k])).to(device)
            for k in QUEUE_KEYS}


def queues_to_numpy(q: dict) -> dict:
    return {k: q[k].detach().cpu().numpy() for k in QUEUE_KEYS}


# ---------------------------------------------------------------------------
# Thin accessors
# ---------------------------------------------------------------------------


def run_valid(q: dict) -> torch.Tensor:
    return q["run_i"][..., RI_VALID] > 0


def run_p(q: dict) -> torch.Tensor:
    return q["run_i"][..., RI_P]


def run_d_true(q: dict) -> torch.Tensor:
    return q["run_i"][..., RI_D_TRUE]


def run_d_cur(q: dict) -> torch.Tensor:
    return q["run_i"][..., RI_D_CUR]


def run_retry(q: dict) -> torch.Tensor:
    return q["run_i"][..., RI_RETRY]


def run_score(q: dict) -> torch.Tensor:
    return q["run_f"][..., RF_SCORE]


def run_pred_s(q: dict) -> torch.Tensor:
    return q["run_f"][..., RF_PRED_S]


def run_pred_d(q: dict) -> torch.Tensor:
    return q["run_f"][..., RF_PRED_D]


def run_t_arrive(q: dict) -> torch.Tensor:
    return q["run_f"][..., RF_T_ARRIVE]


def run_t_admit(q: dict) -> torch.Tensor:
    return q["run_f"][..., RF_T_ADMIT]


def wait_valid(q: dict) -> torch.Tensor:
    return q["wait_i"][..., WI_VALID] > 0


def wait_p(q: dict) -> torch.Tensor:
    return q["wait_i"][..., WI_P]


def wait_d_true(q: dict) -> torch.Tensor:
    return q["wait_i"][..., WI_D_TRUE]


def wait_retry(q: dict) -> torch.Tensor:
    return q["wait_i"][..., WI_RETRY]


def wait_score(q: dict) -> torch.Tensor:
    return q["wait_f"][..., WF_SCORE]


def wait_pred_s(q: dict) -> torch.Tensor:
    return q["wait_f"][..., WF_PRED_S]


def wait_pred_d(q: dict) -> torch.Tensor:
    return q["wait_f"][..., WF_PRED_D]


def wait_t_arrive(q: dict) -> torch.Tensor:
    return q["wait_f"][..., WF_T_ARRIVE]


def push_wait(q: dict, n: torch.Tensor, *, p, d_true, score, pred_s, pred_d,
              t, gate=True, wait_cap=None, retry=0) -> Tuple[dict, torch.Tensor]:
    """Batched masked push: env b's request goes into expert ``n[b]``'s first
    free waiting slot.  Queues are (B, N, W, CH); ``n`` and every field are
    (B,) (or scalars, broadcast over B).  With ``wait_cap`` ((N,), or (B,
    N) per env) only slots below the expert's cap count as free, so a full
    in-cap queue rejects the push.  No-op where the queue is full or ``gate`` is False.  Returns
    (new queues, pushed (B,) bool); the input tensors are not modified."""
    wi, wf = q["wait_i"], q["wait_f"]
    b_n, _, w, _ = wi.shape
    dev = wi.device
    bidx = torch.arange(b_n, device=dev)
    n = (n.to(dev) if isinstance(n, torch.Tensor)
         else torch.full((b_n,), n, device=dev)).long().expand(b_n)
    free = wi[bidx, n, :, WI_VALID] == 0                     # (B, W)
    if wait_cap is not None:
        ok = slot_valid(wait_cap.to(dev), w)
        free = free & (ok[bidx, n] if ok.dim() == 3 else ok[n])
    pushed = free.any(-1)
    if isinstance(gate, torch.Tensor):
        pushed = pushed & gate.to(dev)
    elif not gate:
        pushed = torch.zeros_like(pushed)
    # first free slot; argmax refuses bool, and returns the first index on
    # ties as the reference's jnp.argmax does
    slot = torch.argmax(free.to(torch.uint8), dim=-1)

    def col(x, dt):
        if isinstance(x, torch.Tensor):
            return x.to(dev, dt).expand(b_n)
        return torch.full((b_n,), x, dtype=dt, device=dev)

    new_i = torch.stack([pushed.to(torch.int32), col(p, torch.int32),
                         col(d_true, torch.int32), col(retry, torch.int32)],
                        -1)
    new_f = torch.stack([col(score, torch.float32), col(pred_s, torch.float32),
                         col(pred_d, torch.float32), col(t, torch.float32)],
                        -1)
    wi, wf = wi.clone(), wf.clone()
    wi[bidx, n, slot] = torch.where(pushed[:, None], new_i, wi[bidx, n, slot])
    wf[bidx, n, slot] = torch.where(pushed[:, None], new_f, wf[bidx, n, slot])
    return {**q, "wait_i": wi, "wait_f": wf}, pushed


def mem_used(q: dict, mem_per_token: torch.Tensor) -> torch.Tensor:
    """(..., N) bytes currently resident per expert."""
    tok = torch.where(run_valid(q), run_p(q) + run_d_cur(q), 0)
    return tok.sum(-1).to(torch.float32) * mem_per_token
