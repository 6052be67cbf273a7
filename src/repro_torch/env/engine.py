"""Iteration-level scheduling engine (port of ``repro/env/engine.py``).

Each expert keeps a waiting and a running queue.  One engine iteration of
one expert either

  1. *admits* the best live waiter (a run slot is free, memory fits, the
     expert is up): ``clock += k1 * p``, the request joins the running
     queue with its first token;
  2. *decodes* every running request: ``clock += k2 * sum(p + d_cur)``,
     each ``d_cur += 1``, finished requests leave and add phi / lat /
     score / wait / done / viol to the window's accumulator; or
  3. *idles* to ``t_next``.

An expert loops until its clock reaches ``t_next`` or it has no work.
Experts are independent: the reference's lockstep ``while_loop`` over all
experts is only a vectorisation device.

Backends of ``advance_all``:

  * ``"torch"`` — ``advance_shard``, a plain PyTorch loop of masked tensor
    steps over the rows still active (it syncs with the host once per
    iteration to test for termination).  It is also the oracle of the
    CUDA kernel (``kernels/lockstep_advance/ref.py``).
  * ``"cuda"``  — the hand-written kernel, one launch for every row of
    every env (``kernels/lockstep_advance/ops.py``).
  * ``"shard"`` — the experts split over the ``expert`` axis of a mesh
    (``launch.mesh.make_expert_mesh()`` by default; the reference's
    ``"shard_map"``): each rank advances its block of ``N / k`` experts
    of every env with ``shard_body`` (``"cuda"``, the kernel, or
    ``"torch"``, the plain loop; by default the one the device runs), and
    one all-gather over the axis brings every rank the accumulators of
    all N (six float32 channels per expert row).  Queue rows and clocks
    stay on the rank that advanced them, as the reference's ``out_specs``
    keep them: with ``local=True`` the caller passes and gets back its
    block alone (the env's state under this backend); a caller that
    passes every row gets every row back, through a second gather
    counted as its reader's (``"caller"``).

``backend=None`` picks ``"cuda"`` for CUDA tensors and ``"torch"`` for CPU
tensors.

Rows and envs: queues may be (B, N, ...) with clocks (B, N) or flattened
to (B*N, ...) rows with clocks (B*N,).  ``t_next`` is per env (B,), per
row, or a scalar; the reference takes one scalar per env and vmaps.

Admission order (``admit_order``): ``fifo`` (smallest t_arrive), ``qos``
(largest pred_s), ``qos_aged`` (smallest ``QOS_AGE_BETA*t_arrive -
pred_s``) or ``edf`` (smallest ``t_arrive + L*pred_d``); ties go to the
lowest slot index.

Floating point: the reference's engine, compiled by XLA for the CPU, is
contracted to fused multiply-adds at four sites, established by probing
it on inputs where the fused and unfused results differ:

  * the decode clock   ``fma(k2, tokens, clock)``;
  * the admit clock    ``fma(k1, p, clock)``;
  * the memory check   ``fma(tokens, mpt, mpt * (p + 1)) <= cap``;
  * the ``edf`` key    ``fma(L, pred_d, t_arrive)``.

Eager PyTorch never fuses, so this module computes those four sites with
``fma_f32``, a float32 FMA emulated in float64; every other product and sum
rounds on its own, as in the reference.  The CUDA kernel writes
``__fmaf_rn`` at the same four sites and is built with ``--fmad=false``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import constant
from repro_torch.env.engine_layout import (
    RI_VALID, RI_P, RI_D_TRUE, RI_D_CUR, RUN_I_CH,
    RF_SCORE, RF_T_ARRIVE, RF_T_ADMIT, RUN_F_CH,
    WI_VALID, WI_P, WI_D_TRUE, WI_RETRY, WAIT_I_CH,
    WF_SCORE, WF_PRED_S, WF_PRED_D, WF_T_ARRIVE, WAIT_F_CH,
    PAR_K1, PAR_K2, PAR_MEM_CAP, PAR_MPT, PAR_RUN_CAP, PAR_WAIT_CAP,
    PAR_UP, PAR_ADMIT_MIN, PAR_CH, PAR_CAP_FREE,
)
from repro_torch.env.profiles import ExpertPool

INF = 1e30
BACKENDS = ("torch", "cuda", "shard")
SHARD_BODIES = ("cuda", "torch")
ADMIT_ORDERS = ("fifo", "qos", "qos_aged", "edf")
ACC_KEYS = ("phi", "lat", "score", "wait", "done", "viol")
QOS_AGE_BETA = 0.5


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add.

    Computed as ``(c + a*b)`` in float64, then rounded to float32.  The
    product of two float32 values is exact in float64 (at most 48
    significant bits, 37 when one factor is an integer below 2**13 as at
    the clock and memory sites).  The float64 sum is exact while the
    operands' exponents differ by at most 53 minus that width; beyond it
    the sum rounds, and the second rounding can then differ from a true
    FMA only when it lands exactly on a float32 midpoint (a chance near
    2**-29 per call).  ``tests/test_torch_engine.py`` holds the result
    against exact rational arithmetic.
    """
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    return (c.double() + a.double() * b.double()).float()


def pool_params(pool: ExpertPool, run_caps=None, wait_caps=None, up=None,
                k_scale=None, admit_min=None) -> torch.Tensor:
    """The (..., N, PAR_CH) float32 parameter pack (``PAR_*`` order).
    ``up``/``admit_min``/``k_scale`` may carry a leading env axis (B, N);
    absent caps use the ``PAR_CAP_FREE`` sentinel, absent ``up`` is all
    up, absent ``admit_min`` is no floor (-1e30)."""
    k1, k2 = pool.k1, pool.k2
    dev = k1.device

    def chan(x, absent):
        if x is None:
            return torch.full_like(k1, absent)
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        x = np.asarray(x, np.float32)          # static data: copied once
        return constant(x.ravel(), torch.float32, dev).reshape(x.shape)

    if k_scale is not None:
        k1, k2 = k1 * chan(k_scale, 1.0), k2 * chan(k_scale, 1.0)
    chans = [k1, k2, pool.mem_capacity, pool.mem_per_token,
             chan(run_caps, PAR_CAP_FREE), chan(wait_caps, PAR_CAP_FREE),
             chan(up, 1.0), chan(admit_min, -INF)]
    chans = torch.broadcast_tensors(*chans)
    return torch.stack(chans, dim=-1)


def admit_sort_key(wait_f: torch.Tensor, admit_order: str,
                   latency_L: float = 0.0) -> torch.Tensor:
    """The (..., W) key an admission MINIMIZES over live waiters."""
    t_arr, pred_s = wait_f[..., WF_T_ARRIVE], wait_f[..., WF_PRED_S]
    if admit_order == "fifo":
        return t_arr
    if admit_order == "qos":
        return -pred_s
    if admit_order == "edf":
        return fma_f32(latency_L, wait_f[..., WF_PRED_D], t_arr)
    return QOS_AGE_BETA * t_arr - pred_s


def advance_shard(run_i: torch.Tensor, run_f: torch.Tensor,
                  wait_i: torch.Tensor, wait_f: torch.Tensor,
                  par: torch.Tensor, clocks: torch.Tensor,
                  t_next: torch.Tensor, *, latency_L: float,
                  admit_order: str = "fifo", counts: Optional[dict] = None):
    """Advance every row (one expert of one env) until its clock reaches
    its ``t_next`` or it runs out of work.  Row-flattened operands:
    run_i/run_f (M, R, 5), wait_i/wait_f (M, W, 4), par (M, PAR_CH),
    clocks and t_next (M,).  Inputs are not modified.  With ``counts``,
    ``counts["turns"]`` grows by the number of row turns taken (one
    admit, decode or idle action each): the work this input needs.

    Returns (run_i, run_f, wait_valid (M, W) int32, clocks (M,),
    acc (M, 6) in ``ACC_KEYS`` order) — the CUDA kernel's contract."""
    if admit_order not in ADMIT_ORDERS:
        raise ValueError(f"unknown admit_order {admit_order!r}")
    m, r_cap, _ = run_i.shape
    w_cap = wait_i.shape[1]
    dev = run_i.device
    k1, k2 = par[:, PAR_K1], par[:, PAR_K2]
    cap, mpt = par[:, PAR_MEM_CAP], par[:, PAR_MPT]
    r_iota = torch.arange(r_cap, device=dev)
    w_iota = torch.arange(w_cap, device=dev)
    run_ok = r_iota < par[:, PAR_RUN_CAP].to(torch.int32)[:, None]
    wait_ok = w_iota < par[:, PAR_WAIT_CAP].to(torch.int32)[:, None]
    upv = par[:, PAR_UP] > 0.5
    # the wait side is loop-invariant except its valid bit
    w_key = admit_sort_key(wait_f, admit_order, latency_L)
    w_pick = wait_ok & (wait_f[..., WF_PRED_S] >= par[:, PAR_ADMIT_MIN, None])

    out_ri, out_rf = run_i.clone(), run_f.clone()
    out_wv = wait_i[..., WI_VALID] > 0
    out_clk = clocks.clone()
    out_acc = torch.zeros((m, len(ACC_KEYS)), dtype=torch.float32, device=dev)

    def has_work(ri, wv):
        return (ri[..., RI_VALID] > 0).any(-1) | wv.any(-1)

    # The working set: the rows still active, with the state they carry and
    # the per-row constants they read.  A row leaves it (and is written
    # back) when its clock reaches t_next or it runs out of work.
    idx = torch.nonzero((clocks < t_next) & has_work(run_i, out_wv))[:, 0]
    state = [out_ri[idx], out_rf[idx], out_wv[idx], out_clk[idx],
             out_acc[idx]]
    consts = [idx, torch.stack([k1, k2, mpt, cap, t_next], -1)[idx],
              upv[idx], run_ok[idx], w_key[idx], w_pick[idx], wait_i[idx],
              wait_f[idx]]
    while consts[0].numel():
        if counts is not None:
            counts["turns"] = counts.get("turns", 0) + consts[0].numel()
        ri, rf, wv, clk, acc = state
        idx, cst, up, r_ok, key, pick, wi, wf = consts
        kk1, kk2, mp, cp, tn = cst.unbind(-1)
        rows = torch.arange(idx.numel(), device=dev)
        valid = ri[..., RI_VALID] > 0
        p, d_true, d_cur = ri[..., RI_P], ri[..., RI_D_TRUE], ri[..., RI_D_CUR]
        tokens = torch.where(valid, p + d_cur, 0).sum(-1).to(torch.float32)

        live = wv & pick
        w_idx = torch.argmin(torch.where(live, key, INF), dim=-1)
        blocked = valid | ~r_ok
        r_free = torch.argmin(blocked.to(torch.uint8), dim=-1)
        head_i, head_f = wi[rows, w_idx], wf[rows, w_idx]  # (m, 4) each
        head_p = head_i[:, WI_P].to(torch.float32)
        fits = fma_f32(tokens, mp, mp * (head_p + 1.0)) <= cp
        adm = live.any(-1) & ~blocked.all(-1) & fits & up
        dec = ~adm & valid.any(-1) & up
        # admit: clock += k1 * p;  decode: clock += k2 * tokens
        clk_new = fma_f32(torch.where(adm, kk1, kk2),
                          torch.where(adm, head_p, tokens), clk)

        # decode: finished requests leave and add to the accumulator
        dec_rows = dec[:, None] & valid
        d_new = d_cur + dec_rows.to(torch.int32)
        finished = dec_rows & (d_new >= d_true)
        lat = (clk_new[:, None] - rf[..., RF_T_ARRIVE]) / torch.clamp(
            d_true.to(torch.float32), min=1.0)
        ok = lat <= latency_L                       # compared in float32
        score = rf[..., RF_SCORE]
        per_slot = torch.stack([                           # ACC_KEYS order
            torch.where(ok, score, 0.0), lat, score,
            rf[..., RF_T_ADMIT] - rf[..., RF_T_ARRIVE],
            torch.ones_like(lat), (~ok).to(torch.float32)], dim=-1)
        acc = acc + (finished.to(torch.float32)[..., None] * per_slot).sum(1)

        # admit: the chosen waiter goes into the first free live run slot.
        # An admitted waiter is valid, so its valid channel also supplies
        # the new slot's valid bit and its first decoded token (d_cur = 1).
        slot = adm[:, None] & (r_iota == r_free[:, None])
        adm_i = head_i[:, [WI_VALID, WI_P, WI_D_TRUE, WI_VALID, WI_RETRY]]
        kept = ri.clone()
        kept[..., RI_VALID] = (valid & ~finished).to(torch.int32)
        kept[..., RI_D_CUR] = d_new
        ri = torch.where(slot[..., None], adm_i[:, None, :], kept)
        adm_f = torch.cat([head_f[:, [WF_SCORE, WF_PRED_S, WF_PRED_D,
                                      WF_T_ARRIVE]], clk[:, None]], dim=-1)
        rf = torch.where(slot[..., None], adm_f[:, None, :], rf)
        wv = wv & ~(adm[:, None] & (w_iota == w_idx[:, None]))
        clk = torch.where(adm | dec, clk_new, tn)           # else idle

        state = [ri, rf, wv, clk, acc]
        still = (clk < tn) & has_work(ri, wv)
        if not bool(still.all()):
            gone = idx[~still]
            for out, x in zip((out_ri, out_rf, out_wv, out_clk, out_acc),
                              state):
                out[gone] = x[~still]
            state = [x[still] for x in state]
            consts = [x[still] for x in consts]

    run_i, run_f, wvalid, clocks, acc = (out_ri, out_rf, out_wv, out_clk,
                                         out_acc)
    clocks = torch.maximum(clocks, t_next)
    return run_i, run_f, wvalid.to(torch.int32), clocks, acc


def _advance_rows(backend: str, args, *, latency_L: float, admit_order: str):
    """``advance_shard``'s contract on the row-flattened ``args``, by the
    kernel (``"cuda"``) or the plain loop (``"torch"``)."""
    if backend == "cuda":
        from repro_torch.kernels.lockstep_advance.ops import lockstep_advance
        return lockstep_advance(*args, latency_L=latency_L,
                                admit_order=admit_order)
    return advance_shard(*args, latency_L=latency_L, admit_order=admit_order)


def _advance_sharded(args, n: int, *, mesh, shard_body: str,
                     latency_L: float, admit_order: str, local: bool):
    """The ``"shard"`` backend on the row-flattened ``args`` of envs of
    ``n`` experts each (env-major; this rank's ``n / k`` of each with
    ``local``): this rank's block of experts of every env through
    ``shard_body``, then one all-gather of the accumulators over the
    ``expert`` axis.  Returns ``advance_shard``'s contract with the queue
    rows and clocks of this rank's block (every block, gathered, without
    ``local``) and the accumulators of all N, env-major."""
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import mesh as mesh_lib

    if shard_body not in SHARD_BODIES:
        raise ValueError(f"unknown shard_body {shard_body!r}")
    if mesh is None:
        mesh_lib.init_world(args[0].device)
        mesh = mesh_lib.make_expert_mesh()
    k = sharding.axis_size(mesh, sharding.EXPERT)
    n_all = n * k if local else n
    if n_all % k != 0:
        raise ValueError(
            f"n_experts={n_all} not divisible by mesh axis "
            f"'{sharding.EXPERT}'={k}")
    b = args[0].shape[0] // n
    group = mesh.get_group(sharding.EXPERT)
    blocks = lambda xs: [x.reshape((b, -1) + tuple(x.shape[1:])) for x in xs]
    rows = lambda xs: [x.reshape((-1,) + tuple(x.shape[2:])) for x in xs]
    if not local:
        mine = sharding.expert_rows(mesh, n_all)
        # (B, N, ...) -> this rank's (B, N/k, ...) -> rows
        args = rows([x[:, mine].contiguous() for x in blocks(args)])
    *out, acc = _advance_rows(shard_body, args, latency_L=latency_L,
                              admit_order=admit_order)
    acc = collectives.gather_blocks(blocks([acc]), group,
                                    reader="accumulators")[0]
    if not local:
        out = rows(collectives.gather_blocks(blocks(out), group,
                                             reader="caller"))
    return (*out, acc.reshape(-1, len(ACC_KEYS)))


def advance_all(pool: ExpertPool, latency_L: float, queues: dict,
                clocks: torch.Tensor, t_next, *, backend: Optional[str] = None,
                admit_order: str = "fifo", run_caps=None, wait_caps=None,
                up=None, k_scale=None, admit_min=None,
                par: Optional[torch.Tensor] = None, mesh=None,
                shard_body: Optional[str] = None, local: bool = False
                ) -> Tuple[dict, torch.Tensor, dict]:
    """Advance every expert of every env to ``t_next`` (module docstring).

    ``queues`` is (B, N, ...) with ``clocks (B, N)`` or row-flattened
    (M = B*N, ...) with ``clocks (M,)``, env-major; ``t_next`` is per row,
    (B,) per env with (B, N) clocks, or a scalar.  ``run_caps``/
    ``wait_caps`` (N,) bound each expert's live slots; ``up`` (N,) or
    (B, N) marks available experts, ``k_scale``
    scales k1/k2, ``admit_min`` defers waiters whose pred_s is below it.
    ``par`` is those channels already packed by ``pool_params``, (N,
    PAR_CH) or one row per queue row: a fleet whose channels do not change
    builds it once instead of on every call.  ``mesh`` and ``shard_body``
    serve the ``"shard"`` backend, which splits the last axis of
    ``clocks`` (N; one env when ``clocks`` is (N,)); with ``local`` the
    queues, clocks and ``par`` are already this rank's block of that axis
    (``sharding.expert_rows``) and stay so.

    Returns (queues, clocks, acc) in the input's shapes, acc a dict of
    ``ACC_KEYS`` each shaped like ``clocks`` (with ``local``, like the
    clocks of every expert: the block's axis times the mesh axis)."""
    if admit_order not in ADMIT_ORDERS:
        raise ValueError(f"unknown admit_order {admit_order!r}; "
                         f"expected one of {ADMIT_ORDERS}")
    on_cuda = clocks.is_cuda
    if backend is None:
        backend = "cuda" if on_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown engine backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not on_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; "
                         "use backend='torch' on the CPU")
    lead = clocks.shape
    m = clocks.numel()
    r_cap, w_cap = queues["run_i"].shape[-2], queues["wait_i"].shape[-2]
    t_next = torch.as_tensor(t_next, dtype=torch.float32, device=clocks.device)
    if clocks.dim() == 2 and t_next.dim() == 1:
        t_next = t_next[:, None]                           # per env
    if par is None:
        par = pool_params(pool, run_caps, wait_caps, up, k_scale, admit_min)
    elif any(x is not None for x in (run_caps, wait_caps, up, k_scale,
                                     admit_min)):
        raise ValueError("pass either par or the channels it packs")
    par = par.reshape(-1, PAR_CH)
    if par.shape[0] != m:                                  # tile over envs
        par = par.repeat(m // par.shape[0], 1)
    args = [queues["run_i"].reshape(m, r_cap, RUN_I_CH).contiguous(),
            queues["run_f"].reshape(m, r_cap, RUN_F_CH).contiguous(),
            queues["wait_i"].reshape(m, w_cap, WAIT_I_CH).contiguous(),
            queues["wait_f"].reshape(m, w_cap, WAIT_F_CH).contiguous(),
            par,
            clocks.reshape(m).contiguous(),
            t_next.expand(lead).reshape(m).contiguous()]
    if backend == "shard":
        if shard_body is None:
            shard_body = "cuda" if on_cuda else "torch"
        out = _advance_sharded(args, lead[-1], mesh=mesh,
                               shard_body=shard_body, latency_L=latency_L,
                               admit_order=admit_order, local=local)
    elif local:
        raise ValueError("local=True is the 'shard' backend's")
    else:
        out = _advance_rows(backend, args, latency_L=latency_L,
                            admit_order=admit_order)
    run_i, run_f, wvalid, new_clocks, acc = out
    wait_i = queues["wait_i"].clone()
    wait_i[..., WI_VALID] = wvalid.reshape(wait_i.shape[:-1])
    queues = {"run_i": run_i.reshape(queues["run_i"].shape),
              "run_f": run_f.reshape(queues["run_f"].shape),
              "wait_i": wait_i, "wait_f": queues["wait_f"]}
    acc_shape = lead[:-1] + (acc.shape[0] // max(m // lead[-1], 1),)
    acc = {k: acc[:, i].reshape(acc_shape) for i, k in enumerate(ACC_KEYS)}
    return queues, new_clocks.reshape(lead), acc
