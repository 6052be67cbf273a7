"""Heterogeneous graph attention network (HAN) state abstraction (§V-B2),
port of ``repro/core/han.py`` as an ``nn.Module``.

Node types {arrived request, expert, running request, waiting request};
each layer does masked multi-head GAT aggregation per meta-path, then
semantic attention over the meta-path embeddings.  Paper config: 2 layers,
4 heads, hidden 64.

Weights keep the reference's ``(in, out)`` orientation (``x @ w``) and its
parameter tree (``proj_expert``, ``layers.<i>.e_run.w``, ...), so carrying
weights across is a rename (``core.io.sac_params_from_numpy``).

Both observation layouts are batched over a leading env axis:

  * ``forward``          — padded ``run (B, N, R, F)`` / ``wait``;
  * ``forward_segments`` — the edge list ``req (B, E, F)``; node-level
    attention is a segment softmax over each request row's expert id,
    offset by ``b * N`` so one scatter covers every env.  On CUDA the
    segment sums (``index_add_``) add in atomic order, so results there are
    held to a tolerance, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.features import EXP_FEATS, REQ_FEATS
from repro_torch.device import constant


@dataclasses.dataclass(frozen=True)
class HANConfig:
    hidden: int = 64
    heads: int = 4
    layers: int = 2
    leaky_slope: float = 0.2


def _glorot(gen: torch.Generator, *shape) -> nn.Parameter:
    fan = sum(shape[-2:]) if len(shape) >= 2 else shape[-1] * 2
    return nn.Parameter(torch.randn(shape, generator=gen) * (2.0 / fan) ** 0.5)


class GAT(nn.Module):
    """One node-level attention head-set for a meta-path."""

    def __init__(self, cfg: HANConfig, gen: torch.Generator):
        super().__init__()
        d, h = cfg.hidden, cfg.heads
        self.cfg = cfg
        self.w = _glorot(gen, d, d)
        self.a_src = _glorot(gen, h, d // h)
        self.a_dst = _glorot(gen, h, d // h)

    def forward(self, target, neigh, mask):
        """target (..., D); neigh (..., M, D); mask (..., M) -> (..., D)."""
        cfg = self.cfg
        h, dh = cfg.heads, cfg.hidden // cfg.heads
        tgt_h = (target @ self.w).reshape(*target.shape[:-1], h, dh)
        nb_h = (neigh @ self.w).reshape(*neigh.shape[:-1], h, dh)
        s_dst = torch.einsum("...hd,hd->...h", tgt_h, self.a_dst)
        s_src = torch.einsum("...mhd,hd->...mh", nb_h, self.a_src)
        e = F.leaky_relu(s_src + s_dst[..., None, :], cfg.leaky_slope)
        e = torch.where(mask[..., None], e, -1e9)
        alpha = torch.softmax(e, dim=-2)                    # over M
        alpha = torch.where(mask[..., None], alpha, 0.0)
        out = torch.einsum("...mh,...mhd->...hd", alpha, nb_h)
        return F.elu(out.reshape(*target.shape[:-1], cfg.hidden))

    def forward_segments(self, target, neigh, seg, mask):
        """Segment-softmax form: target (S, D); neigh (E, D) grouped by the
        target ids ``seg (E,)``; mask (E,) -> (S, D)."""
        cfg = self.cfg
        h, dh = cfg.heads, cfg.hidden // cfg.heads
        n_seg = target.shape[0]
        tgt_h = (target @ self.w).reshape(-1, h, dh)
        nb_h = (neigh @ self.w).reshape(-1, h, dh)
        s_dst = torch.einsum("nhd,hd->nh", tgt_h, self.a_dst)
        s_src = torch.einsum("ehd,hd->eh", nb_h, self.a_src)
        e = F.leaky_relu(s_src + s_dst[seg], cfg.leaky_slope)
        e = torch.where(mask[:, None], e, -1e9)
        idx = seg[:, None].expand_as(e)
        m = torch.full((n_seg, h), -torch.inf, dtype=e.dtype,
                       device=e.device).scatter_reduce(
            0, idx, e, "amax", include_self=False)
        ex = torch.exp(e - m[seg])
        denom = torch.zeros((n_seg, h), dtype=e.dtype,
                            device=e.device).index_add_(0, seg, ex)
        alpha = torch.where(mask[:, None], ex / denom[seg], 0.0)
        out = torch.zeros((n_seg, h, dh), dtype=e.dtype,
                          device=e.device).index_add_(
            0, seg, alpha[..., None] * nb_h)
        return F.elu(out.reshape(-1, cfg.hidden))


class Semantic(nn.Module):
    """Semantic attention over meta-path embeddings (..., P, D) -> (..., D)."""

    def __init__(self, cfg: HANConfig, gen: torch.Generator):
        super().__init__()
        self.w = _glorot(gen, cfg.hidden, cfg.hidden)
        self.b = nn.Parameter(torch.zeros(cfg.hidden))
        self.q = _glorot(gen, cfg.hidden)

    def forward(self, embeds):
        w = torch.einsum("...pd,d->...p",
                         torch.tanh(embeds @ self.w + self.b), self.q)
        beta = torch.softmax(w, dim=-1)
        return torch.einsum("...p,...pd->...d", beta, embeds)


class HANLayer(nn.Module):
    def __init__(self, cfg: HANConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.hidden
        # expert <- {self, running, waiting}
        self.e_run = GAT(cfg, gen)
        self.e_wait = GAT(cfg, gen)
        self.e_self = _glorot(gen, d, d)
        self.e_sem = Semantic(cfg, gen)
        # arrived <- {self, experts}
        self.a_exp = GAT(cfg, gen)
        self.a_self = _glorot(gen, d, d)
        self.a_sem = Semantic(cfg, gen)
        # request nodes <- {self, their expert}
        self.r_exp = _glorot(gen, d, d)
        self.r_self = _glorot(gen, d, d)

    def arrived(self, exp_h, arr_h):
        ones = torch.ones(exp_h.shape[:-1], dtype=torch.bool,
                          device=exp_h.device)
        a_exp = self.a_exp(arr_h, exp_h, ones)
        a_self = F.elu(arr_h @ self.a_self)
        return self.a_sem(torch.stack([a_self, a_exp], dim=-2))


class HAN(nn.Module):
    """Returns (arrived embedding (B, D), expert embeddings (B, N, D))."""

    def __init__(self, cfg: HANConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.proj_expert = _glorot(gen, EXP_FEATS, cfg.hidden)
        self.proj_req = _glorot(gen, REQ_FEATS, cfg.hidden)
        self.proj_arrived = _glorot(gen, REQ_FEATS, cfg.hidden)
        self.layers = nn.ModuleList(HANLayer(cfg, gen)
                                    for _ in range(cfg.layers))

    def forward(self, obs: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        exp_h = torch.tanh(obs["expert"] @ self.proj_expert)   # (B, N, D)
        run_h = torch.tanh(obs["run"] @ self.proj_req)         # (B, N, R, D)
        wait_h = torch.tanh(obs["wait"] @ self.proj_req)
        arr_h = torch.tanh(obs["arrived"] @ self.proj_arrived)  # (B, D)
        run_mask, wait_mask = obs["run_mask"], obs["wait_mask"]
        for lp in self.layers:
            e_run = lp.e_run(exp_h, run_h, run_mask)
            e_wait = lp.e_wait(exp_h, wait_h, wait_mask)
            e_self = F.elu(exp_h @ lp.e_self)
            exp_new = lp.e_sem(torch.stack([e_self, e_run, e_wait], dim=-2))
            arr_new = lp.arrived(exp_h, arr_h)
            pull = (exp_h @ lp.r_exp)[..., None, :]
            run_new = F.elu(run_h @ lp.r_self + pull)
            wait_new = F.elu(wait_h @ lp.r_self + pull)
            exp_h, arr_h, run_h, wait_h = exp_new, arr_new, run_new, wait_new
        return arr_h, exp_h

    def forward_segments(self, obs: dict, *, n_run: int, run_caps=None,
                         wait_caps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` over the segment layout: ``req (B, E, F)`` with run
        edges in rows [0, n_run)."""
        b, n = obs["expert"].shape[:2]
        e_rows = obs["req"].shape[1]
        dev = obs["req"].device
        caps = lambda c: None if c is None else tuple(c)
        seg = constant((n, n_run, e_rows, caps(run_caps), caps(wait_caps)),
                       torch.int64, dev, make=_segment_ids)
        offs = (torch.arange(b, device=dev) * n)[:, None]
        seg_run = (seg[:n_run][None] + offs).reshape(-1)   # env b -> b*N + n
        seg_wait = (seg[n_run:][None] + offs).reshape(-1)
        seg_all = (seg[None] + offs).reshape(-1)
        mask = obs["req_mask"]
        mask_run = mask[:, :n_run].reshape(-1)
        mask_wait = mask[:, n_run:].reshape(-1)

        d = self.cfg.hidden
        exp_h = torch.tanh(obs["expert"] @ self.proj_expert)   # (B, N, D)
        req_h = torch.tanh(obs["req"] @ self.proj_req)         # (B, E, D)
        arr_h = torch.tanh(obs["arrived"] @ self.proj_arrived)
        for lp in self.layers:
            flat_exp = exp_h.reshape(b * n, d)
            e_run = lp.e_run.forward_segments(
                flat_exp, req_h[:, :n_run].reshape(-1, d), seg_run, mask_run)
            e_wait = lp.e_wait.forward_segments(
                flat_exp, req_h[:, n_run:].reshape(-1, d), seg_wait,
                mask_wait)
            e_self = F.elu(exp_h @ lp.e_self)
            exp_new = lp.e_sem(torch.stack(
                [e_self, e_run.reshape(b, n, d), e_wait.reshape(b, n, d)],
                dim=-2))
            arr_new = lp.arrived(exp_h, arr_h)
            pull = (flat_exp @ lp.r_exp)[seg_all].reshape(b, e_rows, d)
            req_new = F.elu(req_h @ lp.r_self + pull)
            exp_h, arr_h, req_h = exp_new, arr_new, req_new
        return arr_h, exp_h


def _segment_ids(n_experts, n_run, n_req, run_caps, wait_caps):
    return segment_ids(n_experts, n_run, n_req, run_caps=run_caps,
                       wait_caps=wait_caps)


def segment_ids(n_experts: int, n_run: int, n_req: int, *, run_caps=None,
                wait_caps=None) -> torch.Tensor:
    """Expert id per request row of the segment layout (run rows [0, n_run)
    then wait rows, both expert-major), as an int64 CPU tensor."""
    if run_caps is not None or wait_caps is not None:
        rc = np.asarray(run_caps if run_caps is not None
                        else (n_run // n_experts,) * n_experts, np.int64)
        wc = np.asarray(wait_caps if wait_caps is not None
                        else ((n_req - n_run) // n_experts,) * n_experts,
                        np.int64)
        if int(rc.sum()) != n_run or int(rc.sum() + wc.sum()) != n_req:
            raise ValueError(
                f"ragged caps (sum run={int(rc.sum())}, wait="
                f"{int(wc.sum())}) do not match the segment layout "
                f"(n_run={n_run}, n_req={n_req})")
    else:
        r, w = n_run // n_experts, (n_req - n_run) // n_experts
        if r * n_experts != n_run or w * n_experts != n_req - n_run:
            raise ValueError(
                f"segment rows (n_run={n_run}, n_req={n_req}) do not split "
                f"uniformly over {n_experts} experts; ragged fleets must "
                f"pass run_caps/wait_caps")
        rc = np.full(n_experts, r, np.int64)
        wc = np.full(n_experts, w, np.int64)
    ar = np.arange(n_experts)
    return torch.as_tensor(np.concatenate([np.repeat(ar, rc),
                                           np.repeat(ar, wc)]))
