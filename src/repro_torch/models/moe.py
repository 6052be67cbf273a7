"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch
(port of ``repro/models/moe.py``, its local path).

Tokens are routed to their top-k experts, scattered into per-expert
capacity buffers ``(E, C, d)`` (an assignment past an expert's capacity is
dropped, as in GShard), run through the expert FFN and combined with their
gates.  The expert FFN is the grouped SwiGLU kernel (B4b) followed by the
grouped GEMM kernel (B4a), ``kernels/moe_gemm/ops.py``; on the CPU their
plain versions.  B4b keeps ``x@wg`` and ``x@wu`` in float32 up to one
rounding, where the reference's einsum chain rounds them to the activation
dtype first; at float32 the two agree to rounding.

Training (``moe_block(..., train=True)``) runs the reference's expert
FFN, three einsums, under autograd, since the kernels have no backward.
Its dispatch and combine are gathers through a static row table (which
assignment fills each buffer row), so their backward passes add each
gradient row once and never meet in an atomic add: a step is the same bit
for bit however often it runs, eagerly or from a CUDA graph.

The reference's expert-parallel ``_moe_sharded`` (shard_map over a
``model`` axis) belongs to the LM model mesh, ROADMAP queue A item 5;
``moe_block`` is the local path.  Nothing here synchronises with the host: dispatch and combine are
index arithmetic on the device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm.ops import expert_gemm, expert_swiglu


class MoE(nn.Module):
    """One MoE layer's parameters, with the reference's names and shapes:
    ``router (d, E)`` in float32, ``w_gate``/``w_up (E, d, f)`` and
    ``w_down (E, f, d)`` in the parameter dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        new = lambda *shape, dt=dtype: nn.Parameter(
            torch.empty(shape, dtype=dt, device=device), requires_grad=False)
        self.router = new(d, e, dt=torch.float32)
        self.w_gate = new(e, d, f)
        self.w_up = new(e, d, f)
        self.w_down = new(e, f, d)


def route_topk(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T, k) float32 normalised, expert ids (T, k) int32,
    probs).  Equal probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` breaks ties (a stable descending sort; ``torch.topk``
    promises no order for ties)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gates, ids.to(torch.int32), probs


def _slot_in_expert(expert_ids_flat: torch.Tensor, n_experts: int
                    ) -> torch.Tensor:
    """slot[i] = the number of earlier assignments to the same expert: the
    run position within a stable sort by expert id."""
    a = expert_ids_flat.shape[0]
    dev = expert_ids_flat.device
    ids = expert_ids_flat.long()
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    experts = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(sorted_ids, experts)          # run starts
    slots_sorted = torch.arange(a, device=dev) - starts[sorted_ids]
    slot = torch.empty_like(slots_sorted)
    slot[order] = slots_sorted
    return slot.to(torch.int32)


def _capacity(T: int, cfg) -> int:
    c = int(max(cfg.top_k, (T * cfg.top_k * cfg.capacity_factor) / cfg.n_experts))
    return max(8, (c + 127) // 128 * 128) if T >= 1024 else c


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, e: int) -> torch.Tensor:
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0].long(), e).float().mean(dim=0)
    return e * (me * ce).sum()


def _expert_ffn(xin: torch.Tensor, p: MoE) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): B4b then B4a."""
    return expert_gemm(expert_swiglu(xin, p.w_gate, p.w_up), p.w_down)


def _expert_ffn_einsum(xin: torch.Tensor, p: MoE) -> torch.Tensor:
    """The reference's ``_expert_ffn``: (E, C, d) -> (E, C, d), each
    einsum rounded to the activation dtype, differentiable."""
    h = torch.einsum("ecd,edf->ecf", xin, p.w_gate)
    u = torch.einsum("ecd,edf->ecf", xin, p.w_up)
    return torch.einsum("ecf,efd->ecd", F.silu(h) * u, p.w_down)


def _moe_local(p: MoE, x: torch.Tensor, cfg, train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    capacity = _capacity(T, cfg)

    logits = x.float() @ p.router
    gates, ids, probs = route_topk(logits, k)
    aux = _aux_loss(probs, ids, e)

    ids_flat = ids.reshape(-1).long()
    gates_flat = gates.reshape(-1)
    slot = _slot_in_expert(ids_flat, e).long()
    keep = slot < capacity

    # row e*C + slot of a flat buffer with one spare row at the end, where
    # the dropped assignments land (the reference's mode="drop" at index C)
    # and from which they read 0 (its mode="fill")
    spare = e * capacity
    dest = torch.where(keep, ids_flat * capacity + slot, spare)
    if train:
        # assignment a = token a // k; src[r] = the assignment in row r,
        # or T*k, a zero row (a kept row has one assignment)
        xk = torch.cat([x[:, None].expand(T, k, d).reshape(T * k, d),
                        x.new_zeros((1, d))])
        src = torch.full((spare + 1,), T * k, dtype=torch.long,
                         device=x.device)
        src[dest] = torch.arange(T * k, device=x.device)
        y = _expert_ffn_einsum(xk[src[:spare]].view(e, capacity, d), p)
    else:
        token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
        buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = x[token_idx]
        y = _expert_ffn(buf[:spare].view(e, capacity, d), p)
    y = torch.cat([y.reshape(spare, d), y.new_zeros((1, d))])
    y_tok = y[dest]
    w = (gates_flat * keep.float())[:, None].to(y_tok.dtype)
    y_tok = (y_tok * w).view(T, k, d)
    # the reference's zeros((T, d)).at[token_idx].add(y_tok): the k
    # assignments of a token added in order, each add rounded to the dtype
    out = y_tok[:, 0]
    for j in range(1, k):
        out = out + y_tok[:, j]
    return out.to(x.dtype), aux


def moe_block(p: MoE, x: torch.Tensor, cfg, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) token-major -> (out (T, d), aux loss scalar); ``train``
    runs the einsum FFN under autograd (module docstring)."""
    return _moe_local(p, x, cfg, train)
