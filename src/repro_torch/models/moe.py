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

Under a ``MeshPolicy`` (``distributed/api.py``) each rank holds its rows
of tokens.  With a ``model`` axis larger than 1, ``moe_block`` runs the
reference's expert-parallel ``_moe_sharded``: every (data, model) rank
routes its tokens, keeps the assignments to its ``E / model`` experts
within a capacity of ``_capacity(T / n_data)`` (``moe_plan``), runs them
through its experts (B4b then B4a when serving) and adds its partial
output, in ``cfg.moe_psum_dtype``, to the other model ranks' by one
all-reduce; ``aux`` is the mean over the data axes.  The rank's part is
``moe_shard_body``, apart from the collectives, so one process can run
every rank's and sum them.  Where the reference falls back to
``_moe_local`` on all tokens (``E % model`` or ``T % n_data`` non-zero),
and under a policy whose ``model`` axis is 1 (where the reference runs
``_moe_local`` on every data rank's tokens), ``_moe_data_parallel`` runs
that function on this rank's tokens: only the routing counts and the
router probabilities' sums cross the data axes.  In training the
combine's backward hands every model rank the output's gradient
unchanged, and the gradients of the tokens and gates that the model ranks
each used for part of the sum are summed over ``model``
(``collectives.sum_forward``, ``sum_backward``).  The layer's tokens are
the same on every ``model`` rank: the attention before it (split over
``model``, ``models/transformer.py``) ends in an all-reduce.  In training
the expert weights' blocks, split over the data axes, are gathered at
their use (``collectives.at_use``).  Nothing here synchronises with the
host: dispatch and combine are index arithmetic on the device.
"""
from __future__ import annotations

import math
import types
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import batch_axes, current_policy
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


def _dispatch_ffn(p, x, experts, slot, keep, n_e: int, capacity: int,
                  train: bool) -> torch.Tensor:
    """Assignment a (token a // k) into row ``experts[a] * capacity +
    slot[a]`` of ``n_e`` capacity buffers where ``keep[a]``, through the
    expert FFN of ``p``'s ``n_e`` experts; returns each assignment's
    output row (T*k, d), 0 where not kept."""
    T, d = x.shape
    k = experts.shape[0] // T
    # row e*C + slot of a flat buffer with one spare row at the end, where
    # the dropped assignments land (the reference's mode="drop" at index C)
    # and from which they read 0 (its mode="fill")
    spare = n_e * capacity
    dest = torch.where(keep, experts * capacity + slot, spare)
    if train:
        # assignment a = token a // k; src[r] = the assignment in row r,
        # or T*k, a zero row (a kept row has one assignment)
        xk = torch.cat([x[:, None].expand(T, k, d).reshape(T * k, d),
                        x.new_zeros((1, d))])
        src = torch.full((spare + 1,), T * k, dtype=torch.long,
                         device=x.device)
        src[dest] = torch.arange(T * k, device=x.device)
        y = _expert_ffn_einsum(xk[src[:spare]].view(n_e, capacity, d), p)
    else:
        token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
        buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = x[token_idx]
        y = _expert_ffn(buf[:spare].view(n_e, capacity, d), p)
    y = torch.cat([y.reshape(spare, d), y.new_zeros((1, d))])
    return y[dest]


def _combine(y_tok, gates_flat, keep, T: int, k: int, acc_dtype):
    """Each token's k outputs weighted by their gates (0 where not kept)
    and added in order in ``acc_dtype`` (the reference's zeros((T, d),
    acc).at[token_idx].add(y_tok.astype(acc)))."""
    w = (gates_flat * keep.float())[:, None].to(y_tok.dtype)
    y_tok = (y_tok * w).view(T, k, -1)
    out = y_tok[:, 0].to(acc_dtype)
    for j in range(1, k):
        out = out + y_tok[:, j].to(acc_dtype)
    return out


def _moe_local(p: MoE, x: torch.Tensor, cfg, train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    capacity = _capacity(T, cfg)

    logits = x.float() @ p.router
    gates, ids, probs = route_topk(logits, k)
    aux = _aux_loss(probs, ids, e)

    ids_flat = ids.reshape(-1).long()
    slot = _slot_in_expert(ids_flat, e).long()
    keep = slot < capacity
    y_tok = _dispatch_ffn(p, x, ids_flat, slot, keep, e, capacity, train)
    out = _combine(y_tok, gates.reshape(-1), keep, T, k, y_tok.dtype)
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Under a mesh policy
# ---------------------------------------------------------------------------


def moe_plan(cfg, t_global: int, n_data: int, model: int
             ) -> Optional[Tuple[int, int]]:
    """(experts a model rank holds, its capacity) of ``_moe_sharded`` for
    ``t_global`` tokens on ``n_data`` x ``model`` ranks, or None where the
    reference falls back to ``_moe_local`` (``E % model`` or ``T %
    n_data`` non-zero)."""
    if cfg.n_experts % model != 0 or t_global % n_data != 0:
        return None
    return cfg.n_experts // model, _capacity(t_global // n_data, cfg)


def local_experts(p, m_idx: int, e_local: int):
    """Model rank ``m_idx``'s experts of ``p``: ``p`` itself when it holds
    ``e_local`` (a ``ShardedLM``'s model), else its block of all E."""
    if p.w_gate.shape[0] == e_local:
        return p
    cut = lambda w: w[m_idx * e_local:(m_idx + 1) * e_local]
    return types.SimpleNamespace(w_gate=cut(p.w_gate), w_up=cut(p.w_up),
                                 w_down=cut(p.w_down))


def moe_shard_body(w, x, gates, ids, cfg, m_idx: int, e_local: int,
                   cap_local: int, train: bool = False) -> torch.Tensor:
    """One (data, model) rank's part of ``_moe_sharded`` (the reference's
    ``local_fn`` between its collectives): its tokens ``x`` (T, d) routed
    (``gates``, ``ids`` (T, k)), the assignments to its experts
    ``[m_idx * e_local, (m_idx + 1) * e_local)`` (``w``, those experts'
    weights) that fit ``cap_local`` through them, combined with their
    gates; returns the partial output (T, d) in ``cfg.moe_psum_dtype``,
    which the model ranks sum."""
    T = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    ids_flat = ids.reshape(-1).long()
    slot = _slot_in_expert(ids_flat, e).long()
    keep = slot < cap_local
    local_e = ids_flat - m_idx * e_local
    mine = (local_e >= 0) & (local_e < e_local) & keep
    y_tok = _dispatch_ffn(w, x, local_e, slot, mine, e_local, cap_local,
                          train)
    return _combine(y_tok, gates.reshape(-1), mine, T, k,
                    getattr(torch, cfg.moe_psum_dtype))


def _moe_sharded(p, x: torch.Tensor, cfg, mesh, train: bool = False,
                 baxes=None, seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel MoE on ``mesh`` (module docstring);
    ``x`` (T, d) is this rank's tokens, split over the data axes
    ``baxes`` (every one by default; the others hold the same tokens).
    Under the sequence split ``seq`` (``collectives.SeqSplit``) ``x`` and
    the output are this rank's rows (B, S/m, d) of its sequences: the
    tokens are gathered whole and routed as without the split (the
    routing's gradient reaching each rank's rows once,
    ``SeqSplit.own_grads``), and the partial outputs are reduce-scattered
    into the rows in place of the all-reduce."""
    dtype, d = x.dtype, x.shape[-1]
    T = x.shape[0] if seq is None else x.shape[0] * seq.n
    shape = sharding.mesh_shape(mesh)
    daxes = sharding.data_axes(mesh)
    baxes = daxes if baxes is None else baxes
    n_data = math.prod(shape[a] for a in baxes)
    plan = moe_plan(cfg, T * n_data, n_data, shape["model"])
    if plan is None:
        if seq is None:
            return _moe_data_parallel(p, x, cfg, mesh, train, baxes)
        b = x.shape[0]
        out, aux = _moe_data_parallel(
            p, seq.gather(x, whole=True).reshape(T, d), cfg, mesh, train,
            baxes)
        return seq.rows(out.reshape(b, seq.n, d)), aux
    e_local, cap_local = plan
    m_idx = sharding.axis_index(mesh, "model")
    route = x
    if seq is not None:
        b = x.shape[0]
        full = seq.gather(x)
        route, x = seq.own_grads(full).reshape(T, d), full.reshape(T, d)
    gates, ids, probs = route_topk(route.float() @ p.router, cfg.top_k)
    aux = collectives.data_mean(_aux_loss(probs, ids, cfg.n_experts), mesh,
                                daxes, reader="moe_aux")
    if train:
        if seq is None:
            x = collectives.sum_backward(x, mesh, ("model",),
                                         reader="moe_grads")
        gates = collectives.sum_backward(gates, mesh, ("model",),
                                         reader="moe_grads")
    partial = moe_shard_body(local_experts(p, m_idx, e_local), x, gates,
                             ids, cfg, m_idx, e_local, cap_local, train)
    if seq is not None:
        return seq.scatter(partial.reshape(b, seq.n, d)).to(dtype), aux
    out = collectives.sum_forward(partial, mesh, ("model",),
                                  reader="moe_combine")
    return out.to(dtype), aux


def _moe_data_parallel(p, x: torch.Tensor, cfg, mesh, train: bool = False,
                       baxes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_local`` of every data rank's tokens at once, this rank's
    rows of it (``p`` holds all E experts), computed from this rank's
    tokens: the expert FFN acts row by row, so only the routing needs the
    other ranks.  Their per-expert assignment counts and top-1 counts are
    gathered over the data axes (2E words a rank, reader
    ``"moe_counts"``); an assignment's slot among all of them is its slot
    here plus the earlier ranks' count of its expert, and it is kept below
    the capacity of all ``T * n_data`` tokens.  The kept ones fill
    buffers of ``min(capacity, T)`` rows an expert by their slot here (a
    token meets an expert once).  ``aux`` is the reference's over every
    token: the router probabilities' sums added over the data axes
    (reader ``"moe_aux"``) with their gradient handed back unchanged, so
    each rank's share of it reaches its own loss once.  The data axes
    outside ``baxes`` (which split the tokens; every one by default) hold
    the same tokens: the counts and sums cross ``baxes`` only, and the
    probabilities' gradient is divided among those copies."""
    daxes = sharding.data_axes(mesh)
    baxes = daxes if baxes is None else baxes
    i, n = sharding.block_index(mesh, baxes)
    T = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    capacity = _capacity(T * n, cfg)
    gates, ids, probs = route_topk(x.float() @ p.router, k)
    ids_flat = ids.reshape(-1).long()
    slot = _slot_in_expert(ids_flat, e).long()
    counts = torch.zeros((1, 2 * e), dtype=torch.int32, device=x.device)
    counts.scatter_add_(1, torch.cat([ids_flat, ids[:, 0].long() + e])[None],
                        torch.ones((1, T * k + T), dtype=torch.int32,
                                   device=x.device))
    for a in reversed(baxes):
        counts = collectives.gather_cat(counts, mesh.get_group(a), dim=0,
                                        reader="moe_counts")
    before = counts[:i, :e].sum(0)
    keep = slot + before[ids_flat] < capacity
    y_tok = _dispatch_ffn(p, x, ids_flat, slot, keep, e, min(capacity, T),
                          train)
    out = _combine(y_tok, gates.reshape(-1), keep, T, k, y_tok.dtype)
    me = collectives.sum_forward(probs.sum(0), mesh, baxes,
                                 reader="moe_aux")
    copies = tuple(a for a in daxes if a not in baxes)
    if copies:
        me = collectives.data_mean(me, mesh, copies, reader="moe_aux")
    me = me / (T * n)
    ce = counts[:, e:].sum(0).float() / (T * n)
    return out.to(x.dtype), e * (me * ce).sum()


def moe_block(p: MoE, x: torch.Tensor, cfg, train: bool = False, seq=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) token-major -> (out (T, d), aux loss scalar); ``train``
    runs the einsum FFN under autograd (module docstring).  Under a mesh
    policy: ``_moe_sharded`` when its ``model`` axis is larger than 1
    (under the sequence split ``seq``, x and out the rank's rows (B, S/m,
    d)), else ``_moe_data_parallel`` when it has more than one data rank;
    the expert weights that training splits over the data axes are
    gathered at their use (``collectives.at_use``)."""
    p = collectives.layer_weights(p, ("router", "w_gate", "w_up", "w_down"))
    policy = current_policy()
    if policy is not None:
        shape = sharding.mesh_shape(policy.mesh)
        baxes = batch_axes(policy)
        if shape.get("model", 1) > 1:
            return _moe_sharded(p, x, cfg, policy.mesh, train, baxes, seq)
        if math.prod(shape[a] for a in sharding.data_axes(policy.mesh)) > 1:
            return _moe_data_parallel(p, x, cfg, policy.mesh, train, baxes)
    return _moe_local(p, x, cfg, train)
