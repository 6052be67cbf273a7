"""AdamW with float32 moments and Adafactor with a factored second moment
(port of ``repro/train/optimizer.py``), updating parameters in place.

``lr_schedule`` is linear warmup then cosine decay to a floor of 0.1 of
the peak; gradients are clipped by their global norm and keep their own
dtype (a bf16 gradient is rounded after clipping, as in the reference);
weight decay applies to parameters of two or more dimensions only.  Both
optimizers keep float32 state and update a bf16 parameter through float32,
rounding back once.  The step count is a device tensor (``.step``) that the
learning rate, the bias corrections and Adafactor's ``beta2`` read on the
device, so a CUDA graph of an update uses the step it holds at each replay.

Parameters come as ``name -> tensor``, or ``name -> list of tensors`` for
a leaf that the reference stacks over layers (``models.io.reference_groups``
gives an LM's leaves so).  A list counts as one leaf of one more dimension,
as the reference's stacked array does: its weight decay and Adafactor's
factoring and RMS clipping follow the stacked shape (a stack of per-layer
norms is a matrix to the reference), and its state is stacked too.

    opt = make_optimizer("adafactor", peak_lr=3e-4)(params)
    stats = opt.update(grads)          # grads in the order of opt.tensors()

On a mesh the parameters are a rank's blocks (``models.io.ShardedLM``'s
``leaves``, which are the tensors its model computes with: there is no
whole copy to update) and ``layout`` (the ``ShardedLM``: its ``mesh``, and
per leaf its ``specs`` and whole ``shapes``) says how each is split; the
gradients come as the blocks' (reduce-scattered over the data axes, or
summed over them where those do not split the block).  AdamW's
moments split as their leaves, so its update is elementwise on the blocks.
The global norm counts every element once: each tensor's sum of squares
is added by the ranks that hold its block at coordinate 0 on every axis
its spec does not split, then summed over the mesh.  Adafactor factors by
the whole shape; its row and column means, the mean of its row statistic
and its RMS clip sum over the axes that split the dims they span, and its
factored moments are stored split as the reference's ``state_specs``
splits them (``param_spec`` of the moment's own shape), gathered and cut
where that differs from the leaf's split; an unfactored second moment
splits as its leaf.  A leaf whose block departs from ``param_spec``
(RWKV6's ``wk``/``wv``/``wo``, ``sharding.block_spec``) so keeps AdamW's
moments and Adafactor's unfactored one as its blocks, and the factored
ones by ``param_spec``, relaid from the block.  On one rank, or where
nothing is split, each update is the unsharded one, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Sequence, Union

import torch

from repro_torch.distributed import collectives, sharding

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(prog, 0.0, 1.0)))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm,
                                     0.1 + 0.9 * cos)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    sq = [torch.square(x.to(torch.float32)).sum() for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * scale).to(x.dtype)


def clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float):
    """(tensors scaled by ``min(1, max_norm / norm)`` in float32 and
    returned in their own dtype, norm)."""
    norm = global_norm(tensors)
    scale = _clip_scale(norm, max_norm)
    return [_clip(x, scale) for x in tensors], norm


def _members(leaf: Leaf) -> List[torch.Tensor]:
    return [leaf] if isinstance(leaf, torch.Tensor) else list(leaf)


def _stacked(leaf: Leaf) -> bool:
    return not isinstance(leaf, torch.Tensor)


def _shape(leaf: Leaf) -> tuple:
    """The reference's shape of a leaf: a list is a stack over layers."""
    if _stacked(leaf):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _zeros(shape, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=dev)


class _Optimizer:
    """The parameters (``params``: name -> leaf), the step and the
    gradient clipping both optimizers share; ``layout`` for a mesh's
    blocks (module docstring)."""

    def __init__(self, params: Dict[str, Leaf], cfg: OptimizerConfig,
                 layout=None):
        self.cfg = cfg
        self.params = dict(params)
        self.layout = layout
        self.device = _members(next(iter(self.params.values())))[0].device
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._owner = None

    def _owns(self, k: str) -> bool:
        """Whether this rank adds leaf ``k``'s block to the global norm:
        its coordinate is 0 on every axis the leaf's spec does not
        split."""
        mesh = self.layout.mesh
        used = {a for e in self.layout.specs[k] for a in sharding.spec_axes(e)}
        return all(sharding.axis_index(mesh, a) == 0
                   for a in sharding.mesh_shape(mesh) if a not in used)

    def _global_norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        if self.layout is None:
            return global_norm(tensors)
        if self._owner is None:
            self._owner = torch.tensor(
                [float(self._owns(k)) for k, leaf in self.params.items()
                 for _ in _members(leaf)], device=self.device)
        sq = torch.stack([torch.square(x.to(torch.float32)).sum()
                          for x in tensors]) * self._owner
        mesh = self.layout.mesh
        collectives.sum_over(sq, mesh, tuple(sharding.mesh_shape(mesh)),
                             reader="optimizer")
        return torch.sqrt(sq.sum())

    def _spec(self, k: str, n_dims: int) -> tuple:
        return (self.layout.specs[k] if self.layout is not None
                else (None,) * n_dims)

    def _mean(self, x, dim: int, entry, n: int, keepdim: bool = False):
        """The mean over dim ``dim`` (``n`` long whole, split by spec entry
        ``entry``)."""
        axes = sharding.spec_axes(entry)
        if not axes:
            return x.mean(dim, keepdim=keepdim)
        t = x.sum(dim, keepdim=keepdim)
        collectives.sum_over(t, self.layout.mesh, axes, reader="optimizer")
        return t / n

    def _relayout(self, x, src: tuple, dst: tuple):
        """``x``, this rank's block by spec ``src``, as its block by
        ``dst``."""
        if tuple(src) == tuple(dst):
            return x
        mesh = self.layout.mesh
        whole = collectives.gather_spec(x, src, mesh, reader="optimizer")
        return sharding.local_shard(whole, dst, mesh).clone()

    def moment_spec(self, k: str, shape: tuple) -> tuple:
        """The spec of leaf ``k``'s state of ``shape`` (the reference's
        ``state_specs``: ``param_spec`` of that shape)."""
        if self.layout is None:
            return (None,) * len(shape)
        return sharding.param_spec(k, shape, self.layout.mesh, train=True)

    def _whole_shape(self, k: str, leaf: Leaf) -> tuple:
        return (tuple(self.layout.shapes[k]) if self.layout is not None
                else _shape(leaf))

    def _zeros(self, k: str, shape: tuple) -> torch.Tensor:
        """Zeros for leaf ``k``'s state of whole ``shape``: this rank's
        block by ``moment_spec``."""
        if self.layout is not None:
            shape = sharding.local_shape(shape, self.moment_spec(k, shape),
                                         self.layout.mesh)
        return _zeros(shape, self.device)

    def tensors(self) -> List[torch.Tensor]:
        """Every parameter tensor, in the order ``update`` takes grads."""
        return [t for leaf in self.params.values() for t in _members(leaf)]

    def _clipped(self, grads):
        """({name: that leaf's grads}, the global norm, a function that
        clips one gradient, the lr).  A list of grads is emptied, so each
        gradient is freed once its leaf is updated; each is clipped as
        ``clip_by_global_norm`` clips it, when its leaf is updated."""
        flat = list(grads)
        if isinstance(grads, list):
            grads.clear()
        norm = self._global_norm(flat)
        scale = _clip_scale(norm, self.cfg.grad_clip)
        clip = lambda x: _clip(x, scale)
        out, i = {}, 0
        for k, leaf in self.params.items():
            n = len(_members(leaf))
            out[k], i = flat[i:i + n], i + n
        del flat
        return out, norm, clip, lr_schedule(self.cfg, self.step)

    def state(self) -> Dict[str, torch.Tensor]:
        """The optimizer state in the reference's tree, keys joined by
        ``/`` (``m/<leaf>``, ``v/<leaf>/vr``, ...): a stacked leaf's state
        is one stacked tensor, as the reference keeps it."""
        raise NotImplementedError

    def state_specs(self) -> Dict[str, tuple]:
        """The spec of each ``state()`` entry (a rank's block of it)."""
        raise NotImplementedError


class AdamW(_Optimizer):
    """AdamW over ``params``, moments ``m``/``v`` by the same names in
    float32 (a stacked leaf's moments stacked), ``step`` an int32 device
    scalar."""

    def __init__(self, params: Dict[str, Leaf], cfg: OptimizerConfig,
                 layout=None):
        super().__init__(params, cfg, layout)
        self.m = {k: _zeros(_shape(p), self.device)
                  for k, p in self.params.items()}
        self.v = {k: _zeros(_shape(p), self.device)
                  for k, p in self.params.items()}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> dict:
        """One step with ``grads`` in the order of ``tensors()``, in place
        (a list of grads is emptied); returns ``{"grad_norm", "lr"}``
        (device scalars)."""
        cfg = self.cfg
        grads, gnorm, clip, lr = self._clipped(grads)
        t = (self.step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        for k, leaf in self.params.items():
            decay = len(_shape(leaf)) >= 2            # decay matrices only
            stacked = _stacked(leaf)
            members = grads.pop(k)
            for i, p in enumerate(_members(leaf)):
                m = self.m[k][i] if stacked else self.m[k]
                v = self.v[k][i] if stacked else self.v[k]
                g = clip(members[i]).to(torch.float32)
                members[i] = None
                m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
                v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
                delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                if decay:
                    delta = delta + cfg.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return {"grad_norm": gnorm, "lr": lr}

    def state(self) -> Dict[str, torch.Tensor]:
        return {**{f"m/{k}": x for k, x in self.m.items()},
                **{f"v/{k}": x for k, x in self.v.items()}}

    def state_specs(self) -> Dict[str, tuple]:
        return {f"{part}/{k}": self._spec(k, x.dim())
                for part, moments in (("m", self.m), ("v", self.v))
                for k, x in moments.items()}


def _factored(shape: tuple) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= 2


def _stack(ts: List[torch.Tensor]) -> torch.Tensor:
    """A leaf's members as its stacked tensor: a view for a stack of one."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(ts)


class Adafactor(_Optimizer):
    """Adafactor without momentum: for a leaf whose last two dimensions are
    both at least 2, the second moment is kept factored as row and column
    means (``vr``, ``vc``), else whole (``v``); ``beta2 = 1 - t^-0.8``;
    updates are divided by their RMS when it exceeds 1.  A stacked leaf is
    updated as one tensor (its factoring and RMS span the stack), each
    other leaf alone."""

    def __init__(self, params: Dict[str, Leaf], cfg: OptimizerConfig,
                 layout=None):
        super().__init__(params, cfg, layout)
        self.v = {}
        for k, leaf in self.params.items():
            s = self._whole_shape(k, leaf)
            self.v[k] = ({"vr": self._zeros(k, s[:-1]),
                          "vc": self._zeros(k, s[:-2] + s[-1:])}
                         if _factored(s) else {"v": _zeros(_shape(leaf),
                                                           self.device)})

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> dict:
        """One step with ``grads`` in the order of ``tensors()``, in place
        (a list of grads is emptied); returns ``{"grad_norm", "lr"}``
        (device scalars)."""
        cfg = self.cfg
        grads, gnorm, clip, lr = self._clipped(grads)
        t = (self.step + 1).to(torch.float32)
        beta2 = 1.0 - torch.pow(t, -cfg.decay_rate)
        for k, leaf in self.params.items():
            stacked = _stacked(leaf)
            members = _members(leaf)
            g = [clip(x) for x in grads.pop(k)]
            g = (_stack(g) if stacked else g[0]).to(torch.float32)
            s = self._whole_shape(k, leaf)
            S = self._spec(k, len(s))
            g2 = torch.square(g) + 1e-30
            v = self.v[k]
            if "vr" in v:
                rows, cols = S[:-1], S[:-2] + S[-1:]
                r_spec = self.moment_spec(k, s[:-1])
                c_spec = self.moment_spec(k, s[:-2] + s[-1:])
                r = self._relayout(self._mean(g2, -1, S[-1], s[-1]), rows,
                                   r_spec)
                c = self._relayout(self._mean(g2, -2, S[-2], s[-2]), cols,
                                   c_spec)
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * r)
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * c)
                del g2, r, c
                vr = self._relayout(v["vr"], r_spec, rows)
                vc = self._relayout(v["vc"], c_spec, cols)
                denom = torch.clamp(self._mean(vr, -1, S[-2], s[-2],
                                               keepdim=True), min=1e-30)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
                del g2
                vhat = v["v"]
            delta = g / (torch.sqrt(vhat) + 1e-30)
            del g, vhat
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(self._mean_all(torch.square(delta), S, s)
                             + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            p = _stack(members) if stacked else members[0]
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new = (p.to(torch.float32) - lr * delta).to(p.dtype)
            del delta
            if stacked:
                for i, m in enumerate(members):
                    m.copy_(new[i])
            else:
                p.copy_(new)
        return {"grad_norm": gnorm, "lr": lr}

    def _mean_all(self, x, spec: tuple, shape: tuple):
        """The mean of every element of a leaf split by ``spec``."""
        axes = tuple(a for e in spec for a in sharding.spec_axes(e))
        if not axes:
            return x.mean()
        t = x.sum()
        collectives.sum_over(t, self.layout.mesh, axes, reader="optimizer")
        return t / math.prod(shape)

    def state(self) -> Dict[str, torch.Tensor]:
        return {f"v/{k}/{part}": x for k, v in self.v.items()
                for part, x in v.items()}

    def state_specs(self) -> Dict[str, tuple]:
        out = {}
        for k, leaf in self.params.items():
            s = self._whole_shape(k, leaf)
            for part, x in self.v[k].items():
                out[f"v/{k}/{part}"] = (
                    self._spec(k, len(s)) if part == "v" else
                    self.moment_spec(k, s[:-1] if part == "vr"
                                     else s[:-2] + s[-1:]))
        return out


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(name: str, **kw) -> Callable[..., _Optimizer]:
    """The optimizer ``name`` (``adamw`` or ``adafactor``) with the
    ``OptimizerConfig`` fields ``kw``, as a function of the parameters and
    a mesh's ``layout`` (the reference's ``opt.init``)."""
    if name not in OPTIMIZERS:
        raise ValueError(name)
    cfg = OptimizerConfig(**kw)
    return lambda params, layout=None: OPTIMIZERS[name](params, cfg, layout)
