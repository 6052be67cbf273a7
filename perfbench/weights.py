"""The cell's weights: drawn by the benchmark from ``--seed`` and handed to
both the program and the reference.

The program's model is built empty on the meta device; its leaves (name,
shape, dtype) say what to draw.  All leaves of one dtype are drawn in one
call into one flat buffer on the device, in the dtype they are served in,
each leaf's view starting on a 256-byte boundary (as a fresh allocation
would, which the kernels' tensor-map loads ask of their operands), then
each view is scaled to its own standard deviation and bound to the
program's model as its parameter.  The draw is deterministic on the
device, so the reference takes a second draw from the same seed once the
program's model is freed: nothing the program held or could have
altered in place reaches it.

Scales: fan-in ``1/sqrt(n_in)`` for every projection (the attention and
FFN output projections also ``1/sqrt(2 n_layers)``), 1 for the embedding,
0.1 for the norms' weights (used as ``1 + w``, so a norm that ignored its
weight would show).  Random weights are enough for speed and for
agreement with the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from perfbench.traffic import seed_bits

ALIGN_BYTES = 256


def std_of(name: str, shape: Tuple[int, ...], n_layers: int) -> float:
    leaf = name.rsplit(".", 1)[-1]
    out = 1.0 / math.sqrt(2 * n_layers)
    moe = ".moe." in name
    if leaf == "embed":
        return 1.0
    if leaf.endswith("norm"):
        return 0.1
    if leaf in ("wq", "wk", "wv", "lm_head", "router"):
        return 1.0 / math.sqrt(shape[0])
    if leaf in ("w_gate", "w_up"):
        return 1.0 / math.sqrt(shape[1] if moe else shape[0])
    if leaf == "w_down":
        return out / math.sqrt(shape[1] if moe else shape[0])
    if leaf == "wo":
        return out / math.sqrt(shape[0] * shape[1])
    if leaf.startswith("b"):
        return 0.02
    raise ValueError(f"no scale for the leaf {name!r}")


def draw(leaves: List[Tuple[str, Tuple[int, ...], torch.dtype]], n_layers: int,
         seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor for every leaf, from one ``torch.Generator`` on
    ``device`` seeded with ``seed``: one draw per dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({d for _, _, d in leaves}, key=str):
        group = [(n, s) for n, s, d in leaves if d == dtype]
        align = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        offsets, total = [], 0
        for _, shape in group:
            offsets.append(total)
            total += -(-math.prod(shape) // align) * align
        flat = torch.randn((total,), generator=gen, device=device,
                           dtype=dtype)
        for (name, shape), off in zip(group, offsets):
            view = flat[off:off + math.prod(shape)].view(shape)
            view.mul_(std_of(name, shape, n_layers))
            out[name] = view
    return out


def leaves(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every parameter of ``model``."""
    return [(n, tuple(p.shape), p.dtype) for n, p in model.named_parameters()]


def build(cfg, seed: int, device) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """The program's model of ``cfg`` (a ``repro_torch`` ``ModelConfig``)
    holding the drawn weights, and those weights by name."""
    from repro_torch.models.io import empty_model

    model = empty_model(cfg, "meta")
    weights = draw(leaves(model), cfg.n_layers, seed, torch.device(device))
    for name, tensor in weights.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(tensor, requires_grad=False)
    return model, weights
