"""Fixed-capacity replay buffer (port of ``repro/core/replay.py``): static
tensors on the device, updated in place.

The reference donates its buffer to the jitted iteration so inserts update
it in place; here the buffer's tensors keep their storage for the whole
run (a CUDA graph of the collect step writes into them), ``add_batch``
writes with ``index_copy_`` at ``(ptr + arange(n)) % capacity``, and
``ptr``/``size`` are int32 scalars on the device: nothing reads them on
the host.  ``sample`` draws its indices on the device against the
``size`` tensor, so a replayed graph samples from what the buffer holds
at that moment.

The capacity-sharded bodies (``shard_add_batch``, ``shard_sample_local``)
belong to sharded training and are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve


def init(capacity: int, obs_example: Dict, device=None) -> dict:
    """An empty buffer of ``capacity`` transitions shaped like
    ``obs_example`` (one observation, no env axis), on ``device`` (the
    CUDA device by default)."""
    dev = resolve(device)
    zeros = lambda x: torch.zeros((capacity,) + tuple(x.shape),
                                  dtype=x.dtype, device=dev)
    scalar = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "obs": {k: zeros(x) for k, x in obs_example.items()},
        "next_obs": {k: zeros(x) for k, x in obs_example.items()},
        "action": torch.zeros((capacity,), dtype=torch.int32, device=dev),
        "reward": torch.zeros((capacity,), dtype=torch.float32, device=dev),
        "discount": torch.zeros((capacity,), dtype=torch.float32, device=dev),
        "ptr": scalar(),
        "size": scalar(),
        "capacity": capacity,
    }


def add_batch(buf: dict, obs, action, reward, discount, next_obs) -> None:
    """Insert a batch of ``n`` transitions in place (a ring)."""
    cap = buf["capacity"]
    n = action.shape[0]
    idx = (buf["ptr"].long() + torch.arange(n, device=action.device)) % cap
    for side, src in (("obs", obs), ("next_obs", next_obs)):
        for k, dst in buf[side].items():
            dst.index_copy_(0, idx, src[k])
    buf["action"].index_copy_(0, idx, action.to(torch.int32))
    buf["reward"].index_copy_(0, idx, reward.to(torch.float32))
    buf["discount"].index_copy_(0, idx, discount.to(torch.float32))
    buf["ptr"].copy_((buf["ptr"] + n) % cap)
    buf["size"].copy_(torch.clamp(buf["size"] + n, max=cap))


def sample(buf: dict, gen: Optional[torch.Generator], batch_size: int,
           idx: Optional[torch.Tensor] = None) -> Dict:
    """``batch_size`` transitions at indices drawn uniformly from
    ``[0, max(size, 1))`` on the device with ``gen`` (a 62-bit draw
    reduced mod the size), or at the given ``idx``."""
    if idx is None:
        dev = buf["action"].device
        high = torch.clamp(buf["size"], min=1).long()
        idx = torch.randint(0, 2 ** 62, (batch_size,), generator=gen,
                            device=dev) % high
    idx = idx.long()
    take = lambda x: x[idx]
    return {
        "obs": {k: take(x) for k, x in buf["obs"].items()},
        "next_obs": {k: take(x) for k, x in buf["next_obs"].items()},
        "action": take(buf["action"]),
        "reward": take(buf["reward"]),
        "discount": take(buf["discount"]),
    }
