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

Capacity sharding: on a mesh with an ``expert`` axis
(``launch.mesh.make_train_mesh``) shard ``i`` of ``S`` holds global rows
``[i*cap/S, (i+1)*cap/S)`` of every transition tensor, and ``ptr``/``size``
are global on every rank (``distributed.sharding.replay_specs``).
``shard_add_batch`` and ``shard_sample_local`` are the per-shard bodies of
``training.make_iteration(mesh=...)``:

  * insert: each shard writes the transitions whose global ring row it
    holds, so the union of the shards is ``add_batch`` on the unsharded
    buffer, bit for bit;
  * sample: every shard draws the same global indices (the same generator
    state and ``size``), gathers the rows it holds and gives exact zeros
    for the rest; the sum over the shards (one ``all_reduce``) is
    ``sample`` on the unsharded buffer, bit for bit, since each row has
    one owner.

Both are functions of the local shard and ``(shard_idx, n_shards)`` with
static shapes and no host sync, so a CUDA graph replays them, and
``tests/test_torch_distributed.py`` holds them against the reference's
bodies in one process.
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
    return _take(buf, _indices(buf, gen, batch_size, idx), lambda x: x)


def _indices(buf: dict, gen, batch_size: int, idx) -> torch.Tensor:
    """``idx``, or ``batch_size`` indices drawn against the ``size``."""
    if idx is None:
        dev = buf["action"].device
        high = torch.clamp(buf["size"], min=1).long()
        idx = torch.randint(0, 2 ** 62, (batch_size,), generator=gen,
                            device=dev) % high
    return idx.long()


def _take(buf: dict, idx: torch.Tensor, keep) -> Dict:
    take = lambda x: keep(x[idx])
    return {
        "obs": {k: take(x) for k, x in buf["obs"].items()},
        "next_obs": {k: take(x) for k, x in buf["next_obs"].items()},
        "action": take(buf["action"]),
        "reward": take(buf["reward"]),
        "discount": take(buf["discount"]),
    }


# ---------------------------------------------------------------------------
# Capacity-sharded bodies (see the module docstring)
# ---------------------------------------------------------------------------


def shard_add_batch(buf: dict, obs, action, reward, discount, next_obs, *,
                    shard_idx: int, n_shards: int) -> None:
    """Per-shard ring insert of ``n`` transitions, in place.  The global
    capacity is ``n_shards`` times the local rows, never read from
    ``buf["capacity"]``.

    Transition ``k`` goes to global row ``g = (ptr + k) % cap``.  Every
    ``k`` writes, by one ``index_copy_``, local row ``t = g % cap_local``
    with the value that row must end with: the transition whose global row
    is this shard's row ``t``, if this insert has one, else the row's old
    value.  Rows written twice (only when ``n > cap_local``) get the same
    value from both writes, so the order of writes does not matter, and the
    shapes stay static (no subset whose size depends on ``ptr``)."""
    n = action.shape[0]
    cap_local = buf["action"].shape[0]
    cap = cap_local * n_shards
    ptr = buf["ptr"].long()
    g = (ptr + torch.arange(n, device=action.device)) % cap
    tgt = g % cap_local
    src = (shard_idx * cap_local + tgt - ptr) % cap    # who writes row tgt
    mine = src < n
    src = torch.where(mine, src, 0)

    def put(dst, x):
        m = mine.reshape((n,) + (1,) * (dst.dim() - 1))
        dst.index_copy_(0, tgt, torch.where(m, x[src].to(dst.dtype),
                                            dst[tgt]))

    for side, tree in (("obs", obs), ("next_obs", next_obs)):
        for k, dst in buf[side].items():
            put(dst, tree[k])
    put(buf["action"], action)
    put(buf["reward"], reward)
    put(buf["discount"], discount)
    buf["ptr"].copy_((buf["ptr"] + n) % cap)
    buf["size"].copy_(torch.clamp(buf["size"] + n, max=cap))


def shard_sample_local(buf: dict, gen: Optional[torch.Generator],
                       batch_size: int, *, shard_idx: int, n_shards: int,
                       idx: Optional[torch.Tensor] = None) -> Dict:
    """This shard's additive part of a global ``sample``: the rows it holds
    gathered, exact zeros (of each tensor's dtype) for the rest.  The
    indices are drawn as ``sample`` draws them (or given as ``idx``), so
    every shard draws the same ones."""
    idx = _indices(buf, gen, batch_size, idx)
    cap_local = buf["action"].shape[0]
    local = idx - shard_idx * cap_local
    hit = (local >= 0) & (local < cap_local)

    def keep(v):
        m = hit.reshape(hit.shape + (1,) * (v.dim() - 1))
        return torch.where(m, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))

    return _take(buf, torch.where(hit, local, 0), keep)
