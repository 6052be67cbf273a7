"""Where router training's tensors live on a mesh (port of the router half
of ``repro/distributed/sharding.py``).

A mesh is a ``DeviceMesh`` of ``launch.mesh`` with an ``expert`` axis and,
for training, perhaps a ``data`` axis.  The reference names a
``PartitionSpec`` for each array and lets XLA place the shards; here each
rank holds its own shard, and these helpers say which rows are its own:

  * the engine's expert axis: a ``(B, N, ...)`` queue tensor splits on N
    into one block of ``N / k`` experts per rank of the ``expert`` axis
    (``expert_rows``);
  * the replay buffer: every transition tensor splits on its capacity
    axis over ``expert``; ``ptr``, ``size`` and ``capacity`` are global
    on every rank (``replay_specs``, ``shard_replay_buffer``);
  * the collect batch: on a 2-D mesh the envs split over ``data``
    (``data_shards``).

The LM rules (``param_spec``, ``cache_spec``, ``activation_rules``,
``batch_axes``, ``data_spec``) belong to the LM trainer, ROADMAP queue A
item 5.
"""
from __future__ import annotations

import torch

EXPERT = "expert"  # scheduling-engine expert axis (edge-expert fleet)
DATA = "data"      # collect-batch (env) axis of the 2-D training mesh


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh or the axis)."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return 1 if axis not in names else mesh.size(names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh or the axis)."""
    return 0 if axis_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


def expert_rows(mesh, n_experts: int) -> slice:
    """This rank's block of the engine's N experts: the ``expert`` axis
    splits them when it is larger than 1 and divides N, else every rank
    holds all N (the reference's ``expert_spec``)."""
    k = axis_size(mesh, EXPERT)
    if k > 1 and n_experts % k == 0:
        per = n_experts // k
        i = axis_index(mesh, EXPERT)
        return slice(i * per, (i + 1) * per)
    return slice(0, n_experts)


def replay_shards(mesh, capacity: int) -> int:
    """Number of capacity-axis shards the replay buffer splits into on this
    mesh: the size of the ``expert`` axis.  Raises when the capacity does
    not divide evenly; silent padding would break the ring-pointer
    arithmetic's bit-identity with the single-device buffer."""
    if mesh is None or EXPERT not in (mesh.mesh_dim_names or ()):
        return 1
    n = axis_size(mesh, EXPERT)
    if capacity % n != 0:
        raise ValueError(
            f"buffer_capacity={capacity} not divisible by mesh axis "
            f"'{EXPERT}'={n}")
    return n


def data_shards(mesh, n_envs: int) -> int:
    """Number of collect-batch shards on this mesh: the size of the
    ``data`` axis of a 2-D training mesh, 1 without it.  Raises when the
    env count does not divide evenly."""
    if mesh is None or DATA not in (mesh.mesh_dim_names or ()):
        return 1
    n = axis_size(mesh, DATA)
    if n_envs % n != 0:
        raise ValueError(
            f"n_envs={n_envs} not divisible by mesh axis '{DATA}'={n}")
    return n


def replay_specs() -> dict:
    """The axis each replay-buffer entry's first dimension splits over:
    every transition tensor (each ``obs``/``next_obs`` leaf too) on the
    capacity axis over ``expert``; ``None`` for the ring scalars, which
    every rank holds whole so that all agree on the global cursor."""
    return {"obs": EXPERT, "next_obs": EXPERT, "action": EXPERT,
            "reward": EXPERT, "discount": EXPERT,
            "ptr": None, "size": None, "capacity": None}


def shard_replay_buffer(buf: dict, mesh) -> dict:
    """This rank's part of a fresh buffer of ``replay.init``: rows
    ``[i * cap / n, (i + 1) * cap / n)`` of every transition tensor for
    shard ``i``, this rank's ``expert`` coordinate, copied into storage of
    their own, and copies of the ring scalars.  ``capacity`` stays the
    global capacity."""
    n = replay_shards(mesh, int(buf["capacity"]))
    if n == 1:
        return buf
    i = axis_index(mesh, EXPERT)
    per = buf["capacity"] // n
    rows = lambda x: x[i * per:(i + 1) * per].clone()
    out = {}
    for k, axis in replay_specs().items():
        x = buf[k]
        if axis is None:
            out[k] = x.clone() if isinstance(x, torch.Tensor) else x
        elif isinstance(x, dict):
            out[k] = {name: rows(leaf) for name, leaf in x.items()}
        else:
            out[k] = rows(x)
    return out
