"""The activation-sharding hook (port of ``repro/distributed/api.py``).

A step runs its model under ``use_mesh_policy(policy)``; model code asks
``current_policy()`` for the mesh (the MoE layer goes expert-parallel on
it, ``models/moe.py``; the loss sums its normaliser over it,
``models/model.py``).  ``MeshPolicy`` maps logical activation axes to mesh
axes, with the reference's rules (``distributed.sharding.activation_rules``).

``model_parallel(policy)`` is what a layer split over ``model`` reads of
the policy: the mesh, the axis's size and this rank's index on it.
``batch_axes(policy)`` are the axes that split a step's rows (the rules'
``"batch"``: every data axis unless the step's batch does not divide,
``distributed.sharding.batch_axes``); the data axes outside them hold the
same rows (``replicas``).

``constrain(x, *logical_axes)`` is the reference's layout hint: there a
``with_sharding_constraint`` that tells GSPMD where an activation should
live, with no effect on its values.  Here each rank holds its own rows
explicitly, so there is nothing to hint, and ``constrain`` returns ``x``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

_state = threading.local()


class MeshPolicy:
    """Maps logical activation axes -> mesh axes (or None)."""

    def __init__(self, mesh, rules: dict):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, logical_axes) -> tuple:
        """The mesh axes of each logical axis, as a spec tuple (one axis by
        its name, as a ``PartitionSpec`` holds it)."""
        one = lambda a: a[0] if isinstance(a, tuple) and len(a) == 1 else a
        return tuple(one(self.rules.get(a)) for a in logical_axes)


def current_policy() -> Optional[MeshPolicy]:
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def use_mesh_policy(policy: Optional[MeshPolicy]):
    """``policy`` for this thread inside the block (``None`` for none);
    the one before it comes back on exit, so blocks nest."""
    prev = getattr(_state, "policy", None)
    _state.policy = policy
    try:
        yield
    finally:
        _state.policy = prev


def model_parallel(policy: Optional[MeshPolicy]
                   ) -> Optional[Tuple[object, int, int]]:
    """(mesh, size of its ``model`` axis, this rank's index on it) under
    ``policy`` when that axis is larger than 1, else None."""
    from repro_torch.distributed import sharding

    if policy is None:
        return None
    m = sharding.axis_size(policy.mesh, "model")
    if m == 1:
        return None
    return policy.mesh, m, sharding.axis_index(policy.mesh, "model")


def batch_axes(policy: Optional[MeshPolicy]) -> Tuple[str, ...]:
    """The mesh axes that split the rows of a step under ``policy``."""
    if policy is None:
        return ()
    from repro_torch.distributed import sharding

    axes = policy.rules.get("batch", sharding.data_axes(policy.mesh))
    return () if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))


def replicas(policy: Optional[MeshPolicy]) -> int:
    """How many ranks of the data axes hold each row under ``policy``: the
    product of the data axes outside ``batch_axes``."""
    if policy is None:
        return 1
    from repro_torch.distributed import sharding

    split = batch_axes(policy)
    return math.prod(sharding.axis_size(policy.mesh, a)
                     for a in sharding.data_axes(policy.mesh)
                     if a not in split)


def constrain(x, *logical_axes: Optional[str]):
    """``x`` unchanged (module docstring): a rank's shard is explicit."""
    return x
