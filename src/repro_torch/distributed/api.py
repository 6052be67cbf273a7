"""The activation-sharding hook (port of ``repro/distributed/api.py``).

A step runs its model under ``use_mesh_policy(policy)``; model code asks
``current_policy()`` for the mesh (the MoE layer goes expert-parallel on
it, ``models/moe.py``; the loss sums its normaliser over it,
``models/model.py``).  ``MeshPolicy`` maps logical activation axes to mesh
axes, with the reference's rules (``distributed.sharding.activation_rules``).

``constrain(x, *logical_axes)`` is the reference's layout hint: there a
``with_sharding_constraint`` that tells GSPMD where an activation should
live, with no effect on its values.  Here each rank holds its own rows
explicitly, so there is nothing to hint, and ``constrain`` returns ``x``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

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


def constrain(x, *logical_axes: Optional[str]):
    """``x`` unchanged (module docstring): a rank's shard is explicit."""
    return x
