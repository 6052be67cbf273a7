"""Fault tolerance and elasticity (port of
``repro/distributed/fault_tolerance.py``).

* ``StragglerDetector``: z-score flagging of step wall times (pure
  Python, a copy); ``TrainConfig.straggler_z`` and the LM ``Trainer`` use
  it.
* ``best_mesh_after_failure``: the largest ``(data, model)`` mesh (or
  ``(pod, data, model)``) that keeps the ``model`` axis whole over the
  devices left: model parallelism cannot shrink without moving weights
  between hosts, data parallelism can.
* ``reshard_state``: a ``Trainer`` state (``models.io.ShardedLM`` blocks,
  the optimizer's moments, the step) placed on another mesh by the specs
  there.

A mesh is a ``DeviceMesh`` over the ranks of a ``torch.distributed``
world, and every rank of the world takes part in building it; a world
does not shrink under a running job.  So both functions work within one
world: ``best_mesh_after_failure`` asks for the world a restarted job
has (``n_devices`` must be its size), and ``reshard_state`` moves a state
between two meshes of the same world.  A job that lost ranks restarts in
a smaller world and goes through its last whole checkpoint, which
restores onto any mesh (``train.checkpoint``, ``Trainer.init_or_restore``):
the reference's elastic restart, restore then reshard, is that one step.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass
class StragglerDetector:
    """z-score straggler flagging on step wall times: Welford during
    warmup, then EMA mean/variance (outliers excluded from the stats)."""

    alpha: float = 0.05
    z_threshold: float = 4.0
    warmup: int = 10
    rel_floor: float = 0.05   # ignore deviations below 5% of the mean
    mean: float = 0.0
    var: float = 0.0
    _m2: float = 0.0
    count: int = 0

    def update(self, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            delta = dt - self.mean
            self.mean += delta / self.count
            self._m2 += delta * (dt - self.mean)
            if self.count == self.warmup:
                self.var = max(self._m2 / max(self.warmup - 1, 1), 1e-12)
            return False
        std = math.sqrt(max(self.var, 1e-12))
        std = max(std, self.rel_floor * abs(self.mean), 1e-9)
        z = (dt - self.mean) / std
        flagged = z > self.z_threshold
        if not flagged:  # don't poison stats with outliers
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + \
                self.alpha * (dt - self.mean) ** 2
        return flagged


def best_mesh_after_failure(n_devices: int, model_parallel: int,
                            want_pod_axis: bool = False):
    """The largest mesh over ``n_devices`` that keeps a ``model`` axis of
    ``model_parallel``: ``(data, model)`` with ``data = n_devices //
    model_parallel``, or ``(pod 2, data / 2, model)`` when
    ``want_pod_axis`` and ``data`` is even, through
    ``launch.mesh.make_mesh``.  Raises, with the reference's message,
    when not one ``model`` group fits, and when ``n_devices`` is not the
    world's size (module docstring)."""
    from repro_torch.launch import mesh as mesh_lib

    data = n_devices // model_parallel
    if data < 1:
        raise ValueError(
            f"cannot keep model={model_parallel} with {n_devices} devices")
    world = dist.get_world_size()
    if n_devices != world:
        raise ValueError(
            f"a mesh here is built over the world of {world} ranks, not "
            f"{n_devices} devices: restart in a world of the survivors and "
            "restore the last checkpoint onto its mesh")
    if want_pod_axis and data % 2 == 0:
        return mesh_lib.make_mesh((2, data // 2, model_parallel),
                                  ("pod", "data", "model"))
    return mesh_lib.make_mesh((data, model_parallel), ("data", "model"))


@torch.no_grad()
def reshard_state(state: dict, new_mesh, *, train: bool = True) -> dict:
    """A ``Trainer`` state on its mesh (``{"params": ShardedLM, "opt",
    "step"}``) placed on ``new_mesh``, a mesh of the same world: the
    parameters gathered whole from the old blocks into a whole model,
    which ``ShardedLM(..., train=train)`` cuts by the specs on
    ``new_mesh``; each moment gathered whole in turn and cut by the new
    optimizer's ``state_specs``; the step copied.  A collective: every
    rank calls it.  Returns a new state (the old one is left as it was),
    as a save on the old mesh restored onto the new one would give it."""
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import steps
    from repro_torch.models import io as model_io

    sp, opt = state["params"], state["opt"]
    cfg, old = sp.cfg, sp.mesh
    dev = sp.compute_tensors()[0].device
    model, _ = model_io._model_and_offsets(cfg, dev)
    whole = model_io.reference_groups(model, cfg)
    for path, leaf in sp.leaves.items():
        spec = sp.specs[path]
        if isinstance(leaf, torch.Tensor):
            whole[path].copy_(collectives.gather_spec(leaf, spec, old))
            continue
        for dst, block in zip(whole[path], leaf):
            dst.copy_(collectives.gather_spec(block, spec[1:], old))
    new_sp = model_io.ShardedLM(model, cfg, new_mesh, train)
    new = steps.train_state(cfg, new_sp, lambda params, layout: type(opt)(
        params, opt.cfg, layout))
    old_specs, new_opt = opt.state_specs(), new["opt"]
    new_specs, new_moments = new_opt.state_specs(), new_opt.state()
    for k, x in opt.state().items():
        full = collectives.gather_spec(x, old_specs[k], old)
        new_moments[k].copy_(sharding.local_shard(full, new_specs[k],
                                                  new_mesh))
    new_opt.step.copy_(opt.step)
    return new
