"""The LM trainer (port of ``repro/train/trainer.py``): the training step
replayed from a CUDA graph, checkpoint and restart, straggler detection,
preemption safety.

    trainer = Trainer(model_cfg, TrainerConfig(...))
    state = trainer.init_or_restore(seed=0)
    state = trainer.run(state, data)

Fault-tolerance contract: checkpoints every ``ckpt_every`` steps, at the
last step and on SIGTERM (preemption); ``init_or_restore`` resumes from
the newest manifest.  ``run`` takes the batch of each step from
``next(data)`` when ``data`` is an iterator, else from ``data.batch(step)``
(restart-safe: a ``SyntheticLM`` passed itself gives a resumed run the
stream it would have seen).  The state is ``launch.steps.train_state``'s,
updated in place; ``tree(state)`` is its checkpoint view in the
reference's layout (``params/...``, ``opt/...``, ``step``).  The trainer
keeps each step's wall seconds (``step_s``, the batch and the wait for the
step included) and each checkpoint's (``save_s``, ``restore_s``).

``Trainer(model_cfg, cfg, mesh=...)`` trains on an LM mesh
(``launch.mesh.make_host_mesh``): its step runs under a ``MeshPolicy`` of
``activation_rules(mesh, train=True)``, ``init_state`` keeps each rank's
blocks of the parameters by ``block_spec(..., train=True)`` (a
``models.io.ShardedLM``; every family) and the optimizer's state likewise,
the data are each rank's rows (``SyntheticLM(mesh=)``), checkpoints are
written whole by rank 0 and restored onto any mesh, or onto none, and
only rank 0 logs.  The model computes on the blocks Megatron-style
(``launch/steps.py``), and a batch whose rows do not split over every
data axis is held whole by the ranks outside the axes that split it
(``bind``).  ``distributed.fault_tolerance.reshard_state`` moves a state
onto another mesh of the same world.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.api import MeshPolicy
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.launch import steps as steps_lib
from repro_torch.models import io as model_io, model as model_lib
from repro_torch.train import checkpoint, optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    straggler_z: float = 4.0
    on_straggler: str = "log"   # log | raise


def _nest(flat: dict) -> dict:
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def tree(state: dict) -> dict:
    """A train state's checkpoint tree, in the reference's layout (on a
    mesh, this rank's blocks)."""
    opt = state["opt"]
    return {"params": _nest(opt.params), "opt": _nest(opt.state()),
            "step": state["step"]}


def tree_specs(state: dict) -> dict:
    """Each sharded leaf's spec by its checkpoint path (``params/...``,
    ``opt/...``)."""
    sp, opt = state["params"], state["opt"]
    return {**{f"params/{k}": v for k, v in sp.specs.items()},
            **{f"opt/{k}": v for k, v in opt.state_specs().items()}}


class Trainer:
    """Trains ``model_cfg`` (dense, MoE, RWKV6 or RecurrentGemma) with
    its ``optimizer`` on ``device`` (CUDA by default), on ``mesh`` when
    given (module docstring); ``graphs=False`` runs every step
    eagerly."""

    def __init__(self, model_cfg, cfg: TrainerConfig, mesh=None,
                 log_fn: Callable = print, device=None, graphs: bool = True):
        if model_cfg.family == "encdec":
            raise NotImplementedError(
                f"{model_cfg.name}: the trainer feeds SyntheticLM token "
                "batches only, as the reference's launcher does, and "
                "enc-dec's lm_loss needs frames too (train it through "
                "launch.steps.make_train_step on {'frames', 'tokens'} "
                "batches)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        lead = mesh is None or dist.get_rank() == 0
        self.log_fn = log_fn if lead else (lambda *a, **k: None)
        self.device = resolve(device)
        self.opt = opt_lib.make_optimizer(
            model_cfg.optimizer, peak_lr=cfg.peak_lr,
            warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps)
        self.policy = None
        if mesh is not None:
            self.policy = MeshPolicy(mesh, sharding.activation_rules(
                mesh, train=True))
        self._step_fn = steps_lib.make_train_step(model_cfg, self.policy,
                                                  graphs=graphs)
        self.straggler = StragglerDetector(z_threshold=cfg.straggler_z)
        self._preempted = False
        self.step_s, self.save_s, self.restore_s = [], [], None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        params = model_lib.init_params(self.model_cfg, seed=seed,
                                       device=self.device)
        if self.mesh is not None:
            params = model_io.ShardedLM(params, self.model_cfg, self.mesh,
                                        train=True)
        return steps_lib.train_state(self.model_cfg, params, self.opt)

    def _sharded(self, state) -> dict:
        """``checkpoint``'s mesh arguments for ``state``."""
        if self.mesh is None:
            return {}
        return {"mesh": self.mesh, "specs": tree_specs(state)}

    def init_or_restore(self, seed: int = 0) -> dict:
        state = self.init_state(seed)
        if self.cfg.ckpt_dir and checkpoint.latest_step(
                self.cfg.ckpt_dir) is not None:
            t0 = time.perf_counter()
            checkpoint.restore(self.cfg.ckpt_dir, tree(state),
                               **self._sharded(state))
            self.restore_s = time.perf_counter() - t0
            self.log_fn(f"[trainer] restored step {int(state['step'])}")
        return state

    # ------------------------------------------------------------------
    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not main thread

    def bind(self, data) -> None:
        """Tell the step which mesh axes split ``data``'s rows (its
        ``sharding`` spec, as ``SyntheticLM(mesh=)`` gives it): the data
        axes outside them hold the same rows, and the loss divides its
        share among them (``models.model.lm_loss``).  ``run`` calls it;
        call it before the first step when stepping by hand."""
        spec = getattr(data, "sharding", None)
        if self.policy is not None and spec is not None:
            self.policy.rules["batch"] = spec[-2]

    def run(self, state: dict, data) -> dict:
        cfg = self.cfg
        self.bind(data)
        self._install_sigterm()
        start = int(state["step"])
        for step in range(start, cfg.total_steps):
            t0 = time.perf_counter()
            batch = next(data) if hasattr(data, "__next__") else data.batch(step)
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            self.step_s.append(dt)
            if self.straggler.update(dt):
                self.log_fn(f"[trainer] STRAGGLER step={step} dt={dt:.2f}s "
                            f"(mean {self.straggler.mean:.2f}s)")
                if cfg.on_straggler == "raise":
                    raise RuntimeError(f"straggler at step {step}")
            if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                self.log_fn(f"[trainer] step={step} loss={loss:.4f} "
                            f"gnorm={float(metrics['grad_norm']):.3f} "
                            f"dt={dt*1000:.0f}ms")
            if cfg.ckpt_dir and self.mesh is not None:
                self._preempted = self._any_rank(self._preempted)
            should_ckpt = cfg.ckpt_dir and (
                (step + 1) % cfg.ckpt_every == 0 or self._preempted
                or step == cfg.total_steps - 1)
            if should_ckpt:
                t0 = time.perf_counter()
                path = checkpoint.save(cfg.ckpt_dir, step + 1, tree(state),
                                       keep_last=cfg.keep_last,
                                       **self._sharded(state))
                self.save_s.append(time.perf_counter() - t0)
                if self._preempted:
                    self.log_fn(f"[trainer] preempted; saved {path}")
                    return state
        return state

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the mesh (a preemption
        seen by one rank saves on all, as a save is a collective)."""
        x = torch.tensor([float(flag)], device=self.device)
        collectives.sum_over(x, self.mesh, self.mesh.mesh_dim_names)
        return bool(x.item() > 0)
