"""Train an LM or the QoS-aware router (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 200 [--global-batch 8] [--seq-len 128] [--reduced] \
        [--ckpt-dir DIR] [--ckpt-every 50] [--device cuda] [--eager] \
        [--data-parallel 1] [--model-parallel 1] [--production-mesh]

The LM path trains the dense, MoE and recurrent families
(``train.trainer.Trainer`` over ``data.pipeline.SyntheticLM``; RWKV6 and
RecurrentGemma through their training forwards' plain scans, on one
device or a mesh) on the CUDA device, each step replayed
from a CUDA graph (``--eager`` runs them eagerly; ``--device cpu`` with
``--reduced`` runs the reduced config of the same family on the CPU).  The
global batch is cut into the config's ``microbatches`` when it divides,
else taken whole.  With ``--ckpt-dir`` it checkpoints every
``--ckpt-every`` steps and at the last one, and a rerun resumes from the
newest checkpoint (to the same stream: the trainer asks the data for each
step's batch by its number).  Enc-dec raises: ``SyntheticLM`` gives token
batches only, as the reference's launcher feeds them, and enc-dec's loss needs frames too (its training
step is ``launch.steps.make_train_step`` on ``{"frames", "tokens"}``).

``--data-parallel``/``--model-parallel`` above 1 or ``--production-mesh``
join the process group (torchrun's, or a world of one this process
starts and ends, as ``--router-mesh`` does) and build
``launch.mesh.make_host_mesh(dp, mp)`` (clipped to the world) or
``make_production_mesh()`` (which raises in a world under 256 ranks); the
trainer gets the mesh when it holds more than one rank, as the
reference's does, and each rank trains on its rows and blocks; rank 0
logs and writes the checkpoints:

    PYTHONPATH=src torchrun --standalone --nproc_per_node=4 \
        -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \
        --device cpu --data-parallel 2 --model-parallel 2 --steps 4

(``--arch rwkv6-7b`` and ``--arch recurrentgemma-2b`` train on a mesh the
same way; at its published width rwkv6-7b's training state is ~90 GB, a
quarter of it a rank on 4, by ``scripts/torch_mesh_bytes.py``.)

    PYTHONPATH=src python -m repro_torch.launch.train --router --iters 400 \
        [--obs-fmt padded|segments] [--ragged-caps] [--scenario NAME] \
        [--failover [--retry-budget 2] [--shed-watermark 0.9]] \
        [--straggler-z 4.0] [--router-mesh] [--device cuda] [--eager] \
        [--out router.npz]

Trains the router with ``core.training.train_router`` on the CUDA device,
every collect step and update replayed from a CUDA graph (``--eager`` runs
them eagerly).  ``--scenario`` trains against a scripted scenario of
``repro_torch.scenarios``; ``--failover`` arms the failure-aware request
lifecycle; ``--straggler-z`` flags slow iterations.  ``--out`` saves the
trained router in the reference's tree layout (``core.io.save_pytree``),
which ``launch/route.py --ckpt`` and the reference both load.

``--router-mesh`` shards the replay buffer's capacity over the 1-D
``launch.mesh.make_train_mesh()`` of every rank (``training.train_router(
mesh=...)``), bit-identical to the unsharded run.  In one process it is a
world of one (NCCL on the card, gloo with ``--device cpu``); under
torchrun, one rank per process:

    PYTHONPATH=src torchrun --nproc_per_node=4 -m repro_torch.launch.train \
        --router --router-mesh --device cpu --iters 2

On CUDA torchrun takes one GPU per rank.  Only rank 0 logs and writes
``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch.distributed as dist

from repro_torch import device as device_lib, scenarios
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import features, io, sac as sac_lib, training
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.env import env as env_lib
from repro_torch.launch import mesh as mesh_lib, route
from repro_torch.train.trainer import Trainer, TrainerConfig


def router_configs(args, dev, say=print):
    """(EnvConfig, pool, SACConfig, TrainConfig) from the flags; ``say``
    prints what they chose."""
    env_cfg = env_lib.EnvConfig()
    pool = env_lib.make_env_pool(env_cfg, device=dev)
    if args.ragged_caps:
        env_cfg = env_lib.with_ragged_caps(env_cfg, pool)
        say(f"[train] ragged fleet: run_caps={env_cfg.run_caps} "
            f"wait_caps={env_cfg.wait_caps}")
    if args.scenario:
        spec = scenarios.get(args.scenario)     # fails on an unknown name
        env_cfg = dataclasses.replace(env_cfg, scenario=args.scenario)
        say(f"[train] scenario {spec.name!r}: horizon={spec.horizon:g}s, "
            f"{len(spec.events)} events")
    fo = route.failover_config(args)
    if fo is not None:
        env_cfg = dataclasses.replace(env_cfg, failover=fo)
        say(f"[train] failover: retry_budget={fo.retry_budget} "
            f"backoff={fo.backoff_base:g}s buffer={fo.buffer_cap} "
            f"watermark={fo.shed_watermark}")
    seg = args.obs_fmt == "segments"
    sac_cfg = sac_lib.SACConfig(
        n_actions=env_cfg.n_experts + 1, flat_dim=env_cfg.n_experts * 3,
        n_run_edges=features.seg_run_rows(env_cfg) if seg else None,
        run_caps=env_cfg.run_caps if seg else None,
        wait_caps=env_cfg.wait_caps if seg else None)
    tc = training.TrainConfig(iterations=args.iters, obs_fmt=args.obs_fmt,
                              straggler_z=args.straggler_z)
    return env_cfg, pool, sac_cfg, tc


def train_router_main(args):
    """Train the router from parsed flags; returns (SAC, history).  With
    ``--router-mesh`` it joins (or starts, and then ends) the process
    group."""
    mesh, opened = None, False
    if args.router_mesh:
        opened = not dist.is_initialized()
        dev = mesh_lib.init_world(args.device)
        mesh = mesh_lib.make_train_mesh()
    else:
        dev = device_lib.resolve(args.device)
    try:
        return _train(args, dev, mesh)
    finally:
        if opened:
            mesh_lib.close_world()


def _train(args, dev, mesh):
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    env_cfg, pool, sac_cfg, tc = router_configs(args, dev, say)
    if mesh is not None:
        say(f"[train] replay capacity sharded over {mesh}")

    def log_fn(m):
        if m.get("straggler"):
            print(f"  [straggler] it={m['iteration']} "
                  f"step={m['step_s']:.3f}s vs mean={m['mean_s']:.3f}s")
            return
        flags = (f" stragglers={m['straggler_flags']}"
                 if "straggler_flags" in m else "")
        print(f"  it={m['iteration']} rew={m['collect_reward']:.3f}{flags}")

    sac, history = training.train_router(env_cfg, sac_cfg, tc, pool=pool,
                                         log_fn=log_fn if lead else None,
                                         graphs=not args.eager, mesh=mesh)
    say(f"[train] router done: final reward "
        f"{history[-1]['collect_reward']:.3f}")
    if args.out and lead:
        io.save_pytree(args.out, io.sac_params_to_numpy(sac))
        say(f"[train] saved {args.out}")
    return sac, history


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--router", action="store_true",
                   help="train the QoS router instead of an LM")
    p.add_argument("--router-mesh", action="store_true",
                   help="shard the replay buffer over the expert mesh of "
                        "every rank (a world of one, or torchrun's)")
    p.add_argument("--obs-fmt", default="padded",
                   choices=["padded", "segments"])
    p.add_argument("--ragged-caps", action="store_true",
                   help="per-expert queue capacities from pool memory")
    route.add_fleet_flags(p)
    p.add_argument("--straggler-z", type=float, default=None,
                   help="flag iterations whose wall-time z-score exceeds "
                        "this (fault_tolerance.StragglerDetector)")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--reduced", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--production-mesh", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--eager", action="store_true",
                   help="run every step (router: collect step and update) "
                        "eagerly, with no CUDA graph")
    p.add_argument("--out", default="",
                   help="save the trained router here (npz, the "
                        "reference's tree)")
    return p


def train_lm_main(args, log_fn=print):
    """Train an LM from parsed flags; returns (the final train state, the
    ``Trainer``, which holds the step and checkpoint times).  With a mesh
    flag it joins (or starts, and then ends) the process group."""
    if not (args.production_mesh or args.data_parallel > 1
            or args.model_parallel > 1):
        return _train_lm(args, device_lib.resolve(args.device), None, log_fn)
    opened = not dist.is_initialized()
    dev = mesh_lib.init_world(args.device)
    try:
        mesh = (mesh_lib.make_production_mesh() if args.production_mesh
                else mesh_lib.make_host_mesh(args.data_parallel,
                                             args.model_parallel))
        return _train_lm(args, dev, mesh if mesh.size() > 1 else None,
                         log_fn)
    finally:
        if opened:
            mesh_lib.close_world()


def _train_lm(args, dev, mesh, log_fn):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.global_batch % max(1, cfg.microbatches):
        cfg = dataclasses.replace(cfg, microbatches=1)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tcfg, mesh=mesh, log_fn=log_fn, device=dev,
                      graphs=not args.eager)
    if mesh is not None:
        trainer.log_fn(f"[train] {cfg.name} on {mesh}")
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=cfg.microbatches),
        mesh=mesh, device=trainer.device)
    state = trainer.init_or_restore(seed=0)
    state = trainer.run(state, data)
    trainer.log_fn(f"[train] done at step {int(state['step'])}")
    return state, trainer


def main(argv: Optional[list] = None):
    args = parser().parse_args(argv)
    if args.router:
        return train_router_main(args)
    return train_lm_main(args)


if __name__ == "__main__":
    main()
