"""Train the QoS-aware router (the port's ``repro/launch/train.py
--router``).

    PYTHONPATH=src python -m repro_torch.launch.train --router --iters 400 \\
        [--obs-fmt padded|segments] [--ragged-caps] [--scenario NAME] \\
        [--failover [--retry-budget 2] [--shed-watermark 0.9]] \\
        [--straggler-z 4.0] [--device cuda] [--eager] [--out router.npz]

Trains with ``core.training.train_router`` on the CUDA device, every
collect step and update replayed from a CUDA graph (``--eager`` runs them
eagerly).  ``--scenario`` trains against a scripted scenario of
``repro_torch.scenarios``; ``--failover`` arms the failure-aware request
lifecycle; ``--straggler-z`` flags slow iterations.  ``--out`` saves the
trained router in the reference's tree layout (``core.io.save_pytree``),
which ``launch/route.py --ckpt`` and the reference both load.

The capacity-sharded replay of ``--router-mesh`` (ROADMAP queue A item 3)
and the LM trainer (queue A item 5) are not ported: they raise.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from repro_torch import device as device_lib, scenarios
from repro_torch.core import features, io, sac as sac_lib, training
from repro_torch.env import env as env_lib
from repro_torch.launch import route


def router_configs(args, dev):
    """(EnvConfig, pool, SACConfig, TrainConfig) from the flags."""
    env_cfg = env_lib.EnvConfig()
    pool = env_lib.make_env_pool(env_cfg, device=dev)
    if args.ragged_caps:
        env_cfg = env_lib.with_ragged_caps(env_cfg, pool)
        print(f"[train] ragged fleet: run_caps={env_cfg.run_caps} "
              f"wait_caps={env_cfg.wait_caps}")
    if args.scenario:
        spec = scenarios.get(args.scenario)     # fails on an unknown name
        env_cfg = dataclasses.replace(env_cfg, scenario=args.scenario)
        print(f"[train] scenario {spec.name!r}: horizon={spec.horizon:g}s, "
              f"{len(spec.events)} events")
    fo = route.failover_config(args)
    if fo is not None:
        env_cfg = dataclasses.replace(env_cfg, failover=fo)
        print(f"[train] failover: retry_budget={fo.retry_budget} "
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
    """Train the router from parsed flags; returns (SAC, history)."""
    if args.router_mesh:
        raise NotImplementedError(
            "--router-mesh (the capacity-sharded replay buffer over a "
            "device mesh) is not ported yet; ROADMAP.md queue A item 3")
    dev = device_lib.resolve(args.device)
    env_cfg, pool, sac_cfg, tc = router_configs(args, dev)

    def log_fn(m):
        if m.get("straggler"):
            print(f"  [straggler] it={m['iteration']} "
                  f"step={m['step_s']:.3f}s vs mean={m['mean_s']:.3f}s")
            return
        flags = (f" stragglers={m['straggler_flags']}"
                 if "straggler_flags" in m else "")
        print(f"  it={m['iteration']} rew={m['collect_reward']:.3f}{flags}")

    sac, history = training.train_router(env_cfg, sac_cfg, tc, pool=pool,
                                         log_fn=log_fn,
                                         graphs=not args.eager)
    print(f"[train] router done: final reward "
          f"{history[-1]['collect_reward']:.3f}")
    if args.out:
        io.save_pytree(args.out, io.sac_params_to_numpy(sac))
        print(f"[train] saved {args.out}")
    return sac, history


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--router", action="store_true",
                   help="train the QoS router (the LM trainer is not "
                        "ported)")
    p.add_argument("--router-mesh", action="store_true",
                   help="shard the replay buffer over a device mesh (not "
                        "ported)")
    p.add_argument("--obs-fmt", default="padded",
                   choices=["padded", "segments"])
    p.add_argument("--ragged-caps", action="store_true",
                   help="per-expert queue capacities from pool memory")
    route.add_fleet_flags(p)
    p.add_argument("--straggler-z", type=float, default=None,
                   help="flag iterations whose wall-time z-score exceeds "
                        "this (fault_tolerance.StragglerDetector)")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--device", default="cuda")
    p.add_argument("--eager", action="store_true",
                   help="run every collect step and update eagerly (no "
                        "CUDA graph)")
    p.add_argument("--out", default="",
                   help="save the trained router here (npz, the "
                        "reference's tree)")
    return p


def main(argv: Optional[list] = None):
    args = parser().parse_args(argv)
    if not args.router:
        raise NotImplementedError(
            "the LM trainer (Adafactor, train/trainer.py) is not ported yet; "
            "ROADMAP.md queue A item 5.  Pass --router to train the router")
    return train_router_main(args)


if __name__ == "__main__":
    main()
