"""Serve routing requests through the expert fleet and compare policies (the
evaluation table of ``examples/edge_routing_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.route --device cuda \
        [--steps 2000] [--n-experts 6] [--n-envs 4] [--ckpt qos.npz]

Runs RR, SQF, BR and QLL, and the SAC router given ``--ckpt`` (an npz
written by ``repro.core.io.save_pytree``).  Each policy routes
``steps * n_envs`` requests; requests routed per second is the wall time
of that whole run, synchronised with the device.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import features, io, routers, sac as sac_lib, training
from repro_torch.env import env as env_lib
from repro_torch.env.workload import WorkloadConfig


def make_env(n_experts: int = 6, workload: str = "poisson",
             ragged_caps: bool = False, backend: Optional[str] = None,
             device=None):
    """(EnvConfig, pool on ``device``, the CUDA device by default)."""
    cfg = env_lib.EnvConfig(n_experts=n_experts,
                            workload=WorkloadConfig(kind=workload),
                            engine_backend=backend)
    pool = env_lib.make_env_pool(cfg, device=device_lib.resolve(device))
    if ragged_caps:
        cfg = env_lib.with_ragged_caps(cfg, pool)
    return cfg, pool


def sac_config(env_cfg: env_lib.EnvConfig) -> sac_lib.SACConfig:
    return sac_lib.SACConfig(n_actions=env_cfg.n_experts + 1,
                             n_run_edges=features.seg_run_rows(env_cfg),
                             run_caps=env_cfg.run_caps,
                             wait_caps=env_cfg.wait_caps)


def make_policies(env_cfg: env_lib.EnvConfig, sac: Optional[sac_lib.SAC] = None,
                  obs_fmt: str = "padded") -> List[routers.Policy]:
    caps = (None if env_cfg.run_caps is None
            else (env_cfg.run_caps, env_cfg.wait_caps))
    pols = [routers.round_robin(env_cfg.n_experts),
            routers.shortest_queue(env_cfg.n_experts, caps=caps),
            routers.bert_router(),
            routers.quality_least_loaded(caps=caps)]
    if sac is not None:
        pols.append(routers.sac_policy("SAC", sac, obs_fmt=obs_fmt))
    return pols


def serve(env_cfg, pool, policy, *, n_steps: int, n_envs: int,
          seed: int = 1234):
    """One policy's evaluation and its throughput.  Returns (metrics, final
    env state): the metrics of ``training.evaluate`` plus ``requests_per_s``
    (routing decisions per second of wall time, device synchronised)."""
    sync = (torch.cuda.synchronize if pool.k1.is_cuda else (lambda: None))
    sync()
    t0 = time.perf_counter()
    m, state = training.evaluate(env_cfg, pool, policy, n_steps=n_steps,
                                 seed=seed, n_envs=n_envs, return_state=True)
    sync()
    secs = time.perf_counter() - t0
    m["policy"] = policy.name
    m["requests"] = n_steps * n_envs
    m["seconds"] = secs
    m["requests_per_s"] = n_steps * n_envs / secs
    return m, state


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--n-experts", type=int, default=6)
    p.add_argument("--n-envs", type=int, default=4)
    p.add_argument("--workload", default="poisson",
                   choices=["poisson", "realworld"])
    p.add_argument("--ragged-caps", action="store_true",
                   help="per-expert queue capacities from pool memory")
    p.add_argument("--obs-fmt", default="padded",
                   choices=["padded", "segments"])
    p.add_argument("--ckpt", default="",
                   help="SAC router checkpoint (npz from repro.core.io)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = device_lib.resolve(args.device)
    env_cfg, pool = make_env(args.n_experts, args.workload, args.ragged_caps,
                             device=dev)
    sac = None
    if args.ckpt:
        tree = io.load_pytree(args.ckpt)
        if not io.router_ckpt_compatible(tree):
            raise SystemExit(f"{args.ckpt} predates the current obs encoding")
        sac = io.sac_params_from_numpy(tree, sac_config(env_cfg), device=dev)
    rows = []
    print(f"{'policy':>8s} {'avg QoS':>8s} {'lat/tok':>9s} {'viol':>6s} "
          f"{'done':>7s} {'drop':>7s} {'req/s':>9s}")
    for pol in make_policies(env_cfg, sac, obs_fmt=args.obs_fmt):
        m, _ = serve(env_cfg, pool, pol, n_steps=args.steps,
                     n_envs=args.n_envs)
        rows.append(m)
        print(f"{pol.name:>8s} {m['avg_qos']:8.4f} "
              f"{m['avg_latency_per_token'] * 1e3:7.2f}ms "
              f"{m['violation_rate']:6.3f} {m['completed']:7.1f} "
              f"{m['dropped']:7.1f} {m['requests_per_s']:9.1f}")
    return rows


if __name__ == "__main__":
    main()
