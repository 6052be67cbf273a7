"""Serve routing requests through the expert fleet and compare policies (the
evaluation table of ``examples/edge_routing_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.route --device cuda \
        [--steps 2000] [--n-experts 6] [--n-envs 4] [--ckpt qos.npz] \
        [--scenario rolling_outage] [--failover [--shed-watermark 0.9]] \
        [--eager]

Runs RR, SQF, BR and QLL, and the SAC router given ``--ckpt`` (an npz
written by ``repro.core.io.save_pytree``).  Each policy routes
``steps * n_envs`` requests.  On CUDA every routing step but the first
replays a CUDA graph (``training.RoutingLoop``); ``--eager`` runs every
step eagerly instead.  Requests routed per second is taken over the steps
after the first (the first, which captures the graph, is reported apart),
synchronised with the device.

``--scenario <name>`` routes under a scripted scenario of
``repro_torch.scenarios`` (flash crowds, expert failures, stragglers,
memory claims); ``--failover`` arms the failure-aware request lifecycle
(``env.failover``: drain to a retry buffer, re-admit with backoff, and,
with ``--shed-watermark``, shed under overload).  The heuristics then
route around down experts.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch import device as device_lib, scenarios
from repro_torch.core import features, io, routers, sac as sac_lib, training
from repro_torch.env import env as env_lib
from repro_torch.env.failover import FailoverConfig
from repro_torch.env.workload import WorkloadConfig


def make_env(n_experts: int = 6, workload: str = "poisson",
             ragged_caps: bool = False, backend: Optional[str] = None,
             device=None, scenario: Optional[str] = None,
             failover: Optional[FailoverConfig] = None):
    """(EnvConfig, pool on ``device``, the CUDA device by default).  An
    unknown ``scenario`` raises ``KeyError``."""
    cfg = env_lib.EnvConfig(n_experts=n_experts,
                            workload=WorkloadConfig(kind=workload),
                            engine_backend=backend, scenario=scenario or None,
                            failover=failover)
    if scenario:
        scenarios.get(scenario)
    pool = env_lib.make_env_pool(cfg, device=device_lib.resolve(device))
    if ragged_caps:
        cfg = env_lib.with_ragged_caps(cfg, pool)
    return cfg, pool


def failover_config(args) -> Optional[FailoverConfig]:
    """The ``--failover``/``--retry-budget``/``--shed-watermark`` flags as a
    config (None without ``--failover``; a watermark of 0 disables
    shedding)."""
    if not args.failover:
        return None
    return FailoverConfig(retry_budget=args.retry_budget,
                          shed_watermark=(args.shed_watermark
                                          if args.shed_watermark > 0
                                          else None))


def add_fleet_flags(p) -> None:
    """The scenario and failover flags ``route`` and ``train`` share."""
    p.add_argument("--scenario", default="",
                   help="named scripted scenario (repro_torch.scenarios: "
                        f"{', '.join(scenarios.names())})")
    p.add_argument("--failover", action="store_true",
                   help="failure-aware request lifecycle (env.failover): "
                        "drain requests off down experts into a retry "
                        "buffer, re-admit with backoff, shed on an "
                        "exhausted budget or deadline")
    p.add_argument("--retry-budget", type=int, default=2,
                   help="re-dispatches per request before it is shed")
    p.add_argument("--shed-watermark", type=float, default=0.0,
                   help="fleet occupancy in (0, 1] that arms overload "
                        "shedding (0 disables; needs --failover)")


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
            routers.shortest_queue(env_cfg.n_experts, caps=caps,
                                   env_cfg=env_cfg),
            routers.bert_router(),
            routers.quality_least_loaded(caps=caps, env_cfg=env_cfg)]
    if sac is not None:
        pols.append(routers.sac_policy("SAC", sac, obs_fmt=obs_fmt))
    return pols


def serve(env_cfg, pool, policy, *, n_steps: int, n_envs: int,
          seed: int = 1234, graphs: bool = True):
    """One policy's evaluation and its throughput.  Returns (metrics, final
    env state): the metrics of ``training.evaluate`` plus ``seconds`` (the
    whole run), ``first_step_s`` (the first step, with the graph's capture
    when graphed) and ``requests_per_s`` (routing decisions per second of
    wall time over the steps after the first, device synchronised)."""
    timing = {}
    m, state = training.evaluate(env_cfg, pool, policy, n_steps=n_steps,
                                 seed=seed, n_envs=n_envs, return_state=True,
                                 graphs=graphs, timing=timing)
    m["policy"] = policy.name
    m["mode"] = "graphed" if graphs and pool.k1.is_cuda else "eager"
    m["requests"] = n_steps * n_envs
    m["seconds"] = timing["first_s"] + timing["rest_s"]
    m["first_step_s"] = timing["first_s"]
    m["requests_per_s"] = ((n_steps - 1) * n_envs / timing["rest_s"]
                           if n_steps > 1 else n_envs / timing["first_s"])
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
    add_fleet_flags(p)
    p.add_argument("--device", default="cuda")
    p.add_argument("--eager", action="store_true",
                   help="run every routing step eagerly (no CUDA graph)")
    args = p.parse_args(argv)

    dev = device_lib.resolve(args.device)
    env_cfg, pool = make_env(args.n_experts, args.workload, args.ragged_caps,
                             device=dev, scenario=args.scenario,
                             failover=failover_config(args))
    sac = None
    if args.ckpt:
        tree = io.load_pytree(args.ckpt)
        if not io.router_ckpt_compatible(tree):
            raise SystemExit(f"{args.ckpt} predates the current obs encoding")
        sac = io.sac_params_from_numpy(tree, sac_config(env_cfg), device=dev)
    rows = []
    fo_cols = ("shed", "evicted") if env_cfg.failover else ("evicted",)
    print(f"{'policy':>8s} {'avg QoS':>8s} {'lat/tok':>9s} {'viol':>6s} "
          f"{'done':>7s} {'drop':>7s} "
          + "".join(f"{c:>8s} " for c in fo_cols) + f"{'req/s':>9s}")
    for pol in make_policies(env_cfg, sac, obs_fmt=args.obs_fmt):
        m, _ = serve(env_cfg, pool, pol, n_steps=args.steps,
                     n_envs=args.n_envs, graphs=not args.eager)
        rows.append(m)
        print(f"{pol.name:>8s} {m['avg_qos']:8.4f} "
              f"{m['avg_latency_per_token'] * 1e3:7.2f}ms "
              f"{m['violation_rate']:6.3f} {m['completed']:7.1f} "
              f"{m['dropped']:7.1f} "
              + "".join(f"{m[c]:8.1f} " for c in fo_cols)
              + f"{m['requests_per_s']:9.1f}")
    return rows


if __name__ == "__main__":
    main()
