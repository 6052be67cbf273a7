"""Train the QoS router with the JAX reference package and evaluate it, as
the PyTorch port's ``chip_smoke.py`` train phase does on the card: the
paper's setting (``EnvConfig()``, ``SACConfig()``, ``TrainConfig()``
defaults: 16 envs, 8 collect steps, 8 updates of 256, buffer 100,000,
warmup 2,000, 400 iterations, padded observations), one run per seed, each
router evaluated greedily on N = 6 x 4 envs x 750 steps (evaluation seed
1234) beside QLL and the untrained router of the same seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_router_quality.py \
        [--seeds 0 1 2] [--iters 400] [--out reference_quality.json]

Prints one JSON line per seed and a summary line (mean and sample
standard deviation of ``mean_reward`` over the seeds).  Only the quality
numbers are meant to be read: it runs wherever JAX runs.
"""
from __future__ import annotations

import argparse
import json
import statistics

import jax

from repro.core import routers, sac as sac_lib, training
from repro.env import env as env_lib

KEYS = ("mean_reward", "avg_qos", "completed", "dropped", "violation_rate")


def evaluate(env_cfg, pool, policy):
    m = training.evaluate(env_cfg, pool, policy, n_steps=750, seed=1234,
                          n_envs=4)
    return {k: m[k] for k in KEYS}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    env_cfg = env_lib.EnvConfig()
    pool = env_lib.make_env_pool(env_cfg)
    sac_cfg = sac_lib.SACConfig()
    qll = evaluate(env_cfg, pool, routers.quality_least_loaded())
    rows = []
    for seed in args.seeds:
        tc = training.TrainConfig(seed=seed, iterations=args.iters)
        k_init = jax.random.split(jax.random.split(
            jax.random.PRNGKey(seed))[0])[0]
        untrained = sac_lib.init_params(k_init, sac_cfg)
        params, history = training.train_router(env_cfg, sac_cfg, tc,
                                                pool=pool)
        row = {"seed": seed, "iterations": args.iters,
               "final_collect_reward": history[-1]["collect_reward"],
               "trained": evaluate(env_cfg, pool, routers.sac_policy(
                   "SAC", sac_cfg, params)),
               "untrained": evaluate(env_cfg, pool, routers.sac_policy(
                   "SAC0", sac_cfg, untrained)),
               "qll": qll}
        print(json.dumps(row), flush=True)
        rows.append(row)
    rew = [r["trained"]["mean_reward"] for r in rows]
    summary = {"seeds": args.seeds, "mean_reward_mean": statistics.mean(rew),
               "mean_reward_std": (statistics.stdev(rew) if len(rew) > 1
                                   else 0.0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": rows, "summary": summary}, f, indent=1)
    return rows, summary


if __name__ == "__main__":
    main()
