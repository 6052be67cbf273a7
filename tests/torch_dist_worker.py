"""One rank of a multi-process test of the port's sharded paths on the CPU,
and ``run_world``, which starts every rank of one.

    python tests/torch_dist_worker.py <case> <rank> <world> <dir> [arg]

Each rank joins a gloo world on a ``FileStore`` in ``dir``, runs ``case``
with one CPU thread (CPU reductions follow the thread count, so every
process that makes a compared tensor uses the same one), and saves what
it returns to ``dir/<case>-<rank>.pt`` for ``tests/test_torch_distributed.py``
to compare.  Imports neither JAX nor the reference package.
"""
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

WORKER = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(WORKER), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.core import sac as sac_lib, training  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.env import engine, engine_layout as layout  # noqa: E402
from repro_torch.env import env as env_lib, profiles  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, train  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)     # each collective's
DEADLINE_S = 150                             # each run's

# the reference's multi-device training case (tests/test_multidevice.py)
ENV_CFG = env_lib.EnvConfig(n_experts=3, run_cap=2, wait_cap=2)
SAC_CFG = sac_lib.SACConfig(n_actions=4, hidden=16, flat_dim=9)
TC = training.TrainConfig(n_envs=2, collect_steps=2, updates_per_iter=2,
                          batch_size=8, buffer_capacity=64,
                          warmup_transitions=4, iterations=3)


def _train(mesh):
    pool = env_lib.make_env_pool(ENV_CFG, device="cpu")
    st = training.init_train_state(ENV_CFG, SAC_CFG, TC, pool, mesh=mesh)
    it = training.make_iteration(ENV_CFG, TC, pool, st, mesh=mesh)
    aux = [{k: float(v) for k, v in it(i).items()}
           for i in range(TC.iterations)]
    return {"tensors": {k: x.clone() for k, x in st.tensors().items()},
            "aux": aux}


def iteration(rank, world, data):
    """Three sharded iterations on ``make_train_mesh(data=...)``; rank 0
    also runs them unsharded."""
    mesh = mesh_lib.make_train_mesh(data=int(data) or None)
    out = {"coord": (sharding.axis_index(mesh, sharding.DATA),
                     sharding.axis_index(mesh, sharding.EXPERT)),
           "sizes": (sharding.axis_size(mesh, sharding.DATA),
                     sharding.axis_size(mesh, sharding.EXPERT)),
           "ranks": mesh.mesh.flatten().tolist(),
           "order": mesh_lib.device_order(),
           "sharded": _train(mesh)}
    if rank == 0:
        out["plain"] = _train(None)
    return out


def poisson_stream(n_experts, steps, seed):
    """The reference's engine stream (``tests/test_multidevice.py``): rate-8
    arrivals to random experts, prompts 16..511, outputs 8..299."""
    rng = np.random.default_rng(seed)
    return {"dt": rng.exponential(size=steps).astype(np.float32) / 8.0,
            "expert": rng.integers(0, n_experts, steps),
            "p": rng.integers(16, 512, steps),
            "d_true": rng.integers(8, 300, steps)}


def _drive(backend, pool, streams, r, w, mesh=None):
    n = pool.n_experts
    b = len(streams)
    q = layout.empty_queues(n, r, w, batch=b, device="cpu")
    clocks = torch.zeros((b, n), dtype=torch.float32)
    t = torch.zeros((b,), dtype=torch.float32)
    col = lambda k, i: torch.as_tensor(np.stack([s[k][i] for s in streams]))
    done = []
    for i in range(len(streams[0]["dt"])):
        q, _ = layout.push_wait(q, col("expert", i), p=col("p", i),
                                d_true=col("d_true", i), score=0.7,
                                pred_s=0.7, pred_d=48.0, t=t)
        t = t + col("dt", i)
        q, clocks, acc = engine.advance_all(pool, 0.030, q, clocks, t,
                                            backend=backend, mesh=mesh)
        done.append(acc["done"])
    return {"queues": q, "clocks": clocks, "done": torch.stack(done)}


def _span(rows: slice) -> tuple:
    return rows.start, rows.stop


def shard_engine(rank, world, _arg):
    """N=16, R=W=4, two envs of 100 Poisson steps on the ``"shard"``
    backend (the plain loop per rank); rank 0 also on ``"torch"``."""
    n, r, w, steps = 16, 4, 4, 100
    pool = profiles.make_pool(n, device="cpu")
    streams = [poisson_stream(n, steps, s) for s in (0, 1)]
    out = {"shard": _drive("shard", pool, streams, r, w),
           "rows": _span(sharding.expert_rows(mesh_lib.make_expert_mesh(), n))}
    if rank == 0:
        out["torch"] = _drive("torch", pool, streams, r, w)
    return out


def _routed(env_cfg, pool, policy, n_envs, steps):
    """``policy`` over ``RoutingLoop`` for ``steps`` eager steps: the final
    env state's tensors and metrics, and the bytes each reader's gathers
    brought this rank (``collectives.BYTES``)."""
    collectives.BYTES.clear()
    loop = training.RoutingLoop(env_cfg, pool, policy, n_envs)
    loop.run(steps, graphs=False)
    tensors = {f"{k} {j}": x for k, q in loop.state.items()
               if k in ("queues", "retry_buf") for j, x in q.items()}
    tensors["expert_clock"] = loop.state["expert_clock"]
    return {"tensors": {k: x.clone() for k, x in tensors.items()},
            "metrics": loop.metrics(), "bytes": dict(collectives.BYTES)}


def shard_env(rank, world, _arg):
    """The env under ``engine_backend="shard"`` (N=8, 2 experts a rank):
    QLL on a ragged fleet, a seeded SAC router on the padded observation,
    and QLL under ``rolling_outage`` with failover and a shed watermark,
    2 envs each; rank 0 also runs them on ``"torch"``."""
    import dataclasses

    from repro_torch.env.failover import FailoverConfig
    from repro_torch.launch import route

    steps = {"qll": 60, "sac": 20, "failover": 160}
    base, pool = route.make_env(8, ragged_caps=True, device="cpu")
    sac = sac_lib.SAC(sac_lib.SACConfig(n_actions=9, flat_dim=24),
                      torch.Generator().manual_seed(3))
    fo_cfg, _ = route.make_env(8, device="cpu", scenario="rolling_outage",
                               failover=FailoverConfig(shed_watermark=0.5))
    runs = {"qll": (base, route.make_policies(base)[3]),
            "sac": (dataclasses.replace(base, run_caps=None, wait_caps=None),
                    route.make_policies(base, sac)[4]),
            "failover": (fo_cfg, route.make_policies(fo_cfg)[3])}
    out = {"rows": _span(sharding.expert_rows(mesh_lib.make_expert_mesh(),
                                              8))}
    for name, (cfg, policy) in runs.items():
        shard = dataclasses.replace(cfg, engine_backend="shard")
        out[name] = _routed(shard, pool, policy, 2, steps[name])
        if rank == 0:
            out[name + " torch"] = _routed(
                dataclasses.replace(cfg, engine_backend="torch"), pool,
                policy, 2, steps[name])
    return out


def cli(rank, world, out_dir):
    """``launch/train.py --router --router-mesh`` in this world; rank 0
    also runs it unsharded."""
    argv = ["--router", "--device", "cpu", "--iters", "2", "--out"]
    mesh_out = os.path.join(out_dir, "mesh.npz")
    train.main(["--router-mesh"] + argv + [mesh_out])
    if rank == 0:
        train.main(argv + [os.path.join(out_dir, "plain.npz")])
    return {"wrote": os.path.exists(mesh_out) if rank == 0 else None}


def collective_ops(rank, world, _arg):
    """Both collectives of the reference and the port's gathers and sums,
    on every rank's share of numpy data from one seed."""
    mesh = mesh_lib.make_train_mesh()
    group = mesh.get_group(sharding.EXPERT)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(world, 64)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(512,)).astype(np.float32))
    ring = collectives.ring_allreduce(x[rank], mesh, sharding.EXPERT)
    avg, res = collectives.compressed_allreduce({"g": g}, mesh,
                                                sharding.EXPERT)
    # disjoint sums: each rank owns every world-th row, others give zeros
    # (-0.0 among the owned values must come back as -0.0)
    vals = torch.as_tensor(rng.normal(size=(8, 3)).astype(np.float32))
    vals[5, 1] = -0.0
    own = (torch.arange(8) % world == rank)[:, None]
    part = {"v": torch.where(own, vals, 0.0),
            "m": {"b": own[:, 0] & (vals[:, 0] > 0),
                  "i": torch.where(own[:, 0], torch.arange(8,
                                                           dtype=torch.int32),
                                   0)}}
    rows = {"v": vals[2 * rank:2 * rank + 2],
            "i": torch.arange(2 * rank, 2 * rank + 2, dtype=torch.int32)}
    return {"x": x, "g": g, "ring": ring, "avg": avg["g"], "res": res,
            "vals": vals, "sum": collectives.sum_disjoint(part, group),
            "gathered": collectives.gather_rows(rows, group)}


def _copies(tree):
    """Every tensor of ``tree`` in storage of its own (``torch.save`` refuses
    views of one buffer in two dtypes)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copies(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copies(x) for x in tree)
    return tree


CASES = {"iteration": iteration, "shard_engine": shard_engine, "cli": cli,
         "collectives": collective_ops, "shard_env": shard_env}


def run_world(case, world, tmp_path, arg=None):
    """``case`` of ``torch_dist_worker.py`` on ``world`` processes; returns
    each rank's result.  Fails when a rank exits with an error (the other
    ranks are killed) or the deadline passes."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"log{r}", "w")
        logs.append(log)
        cmd = [sys.executable, "-W", "ignore::FutureWarning", WORKER, case,
               str(r), str(world), str(tmp_path)]
        procs.append(subprocess.Popen(cmd + ([arg] if arg else []),
                                      stdout=log, stderr=subprocess.STDOUT,
                                      env=env))
    end = time.monotonic() + DEADLINE_S
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode not in (None, 0)), None)
            if time.monotonic() > end:
                failed = "deadline"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
    if failed is not None:
        rank = 0 if failed == "deadline" else failed
        tail = (tmp_path / f"log{rank}").read_text()[-3000:]
        raise AssertionError(f"{case}: rank {failed} failed\n{tail}")
    return [torch.load(tmp_path / f"{case}-{r}.pt", weights_only=False)
            for r in range(world)]


def main(argv):
    case, rank, world, out_dir = argv[:4]
    arg = argv[4] if len(argv) > 4 else ""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_lib.init_world("cpu", init_file=os.path.join(out_dir, "store"),
                        rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = CASES[case](rank, world, arg or out_dir)
    finally:
        mesh_lib.close_world()
    torch.save(_copies(out), os.path.join(out_dir, f"{case}-{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
