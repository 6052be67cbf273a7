"""One rank of a multi-process test of the port's sharded paths on the CPU,
and ``run_world``, which starts every rank of one.

    python tests/torch_dist_worker.py <case> <rank> <world> <dir> [arg]

Each rank joins a gloo world on a ``FileStore`` in ``dir``, runs ``case``
with one CPU thread (CPU reductions follow the thread count, so every
process that makes a compared tensor uses the same one), and saves what
it returns to ``dir/<case>-<rank>.pt`` for the tests to compare
(``tests/test_torch_distributed.py``, ``test_torch_collectives.py``,
``test_torch_mesh.py``).  Imports neither JAX nor the reference package.
"""
import contextlib
import datetime
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

WORKER = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(WORKER), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import sac as sac_lib, training  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.distributed.api import (MeshPolicy,  # noqa: E402
                                         use_mesh_policy)
from repro_torch.env import engine, engine_layout as layout  # noqa: E402
from repro_torch.env import env as env_lib, profiles  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, steps, train  # noqa: E402
from repro_torch.models import io as model_io, model as model_lib  # noqa: E402
from repro_torch.train import checkpoint, trainer as trainer_lib  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)     # each collective's
# each run's: the lm_mesh world takes ~28 s alone on 4 CPU processes and
# ~137 s beside five other pytest workers
DEADLINE_S = 300

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


# LM training on a mesh: reduced qwen1.5-0.5b (AdamW) with 2 KV heads, so
# the KV heads split over a model axis of 2 and stay whole on every rank of
# one of 4; reduced dbrx-132b (Adafactor, 2 microbatches); reduced
# whisper-medium (AdamW, 16 frames a row); 8 sequences of 16 tokens, 3
# steps after a warmup of one (the learning rates 0, peak and about half
# of it, so the parameters move far past the tests' tolerance).  dbrx's
# capacity factor of 2 gives every expert room for all 32 tokens of a data
# rank's microbatch, so neither the unsharded capacity nor the sharded one
# drops a token and the two runs compute the same function
LM_ARCHS = {"qwen1.5-0.5b": {"n_kv_heads": 2},
            "dbrx-132b": {"microbatches": 2, "capacity_factor": 2.0},
            "whisper-medium": {}}
# served beside LM_ARCHS: reduced rwkv6-7b (4 heads: 2 or 1 a rank);
# reduced recurrentgemma-2b with a tail, a window of 16 that its prompts of
# 22 pass (the ring wraps, and the decodes' slots cross from one rank's
# part to the next) and 6 query heads (split over 2 ranks, whole over 4);
# reduced granite-34b with its one KV head (the cache split by sequence: 8
# or 4 slots a rank, the last of 4 ranks empty after the prompt).  The
# recurrent two also train as LM_ARCHS do (TRAIN_ARCHS): rwkv6 with AdamW,
# recurrentgemma under remat with Adafactor (neither flag touches serving)
SERVE_ARCHS = {"rwkv6-7b": {},
               "recurrentgemma-2b": {"n_layers": 5, "window": 16,
                                     "n_heads": 6, "remat": True,
                                     "optimizer": "adafactor"},
               "granite-34b": {}}
TRAIN_ARCHS = (*LM_ARCHS, "rwkv6-7b", "recurrentgemma-2b")
# the 2 x 2 runs that checkpoint their step 2 under out_dir/<dir>
CKPT22 = {"qwen1.5-0.5b": "ckpt22", "recurrentgemma-2b": "ckpt22_rg"}
# the 2 x 2 runs whose state reshard_state moves onto these shapes
RESHARD_ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
RESHARD_SHAPES = ((4, 1), (1, 4))
# (prompt tokens, max_len) of the serving runs; the others' (8, 16)
SERVE_PROMPTS = {"recurrentgemma-2b": (22, 32)}
LM_BATCH, LM_SEQ, LM_STEPS = 8, 16, 3
LM_TRAIN = dict(total_steps=LM_STEPS, warmup_steps=1)
LM_SHAPES = ((2, 2), (4, 1), (1, 4))
SERVE_SHAPES = ((1, 4), (2, 2))
REPLICATED_BATCH = 6       # rows that do not split over a data axis of 4
# the residual stream split by sequence over model (cfg.seq_parallel), on
# the mesh shapes with a model axis: qwen, dbrx under remat too (its
# recompute repeats the layers' collectives), and a qwen whose 6 query
# heads and d_ff of 130 a model axis of 4 does not split (its layers
# gather their input and keep their rows), trained as in LM_ARCHS; their
# prefills of 4 prompts of each length, one that 4 divides and one that
# neither 4 nor 2 does (right-padded rows through ``lengths``)
SEQ_ARCHS = {"qwen1.5-0.5b": {"seq_parallel": True},
             "dbrx-132b": {"seq_parallel": True, "remat": True},
             "qwen1.5-0.5b whole": {"seq_parallel": True}}
# a name that is not an arch: (its arch, its overrides).  Beside SEQ_ARCHS'
# qwen, two rwkv6 trained on 1 x 4 (MIXED_RUNS), each with one of the
# channel mix's widths whole: d_ff = 130 (d splits, d_ff does not) and d =
# 50 in 5 heads of 10 (d_ff splits; the time mix whole on every rank)
VARIANTS = {"qwen1.5-0.5b whole": ("qwen1.5-0.5b",
                                   {"n_heads": 6, "d_ff": 130}),
            "rwkv6-7b ff": ("rwkv6-7b", {"d_ff": 130}),
            "rwkv6-7b narrow": ("rwkv6-7b", {"n_heads": 5, "head_size": 10,
                                             "d_model": 50})}
MIXED_RUNS = {"rwkv6-7b ff": (1, 4), "rwkv6-7b narrow": (1, 4)}
SEQ_SHAPES = ((1, 4), (2, 2))
SEQ_PROMPTS = (16, 13)
SEQ_MAX_LEN = 24


def lm_cfg(name, seq=False):
    """The reduced config of an arch of ``LM_ARCHS`` or ``SERVE_ARCHS``,
    or of a name of ``VARIANTS``; ``seq``: with its ``SEQ_ARCHS``
    overrides."""
    arch, extra = VARIANTS.get(name, (name, {}))
    over = dict(LM_ARCHS[arch] if arch in LM_ARCHS else SERVE_ARCHS[arch])
    over.update(extra)
    if seq:
        over.update(SEQ_ARCHS[name])
    return reduce_config(get_config(arch), **over)


def _encdec_batch(cfg, step, mesh, rows=LM_BATCH):
    """A whisper training batch of step ``step`` (seeded): frames (B, 16,
    d) and tokens (B, 16), this rank's rows on ``mesh``."""
    rng = np.random.default_rng(100 + step)
    batch = {"frames": torch.as_tensor(rng.standard_normal(
                 (rows, LM_SEQ, cfg.d_model)), dtype=torch.float32),
             "tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                    (rows, LM_SEQ)),
                                       dtype=torch.int32)}
    if mesh is not None:
        batch = {k: sharding.local_shard(
            x, sharding.data_spec(mesh, rows, x.dim()), mesh).contiguous()
            for k, x in batch.items()}
    return batch


def _lm_setup(arch, mesh, ckpt_dir, rows, seq=False):
    """(state, step function, batch(i), trainer or None) of ``arch``
    (``seq``: its ``SEQ_ARCHS`` config)."""
    cfg = lm_cfg(arch, seq)
    tc = trainer_lib.TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2,
                                   log_every=1, **LM_TRAIN)
    if cfg.family == "encdec":
        from repro_torch.train import optimizer as opt_lib

        model = model_lib.init_params(cfg, seed=0, device="cpu")
        params = (model_io.ShardedLM(model, cfg, mesh, train=True)
                  if mesh is not None else model)
        opt = opt_lib.make_optimizer(cfg.optimizer, peak_lr=tc.peak_lr,
                                     warmup_steps=tc.warmup_steps,
                                     total_steps=tc.total_steps)
        policy = (MeshPolicy(mesh, sharding.activation_rules(mesh,
                                                             train=True))
                  if mesh is not None else None)
        return (steps.train_state(cfg, params, opt),
                steps.make_train_step(cfg, policy),
                lambda i: _encdec_batch(cfg, i, mesh, rows), None)
    tr = trainer_lib.Trainer(cfg, tc, mesh=mesh, device="cpu",
                             log_fn=lambda *a, **k: None)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=LM_SEQ,
                                  global_batch=rows,
                                  microbatches=cfg.microbatches),
                       mesh=mesh, device="cpu")
    tr.bind(data)
    return tr.init_state(seed=0), tr._step_fn, data.batch, tr


def _live_after_forward(arch, st, batch, mesh, seq=False):
    """Weights gathered at their use still alive after a training
    forward (under the step's saved-tensor hooks), and after its
    backward."""
    cfg = lm_cfg(arch, seq)
    sp = st["params"]
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=True))
    first = {k: (x[0] if cfg.microbatches > 1 else x)
             for k, x in batch.items()}
    with use_mesh_policy(policy), sp.regathered():
        total, _ = model_lib.lm_loss(sp.model, cfg, first)
        after_forward = collectives.live_gathers()
        torch.autograd.grad(total, sp.compute_tensors(), allow_unused=True)
    return after_forward, collectives.live_gathers()


def _lm_run(arch, mesh, ckpt_dir="", rows=LM_BATCH, seq=False, keep=None):
    """``LM_STEPS`` training steps of ``arch`` (``seq``: its
    ``SEQ_ARCHS`` config) on ``mesh`` (None: one process): each step's
    metrics, the whole final state (gathered; every rank calls), the bytes
    of this rank's parameter and state blocks against the whole's, and
    the collectives' bytes of the first step; ``keep``, a dict, takes the
    final state."""
    st, step_fn, batch_of, tr = _lm_setup(arch, mesh, ckpt_dir, rows, seq)
    if keep is not None:
        keep["state"] = st
    # copies: a float32 leaf's numpy form shares the tensor's memory,
    # which the steps update in place
    init = {k: np.array(checkpoint._to_numpy(v)) for k, v in
            checkpoint._flatten(trainer_lib.tree(st)).items()
            } if mesh is None else None
    metrics, step_bytes = [], None
    for i in range(LM_STEPS):
        collectives.BYTES.clear()
        st, m = step_fn(st, batch_of(i))
        if i == 0:
            step_bytes = dict(collectives.BYTES)
        metrics.append({k: float(v) for k, v in m.items()})
        if ckpt_dir and i + 1 == 2:
            checkpoint.save(ckpt_dir, i + 1, trainer_lib.tree(st),
                            **tr._sharded(st))
    flat = checkpoint._flatten(trainer_lib.tree(st))
    specs = trainer_lib.tree_specs(st) if mesh is not None else {}
    size = lambda xs: sum(x.numel() * x.element_size() for x in
                          (xs if isinstance(xs, list) else [xs]))
    whole = {k: checkpoint._whole(v, specs.get(k), mesh) if mesh is not None
             else v for k, v in flat.items()}
    compute = (st["params"].compute_tensors() if mesh is not None
               else list(st["params"].parameters()))
    # every storage this rank keeps between steps, each once: the tensors
    # it computes with, its blocks and its optimizer state
    held = {}
    for x in compute + [x for v in flat.values() for x in
                        (v if isinstance(v, list) else [v])]:
        held[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
    out = {"metrics": metrics, "block_bytes": {k: size(v) for k, v in
                                                flat.items()},
           "whole_bytes": {k: size(v) for k, v in whole.items()},
           "compute_bytes": size(compute), "held_bytes": sum(held.values()),
           "compute_shapes": [tuple(x.shape) for x in compute],
           "specs": specs, "init": init, "step_bytes": step_bytes}
    if mesh is not None:
        out["gather_specs"] = {
            k: [getattr(x, "gather_spec", None) for x in
                (v if isinstance(v, list) else [v])]
            for k, v in st["params"].leaves.items()}
        out["live_gathers"] = _live_after_forward(arch, st, batch_of(0),
                                                  mesh, seq)
    if mesh is None or dist_rank() == 0:
        out["state"] = {k: checkpoint._to_numpy(v) for k, v in whole.items()}
    return out


def dist_rank():
    import torch.distributed as dist
    return dist.get_rank()


SERVE_DECODES = 3


def _serve(arch, mesh, policy):
    """A prefill of 4 prompts (8 tokens; whisper's 8 frames) and
    ``SERVE_DECODES`` greedy decode steps of reduced ``arch`` (serving
    weights, seed 1), under ``policy`` on this rank's rows: the logits of
    each step, the greedy tokens and the shapes of the cache's tensors."""
    cfg = lm_cfg(arch)
    model = model_lib.init_params(cfg, seed=1, device="cpu")
    params = (model_io.ShardedLM(model, cfg, mesh, train=False)
              if mesh is not None else model)
    rng = np.random.default_rng(2)
    encdec = cfg.family == "encdec"
    n, max_len = SERVE_PROMPTS.get(arch, (8, 16))
    prompt = (torch.as_tensor(rng.standard_normal((4, n, cfg.d_model)),
                              dtype=torch.float32) if encdec else
              torch.as_tensor(rng.integers(0, cfg.vocab, (4, n)),
                              dtype=torch.int32))
    if mesh is not None:
        prompt = sharding.local_shard(
            prompt, sharding.data_spec(mesh, 4, prompt.dim()),
            mesh).contiguous()
    prefill = steps.make_prefill_step(cfg, max_len, policy)
    decode = steps.make_decode_step(cfg, policy)
    out = []
    if encdec:
        cache = prefill(params, {"frames": prompt})
        token = torch.zeros(prompt.shape[0], dtype=torch.int32)
    else:
        logits, cache = prefill(params, prompt)
        out.append(logits)
        token = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
    shapes = cache_shapes(cache)
    tokens = [token]
    for _ in range(SERVE_DECODES):
        logits, cache = decode(params, cache, token)
        out.append(logits)
        token = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        tokens.append(token)
    return {"logits": torch.stack(out), "tokens": torch.stack(tokens),
            "cache_shapes": shapes}


def _seq_prefill(arch, mesh, seq):
    """Prefills of reduced ``arch`` (serving weights, seed 1; ``seq``: its
    ``SEQ_ARCHS`` config) under a serving policy on ``mesh``, 4 prompts
    of each length in ``SEQ_PROMPTS`` on this rank's rows, the second
    right-padded through ``lengths``: per length the whole logits, the
    cache and the bytes by reader."""
    cfg = lm_cfg(arch, seq)
    params = model_io.ShardedLM(model_lib.init_params(cfg, seed=1,
                                                      device="cpu"),
                                cfg, mesh, train=False)
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    rng = np.random.default_rng(4)
    rows = lambda x: sharding.local_shard(
        x, sharding.data_spec(mesh, 4, x.dim()), mesh).contiguous()
    out = {}
    for n in SEQ_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, n)),
                               dtype=torch.int32)
        kw = ({} if n % 4 == 0 else
              {"lengths": rows(torch.tensor([n, n - 3, n, 2],
                                            dtype=torch.int32))})
        collectives.BYTES.clear()
        with use_mesh_policy(policy), torch.no_grad():
            logits, cache = model_lib.prefill(params.model, cfg, rows(toks),
                                              SEQ_MAX_LEN, **kw)
            logits = steps._whole_logits(logits, cfg, policy)
        out[n] = {"logits": logits, "cache": cache,
                  "bytes": dict(collectives.BYTES)}
    return out


def cache_shapes(cache, prefix=""):
    """Every tensor's shape in a cache, by its ``/``-joined key path
    (a list's entries by index)."""
    if isinstance(cache, torch.Tensor):
        return {prefix: tuple(cache.shape)}
    items = (cache.items() if isinstance(cache, dict)
             else enumerate(cache))
    out = {}
    for k, x in items:
        out.update(cache_shapes(x, f"{prefix}/{k}" if prefix else str(k)))
    return out


def moe_dp_inputs():
    """Reduced dbrx's MoE in float32 with a capacity factor of 0.5, so
    assignments drop: its weights (taking gradients), 64 tokens and the
    (64, d) weights of a test loss ``(y * c).sum() + 3 * aux``."""
    from repro_torch.models import moe

    cfg = reduce_config(get_config("dbrx-132b"), capacity_factor=0.5)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator().manual_seed(5)
    new = lambda *shape: torch.randn(shape, generator=g).requires_grad_(True)
    p = types.SimpleNamespace(router=new(d, e), w_gate=new(e, d, f),
                              w_up=new(e, d, f), w_down=new(e, f, d))
    return cfg, p, torch.randn(64, d, generator=g), torch.randn(64, d,
                                                                generator=g)


def moe_dp_grads(y, aux, c, p, x):
    """The test loss's gradients: x's, then the router's and experts'."""
    return torch.autograd.grad((y * c).sum() + 3 * aux,
                               [x, p.router, p.w_gate, p.w_up, p.w_down])


def _moe_data_parallel(mesh):
    """``moe_dp_inputs``' MoE through ``_moe_data_parallel`` on this data
    rank's rows: served, and trained (output, aux, the gradients)."""
    from repro_torch.models import moe

    cfg, p, x, c = moe_dp_inputs()
    i, n = sharding.block_index(mesh, sharding.data_axes(mesh))
    t = x.shape[0] // n
    rows, c = x[i * t:(i + 1) * t].clone(), c[i * t:(i + 1) * t]
    with torch.no_grad():
        serve, serve_aux = moe._moe_data_parallel(p, rows, cfg, mesh)
    rows.requires_grad_(True)
    y, aux = moe._moe_data_parallel(p, rows, cfg, mesh, train=True)
    return {"serve": serve, "serve_aux": serve_aux, "y": y.detach(),
            "aux": aux.detach(), "grads": moe_dp_grads(y, aux, c, p, rows)}


def lm_mesh(rank, world, out_dir):
    """LM training on ``make_host_mesh`` of every shape in ``LM_SHAPES``
    for every arch (qwen's 2 x 2 run also checkpoints step 2 under
    ``out_dir/ckpt22``), qwen on 4 x 1 with a batch that does not split
    over the data axis, and every arch served under a policy of each
    shape in ``SERVE_SHAPES``; on the shapes in ``SEQ_SHAPES`` the
    ``SEQ_ARCHS`` trained and prefilled with the residual stream split by
    sequence (and their prefills without); rank 0 also runs all of it in
    one process."""
    out = {}
    for shape in LM_SHAPES:
        mesh = mesh_lib.make_host_mesh(*shape)
        out[f"coord{shape}"] = tuple(sharding.axis_index(mesh, a)
                                     for a in ("data", "model"))
        for arch in TRAIN_ARCHS:
            ckpt = (os.path.join(out_dir, CKPT22[arch])
                    if shape == (2, 2) and arch in CKPT22 else "")
            keep = {}
            out[f"{arch} {shape}"] = _lm_run(arch, mesh, ckpt, keep=keep)
            if shape == (2, 2) and arch in RESHARD_ARCHS:
                out[f"reshard {arch}"] = _reshards(arch, keep["state"],
                                                   out_dir)
            del keep
        for arch in [a for a, at in MIXED_RUNS.items() if at == shape]:
            out[f"{arch} {shape}"] = _lm_run(arch, mesh)
        if shape == (4, 1):
            out["moe data parallel"] = _moe_data_parallel(mesh)
            out["qwen replicated rows"] = _lm_run(
                "qwen1.5-0.5b", mesh, rows=REPLICATED_BATCH)
        if shape in SEQ_SHAPES:
            for arch in SEQ_ARCHS:
                if arch in VARIANTS:
                    out[f"{arch} {shape}"] = _lm_run(arch, mesh)
                out[f"{arch} {shape} seq"] = _lm_run(arch, mesh, seq=True)
                for seq in (False, True):
                    out[f"prefill {arch} {shape} seq={seq}"] = _seq_prefill(
                        arch, mesh, seq)
        if shape in SERVE_SHAPES:
            policy = MeshPolicy(mesh, sharding.activation_rules(mesh,
                                                                train=False))
            for arch in (*LM_ARCHS, *SERVE_ARCHS):
                collectives.BYTES.clear()
                out[f"serve {arch} {shape}"] = _serve(arch, mesh, policy)
                out[f"serve bytes {arch} {shape}"] = dict(collectives.BYTES)
    if rank == 0:
        for arch in (*TRAIN_ARCHS, *VARIANTS):
            out[f"{arch} plain"] = _lm_run(arch, None)
        for arch in (*LM_ARCHS, *SERVE_ARCHS):
            out[f"serve {arch} plain"] = _serve(arch, None, None)
        out["qwen replicated rows plain"] = _lm_run(
            "qwen1.5-0.5b", None, rows=REPLICATED_BATCH)
        # dbrx alone with the load-balancing loss of each half of a
        # microbatch's tokens averaged: the 2 x 2 mesh's, whose aux is
        # each data rank's averaged over ``data`` (the reference's pmean)
        with data_rank_aux(2):
            out["dbrx-132b plain data-rank aux"] = _lm_run("dbrx-132b", None)
    return out


def _local(state) -> dict:
    """A train state's blocks on this rank by checkpoint path, as numpy
    (stacked leaves stacked)."""
    return {k: np.array(checkpoint._to_numpy(v)) for k, v in
            checkpoint._flatten(trainer_lib.tree(state)).items()}


def _reshards(arch, state, out_dir):
    """``state`` (``arch`` after ``LM_STEPS`` steps on 2 x 2) moved by
    ``reshard_state`` onto each of ``RESHARD_SHAPES``, and, beside it, the
    same state saved on 2 x 2 and restored into a fresh ``Trainer`` state
    on that mesh: this rank's blocks of both, and their specs."""
    from repro_torch.distributed import fault_tolerance

    cfg = lm_cfg(arch)
    ckpt = os.path.join(out_dir, f"reshard {arch}")
    checkpoint.save(ckpt, LM_STEPS, trainer_lib.tree(state),
                    mesh=state["params"].mesh,
                    specs=trainer_lib.tree_specs(state))
    out = {}
    for shape in RESHARD_SHAPES:
        mesh = mesh_lib.make_host_mesh(*shape)
        moved = fault_tolerance.reshard_state(state, mesh)
        tr = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**LM_TRAIN),
                                 mesh=mesh, device="cpu")
        restored = tr.init_state(seed=1)
        checkpoint.restore(ckpt, trainer_lib.tree(restored),
                           **tr._sharded(restored))
        out[shape] = {"moved": _local(moved), "restored": _local(restored),
                      "specs": trainer_lib.tree_specs(moved),
                      "restored_specs": trainer_lib.tree_specs(restored),
                      "step": int(moved["step"])}
    return out


@contextlib.contextmanager
def data_rank_aux(n_data):
    """The MoE's load-balancing loss as the mean of the losses of
    ``n_data`` equal, consecutive blocks of its tokens: a data rank's
    rows of a microbatch are such a block."""
    from repro_torch.models import moe

    real = moe._aux_loss

    def aux(probs, ids, e):
        t = probs.shape[0] // n_data
        parts = [real(probs[j * t:(j + 1) * t], ids[j * t:(j + 1) * t], e)
                 for j in range(n_data)]
        return sum(parts[1:], parts[0]) / n_data

    moe._aux_loss = aux
    try:
        yield
    finally:
        moe._aux_loss = real


def lm_cli(rank, world, out_dir):
    """``launch/train.py --data-parallel 2`` on reduced qwen in this world
    (its parameters gathered whole; checkpoints under ``out_dir/cli_ckpt``),
    ``--production-mesh`` refused, and ``--model-parallel 2`` on reduced
    recurrentgemma-2b; rank 0 also runs both without a mesh."""
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--steps", "2", "--global-batch", "4", "--seq-len", "16"]
    rg = ["--arch", "recurrentgemma-2b"] + argv[2:]
    logs = []
    state, trainer = train.train_lm_main(train.parser().parse_args(
        argv + ["--data-parallel", "2", "--ckpt-dir",
                os.path.join(out_dir, "cli_ckpt")]), log_fn=logs.append)
    out = {"params": model_io.sharded_params_to_numpy(state["params"]),
           "logs": logs, "mesh": str(trainer.mesh)}
    try:
        train.main(argv + ["--production-mesh"])
    except ValueError as e:
        out["production"] = str(e)
    state, trainer = train.main(rg + ["--model-parallel", "2"])
    out["rg_params"] = model_io.sharded_params_to_numpy(state["params"])
    out["rg_mesh"] = str(trainer.mesh)
    if rank == 0:
        for key, args, arch in (("plain", argv, "qwen1.5-0.5b"),
                                ("rg_plain", rg, "recurrentgemma-2b")):
            plain, _ = train.main(args)
            cfg = reduce_config(get_config(arch))
            out[key] = {k: checkpoint._to_numpy(v) for k, v in
                        model_io.reference_groups(plain["params"],
                                                  cfg).items()}
    return out


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
         "collectives": collective_ops, "shard_env": shard_env,
         "lm_mesh": lm_mesh, "lm_cli": lm_cli}


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
