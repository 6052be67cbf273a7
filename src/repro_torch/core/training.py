"""SAC training of the router and policy evaluation (port of
``repro/core/training.py``).

The reference runs ``evaluate`` as ``jax.jit(jax.vmap(run_one))`` over a
``lax.scan`` of routing steps.  On CUDA the port runs each routing step as
one CUDA graph (``RoutingLoop``): the env state, the policy state and the
reward sum live in static tensors that a step updates in place, the first
step runs eagerly (it makes what a capture cannot: constants copied from
the host, loaded libraries) and is then captured, and every later step
replays the capture.  The env's and the policy's generators are registered
with the graph, so a replay draws what the eager step would.  On the CPU,
and with ``graphs=False`` on CUDA, the same steps run eagerly; both give
the same metrics and final state bit for bit.

Training (``train_router``) runs the reference's iteration: ``collect_steps``
env steps per env (observe -> sample an action -> env step -> reward ->
insert into the replay buffer), then, once the buffer holds
``warmup_transitions``, ``updates_per_iter`` SAC updates (sample -> losses
-> gradients -> clip -> AdamW -> polyak).  The reference jits the whole
iteration with donated buffers; here every collect step and every update
is one CUDA graph replay over static tensors (``Iteration``): parameters,
moments, the AdamW step, the env state, the observation and the buffer
keep their storage and are updated in place, and the env, action and
sample generators are registered with the graphs.  The host knows the
buffer's size without reading it, so it decides the warmup with no sync.
``graphs=False``, and the CPU, run the same steps eagerly; graphed and
eager training from the same seeds give the same bits.

The reference's quirks are kept: every update of an iteration uses the
same AdamW step, ``it * updates_per_iter``; the observation rides the
collect loop, so ``build_obs`` runs once per env step; the discount is 1;
an iteration that skips its updates reports the reference's dummy ``aux``.

Sharded training (``init_train_state``/``make_iteration``/``train_router``
with ``mesh=``, a mesh of ``launch.mesh.make_train_mesh``): every rank
runs the same iteration on the same parameters, AdamW state and
generators (all seeded alike from ``tc.seed``), and the replay buffer's
capacity splits over the mesh's ``expert`` axis.  A collect step inserts
with ``replay.shard_add_batch``; an update samples with
``replay.shard_sample_local`` and one ``all_reduce`` over ``expert``
(``distributed.collectives.sum_disjoint``), so every rank updates on the
unsharded batch.  On a 2-D ``("data", "expert")`` mesh each rank also
steps only its ``n_envs / k`` envs: actions come from the whole
observation (the same on every rank) and each rank keeps its envs';
its envs draw their arrivals and requests for the whole batch and keep
their rows (``env.step(rows=)``), so each env sees the numbers it sees
unsharded; rewards and next observations are gathered over ``data``
(``collectives.gather_rows``) before the insert.  The result is the
unsharded run's, bit for bit.  On CUDA the collectives are captured in
the collect and update graphs like any other launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import features, replay, sac as sac_lib
from repro_torch.device import generator
from repro_torch.distributed import collectives, sharding
from repro_torch import graphs
from repro_torch.env import env as env_lib
from repro_torch.graphs import StepGraph
from repro_torch.train import optimizer as opt_lib

# entries of an env state that a step never replaces
_FIXED = ("gen", "par", "wait_caps", "shard")


def _own(tree):
    """A copy of every tensor of a state tree but the fixed entries, so
    the copy's tensors are the loop's alone to update in place."""
    return {k: (x if k in _FIXED or x is None else
                _own(x) if isinstance(x, dict) else x.clone())
            for k, x in tree.items()}


def _copy_(dst: dict, src: dict) -> None:
    """``src`` into ``dst``'s tensors, in place (the fixed entries and
    tensors a step returned unchanged are skipped)."""
    for k, d in dst.items():
        if k in _FIXED:
            continue
        s = src[k]
        if isinstance(d, dict):
            _copy_(d, s)
        elif d is not s:
            d.copy_(s)


class RoutingLoop:
    """``n_envs`` envs routed by ``policy`` over static tensors: ``state``
    (the env state), ``pstate`` (the policy's) and ``rew_sum`` keep their
    storage, and ``step`` updates them in place.  ``run(n, graphs=True)``
    on CUDA runs the first step eagerly, captures ``step`` as a CUDA graph
    and replays it; otherwise every step runs eagerly.

    ``draws`` injects every random draw of the envs, as ``evaluate`` takes
    it; each step's draws are copied into static buffers before the step.
    """

    def __init__(self, env_cfg: env_lib.EnvConfig, pool, policy,
                 n_envs: int, seed: int = 1234, *,
                 draws: Optional[dict] = None):
        dev = pool.k1.device
        self.cfg, self.pool, self.policy = env_cfg, pool, policy
        self.env_gen = generator(dev, seed)
        self.act_gen = generator(dev, seed + 1)
        state = env_lib.reset(env_cfg, pool, self.env_gen, n_envs,
                              pending=None if draws is None
                              else draws["pending0"])
        self.state = _own(state)
        self.pstate = _own(policy.init_state(n_envs, dev))
        self.rew_sum = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
        self.draws = draws
        self.draw_buf = None if draws is None else {
            "clock": torch.empty_like(draws["clock"][0], device=dev),
            "pending": {k: torch.empty_like(v[0], device=dev)
                        for k, v in draws["pending"].items()}}
        self.steps = 0
        self.graph: Optional[StepGraph] = None

    # the step's three layers, each over the static tensors
    def observe(self):
        if self.policy.obs_fmt is None:
            return None
        return features.build_obs(self.cfg, self.pool, self.state,
                                  fmt=self.policy.obs_fmt)

    def act(self, obs) -> torch.Tensor:
        a, pstate = self.policy.act(self.pstate, self.state, obs, self.act_gen)
        _copy_(self.pstate, pstate)
        return a

    def apply(self, action: torch.Tensor) -> None:
        state, r, _ = env_lib.step(self.cfg, self.pool, self.state, action,
                                   draws=self.draw_buf)
        _copy_(self.state, state)
        self.rew_sum.add_(r)

    def step(self) -> None:
        self.apply(self.act(self.observe()))

    def capture(self) -> StepGraph:
        """``step`` as a CUDA graph (once)."""
        if self.graph is None:
            self.graph = StepGraph(self.step,
                                   generators=(self.env_gen, self.act_gen))
        return self.graph

    def run(self, n_steps: int, graphs: bool = True) -> None:
        capture = graphs and self.rew_sum.is_cuda
        for _ in range(n_steps):
            if self.draws is not None:
                self.draw_buf["clock"].copy_(self.draws["clock"][self.steps])
                for k, buf in self.draw_buf["pending"].items():
                    buf.copy_(self.draws["pending"][k][self.steps])
            if capture and self.graph is not None:
                self.graph.replay()
            else:
                self.step()
                if capture:
                    self.capture()
            self.steps += 1

    def metrics(self) -> dict:
        out = {k: float(v.mean())
               for k, v in env_lib.episode_metrics(self.state).items()}
        out["mean_reward"] = float((self.rew_sum / self.steps).mean())
        return out


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def evaluate(env_cfg: env_lib.EnvConfig, pool, policy, n_steps: int = 5000,
             seed: int = 1234, n_envs: int = 4, *,
             draws: Optional[dict] = None, return_state: bool = False,
             graphs: bool = True, timing: Optional[dict] = None):
    """Run ``policy`` on ``n_envs`` envs for ``n_steps`` routing decisions
    each, on the pool's device; returns the paper metrics averaged over
    envs, as floats (and the final env state with ``return_state``).

    ``draws`` injects every random draw of the envs: ``{"pending0": first
    pending request, "clock": (n_steps, B) arrival times, "pending": each
    field stacked (n_steps, B, ...)}``.  Without it the envs draw from a
    generator seeded with ``seed``; the policy's own draws use a second
    one.  A policy with ``obs_fmt=None`` gets no observation.

    On CUDA every step after the first is a CUDA graph replay
    (``RoutingLoop``); with ``graphs=False``, and on the CPU, every step
    runs eagerly.  ``timing``, a dict, receives the synchronised seconds of
    the first step (with the capture, when graphed) as ``first_s`` and of
    the rest as ``rest_s``."""
    if n_steps < 1:
        raise ValueError("n_steps must be at least 1")
    dev = pool.k1.device
    t0 = _sync(dev)
    loop = RoutingLoop(env_cfg, pool, policy, n_envs, seed, draws=draws)
    loop.run(1, graphs)
    t1 = _sync(dev)
    loop.run(n_steps - 1, graphs)
    if timing is not None:
        timing["first_s"] = t1 - t0
        timing["rest_s"] = _sync(dev) - t1
    out = loop.metrics()
    return (out, loop.state) if return_state else out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_envs: int = 16
    collect_steps: int = 8        # env steps per env per iteration
    updates_per_iter: int = 8
    batch_size: int = 256
    buffer_capacity: int = 100_000
    warmup_transitions: int = 2_000
    iterations: int = 400
    lr: float = 3e-4
    qos_reward: bool = True       # False -> Baseline RL reward (no penalty)
    zero_score_pred: bool = False  # Fig. 18 ablations
    zero_len_pred: bool = False
    seed: int = 0
    log_every: int = 25
    # z-score threshold on iteration wall time (distributed.
    # fault_tolerance.StragglerDetector); None disables.  Flagged
    # iterations are counted into the history (``straggler_flags``) and
    # reported through ``log_fn``.
    straggler_z: Optional[float] = None
    # observation layout fed to the HAN: "padded" or "segments"
    obs_fmt: str = "padded"


def _maybe_zero_preds(tc: TrainConfig, obs: dict) -> dict:
    """The Fig. 18 ablations: zero the predicted score and/or length
    channels of the expert, arrived and request nodes."""
    if not (tc.zero_score_pred or tc.zero_len_pred):
        return obs
    obs = dict(obs)
    exp, arr = obs["expert"].clone(), obs["arrived"].clone()
    req_keys = ("req",) if "req" in obs else ("run", "wait")
    req = {k: obs[k].clone() for k in req_keys}
    for on, e_ch, a_ch, r_ch in ((tc.zero_score_pred, 3, 1,
                                  features.REQ_PRED_S),
                                 (tc.zero_len_pred, 4, 2,
                                  features.REQ_PRED_D)):
        if on:
            exp[..., e_ch] = 0.0
            arr[..., a_ch] = 0.0
            for x in req.values():
                x[..., r_ch] = 0.0
    obs.update(expert=exp, arrived=arr, **req)
    return obs


def make_reward_fn(tc: TrainConfig):
    """QoS-aware (Eq. 16) reward, or the Baseline RL's completions only."""
    def reward(env_state, action, info):
        return info["reward"] if tc.qos_reward else info["phi"]
    return reward


def make_adamw(tc: TrainConfig, sac: sac_lib.SAC) -> opt_lib.AdamW:
    """The reference trainer's AdamW over ``sac``'s trainable parameters:
    warmup 100 steps, cosine over every update, no weight decay, gradients
    clipped at norm 10."""
    return opt_lib.AdamW(sac_lib.trainable(sac), opt_lib.OptimizerConfig(
        peak_lr=tc.lr, warmup_steps=100,
        total_steps=tc.iterations * tc.updates_per_iter, weight_decay=0.0,
        grad_clip=10.0))


@dataclasses.dataclass
class TrainState:
    """Everything an iteration updates in place: the router, its AdamW
    state, the envs (state and current observation), the replay buffer and
    the generators of the env, the actions and the samples."""
    sac: sac_lib.SAC
    opt: opt_lib.AdamW
    env: dict
    obs: dict
    buf: dict
    env_gen: torch.Generator
    act_gen: torch.Generator
    sample_gen: torch.Generator
    mesh: Optional[object] = None

    def tensors(self) -> dict:
        """Every tensor of the state by name, the generators aside:
        parameters, moments and AdamW step, buffer, env state, observation."""
        out = {f"param {k}": x for k, x in self.sac.state_dict().items()}
        for side in ("m", "v"):
            out.update((f"{side} {k}", x)
                       for k, x in getattr(self.opt, side).items())
        out["step"] = self.opt.step

        def walk(prefix, tree):
            for k, x in tree.items():
                if isinstance(x, dict):
                    walk(f"{prefix} {k}", x)
                elif isinstance(x, torch.Tensor):
                    out[f"{prefix} {k}"] = x
        for name in ("buf", "env", "obs"):
            walk(name, getattr(self, name))
        return out


def _obs_of(env_cfg, pool, tc: TrainConfig, env_state) -> dict:
    return _maybe_zero_preds(tc, features.build_obs(env_cfg, pool, env_state,
                                                    fmt=tc.obs_fmt))


class _Placement:
    """Where an iteration's work lives on ``mesh`` (module docstring):
    the replay shard this rank holds, and on a ``data`` axis the envs it
    steps (``rows``, ``envs``) and the group that gathers them.  Without a
    mesh, everything is here."""

    def __init__(self, mesh, tc: TrainConfig):
        self.rows, self.envs, self.n_envs = None, slice(None), tc.n_envs
        self.shard, self.n_shards = 0, 1
        self.data_group = self.expert_group = None
        if mesh is None:
            return
        names = mesh.mesh_dim_names or ()
        if sharding.EXPERT not in names:
            raise ValueError(
                f"training mesh has no '{sharding.EXPERT}' axis: {mesh}")
        self.n_shards = sharding.replay_shards(mesh, tc.buffer_capacity)
        self.shard = sharding.axis_index(mesh, sharding.EXPERT)
        self.expert_group = mesh.get_group(sharding.EXPERT)
        if sharding.DATA in names:
            per = tc.n_envs // sharding.data_shards(mesh, tc.n_envs)
            lo = sharding.axis_index(mesh, sharding.DATA) * per
            self.rows, self.envs, self.n_envs = ((lo, tc.n_envs),
                                                 slice(lo, lo + per), per)
            self.data_group = mesh.get_group(sharding.DATA)

    def gather(self, tree):
        """This rank's env rows of ``tree`` -> the whole batch's."""
        if self.data_group is None:
            return tree
        return collectives.gather_rows(tree, self.data_group)

    def insert(self, buf, *transitions) -> None:
        if self.expert_group is None:
            replay.add_batch(buf, *transitions)
        else:
            replay.shard_add_batch(buf, *transitions, shard_idx=self.shard,
                                   n_shards=self.n_shards)

    def sample(self, buf, gen, batch_size, idx=None) -> dict:
        if self.expert_group is None:
            return replay.sample(buf, gen, batch_size, idx=idx)
        part = replay.shard_sample_local(buf, gen, batch_size,
                                         shard_idx=self.shard,
                                         n_shards=self.n_shards, idx=idx)
        return collectives.sum_disjoint(part, self.expert_group)


def init_train_state(env_cfg: env_lib.EnvConfig, sac_cfg: sac_lib.SACConfig,
                     tc: TrainConfig, pool, *,
                     sac: Optional[sac_lib.SAC] = None,
                     pending: Optional[dict] = None,
                     mesh=None) -> TrainState:
    """A fresh ``TrainState`` on the pool's device: the router from
    ``sac_lib.init_params(seed=tc.seed)`` (or ``sac``), zero moments,
    ``tc.n_envs`` envs reset (with ``pending`` injected as their first
    requests, if given), an empty buffer of ``tc.buffer_capacity``, and
    generators seeded from ``tc.seed``.  With ``mesh`` the buffer holds
    this rank's shard of the capacity and, on a ``data`` axis, the env
    state this rank's envs (the observation stays whole)."""
    dev = pool.k1.device
    place = _Placement(mesh, tc)
    if sac is None:
        sac = sac_lib.init_params(sac_cfg, seed=tc.seed, device=dev)
    opt = make_adamw(tc, sac)
    seeds = [tc.seed * 4 + i for i in range(1, 4)]
    env_gen, act_gen, sample_gen = (generator(dev, x) for x in seeds)
    env = _own(env_lib.reset(env_cfg, pool, env_gen, place.n_envs,
                             pending=pending, rows=place.rows))
    obs = _own(place.gather(_obs_of(env_cfg, pool, tc, env)))
    buf = replay.init(tc.buffer_capacity, {k: v[0] for k, v in obs.items()},
                      device=dev)
    if mesh is not None:
        buf = sharding.shard_replay_buffer(buf, mesh)
    return TrainState(sac, opt, env, obs, buf, env_gen, act_gen, sample_gen,
                      mesh)


class Iteration:
    """The collect/update iteration over a ``TrainState``, in place.

    ``it(i)`` runs iteration ``i`` and returns its ``aux`` (device
    scalars: the mean of each ``sac.AUX_KEYS`` over the updates, or the
    reference's dummy when the buffer is below the warmup, and
    ``collect_reward``).  On CUDA with ``graphs`` the first collect step
    and the first update run eagerly (the update on a side stream, which
    warms it up for capture) and are then captured; every later one
    replays its graph.  ``draws`` injects every random draw, for each call
    in turn: ``{"action": (I, S, B), "clock": (I, S, B), "pending": each
    field (I, S, B, ...), "sample_idx": (I, U, batch)}``, copied into
    static buffers before each step.  ``mesh`` runs the sharded iteration
    (module docstring) on a state ``init_train_state`` placed on it."""

    def __init__(self, env_cfg, tc: TrainConfig, pool, state: TrainState,
                 *, graphs: bool = True, draws: Optional[dict] = None,
                 mesh=None):
        if mesh is not None:
            if env_cfg.engine_backend == "shard":
                raise ValueError(
                    "engine_backend='shard' cannot nest inside the sharded "
                    "training iteration; use 'torch' or 'cuda' for the env "
                    "engine")
            if draws is not None:
                raise ValueError("draws= injects the unsharded iteration's "
                                 "draws; a sharded iteration draws its own")
        self.place = _Placement(mesh, tc)
        if mesh is not state.mesh:
            raise ValueError("make_iteration needs the mesh init_train_state "
                             f"placed the state on ({state.mesh})")
        self.cfg, self.tc, self.pool, self.st = env_cfg, tc, pool, state
        dev = pool.k1.device
        self.capture = graphs and dev.type == "cuda"
        self.reward_fn = make_reward_fn(tc)
        self.params = list(state.opt.params.values())
        self.rew_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.aux_sum = torch.zeros((len(sac_lib.AUX_KEYS),),
                                   dtype=torch.float32, device=dev)
        self.size = 0          # the buffer's size, known on the host
        self.calls = 0
        self.draws = draws
        self.draw_buf = None
        if draws is not None:
            first = lambda x: torch.empty_like(x[0, 0], device=dev)
            self.draw_buf = {"action": first(draws["action"]),
                             "clock": first(draws["clock"]),
                             "pending": {k: first(v) for k, v in
                                         draws["pending"].items()},
                             "sample_idx": first(draws["sample_idx"])}
        self.collect_graph: Optional[StepGraph] = None
        self.update_graph: Optional[StepGraph] = None

    @torch.no_grad()
    def collect_step(self) -> None:
        st, tc, place = self.st, self.tc, self.place
        if self.draw_buf is None:
            a = sac_lib.act(st.sac, st.obs, st.act_gen)
            env_draws = None
        else:
            a = self.draw_buf["action"].long()
            env_draws = {"clock": self.draw_buf["clock"],
                         "pending": self.draw_buf["pending"]}
        a_own = a[place.envs]
        env2, _, info = env_lib.step(self.cfg, self.pool, st.env, a_own,
                                     draws=env_draws, rows=place.rows)
        got = place.gather({"rew": self.reward_fn(st.env, a_own, info),
                            "obs": _obs_of(self.cfg, self.pool, tc, env2)})
        rew, next_obs = got["rew"], got["obs"]
        place.insert(st.buf, st.obs, a, rew, torch.ones_like(rew), next_obs)
        _copy_(st.env, env2)
        _copy_(st.obs, next_obs)
        self.rew_sum.add_(rew.mean())

    def update_step(self) -> None:
        st, tc = self.st, self.tc
        idx = None if self.draw_buf is None else self.draw_buf["sample_idx"]
        batch = self.place.sample(st.buf, st.sample_gen, tc.batch_size,
                                  idx=idx)
        with torch.enable_grad():
            loss, aux = sac_lib.losses(st.sac, batch)
            grads = sac_lib.grads(loss, self.params)
        st.opt.update(grads)
        sac_lib.polyak(st.sac)
        self.aux_sum.add_(torch.stack([aux[k] for k in sac_lib.AUX_KEYS]))

    def _run(self, which: str) -> None:
        st = self.st
        graph = getattr(self, f"{which}_graph")
        if self.capture and graph is not None:
            graph.replay()
            return
        if which == "update":
            if self.capture:
                self.update_graph, _ = graphs.capture(self.update_step,
                                                      (st.sample_gen,))
            else:
                self.update_step()
            return
        self.collect_step()
        if self.capture:
            self.collect_graph = StepGraph(
                self.collect_step, generators=(st.env_gen, st.act_gen))

    def _inject(self, key: str, k: int) -> None:
        if self.draws is None:
            return
        i = self.calls
        if key == "collect":
            for name in ("action", "clock"):
                self.draw_buf[name].copy_(self.draws[name][i, k])
            for f, buf in self.draw_buf["pending"].items():
                buf.copy_(self.draws["pending"][f][i, k])
        else:
            self.draw_buf["sample_idx"].copy_(self.draws["sample_idx"][i, k])

    def __call__(self, it: int) -> dict:
        st, tc = self.st, self.tc
        self.rew_sum.zero_()
        for k in range(tc.collect_steps):
            self._inject("collect", k)
            self._run("collect")
        self.size = min(self.size + tc.n_envs * tc.collect_steps,
                        tc.buffer_capacity)
        if self.size >= tc.warmup_transitions:
            st.opt.step.fill_(it * tc.updates_per_iter)
            self.aux_sum.zero_()
            for k in range(tc.updates_per_iter):
                self._inject("update", k)
                self._run("update")
            means = self.aux_sum / tc.updates_per_iter
            aux = dict(zip(sac_lib.AUX_KEYS, means.unbind()))
        else:
            zero = torch.zeros_like(self.rew_sum)
            aux = {k: zero for k in sac_lib.AUX_KEYS}
            aux["alpha"] = torch.exp(st.sac.log_alpha.detach())
        aux["collect_reward"] = self.rew_sum / tc.collect_steps
        self.calls += 1
        return aux


def make_iteration(env_cfg: env_lib.EnvConfig, tc: TrainConfig, pool,
                   state: TrainState, *, graphs: bool = True,
                   draws: Optional[dict] = None, mesh=None) -> Iteration:
    """The collect/update iteration over ``state`` (``Iteration``), sharded
    over ``mesh`` when given (module docstring)."""
    return Iteration(env_cfg, tc, pool, state, graphs=graphs, draws=draws,
                     mesh=mesh)


def train_router(env_cfg: env_lib.EnvConfig, sac_cfg: sac_lib.SACConfig,
                 tc: TrainConfig, *, pool=None,
                 log_fn: Optional[Callable] = None, graphs: bool = True,
                 mesh=None) -> Tuple[sac_lib.SAC, list]:
    """Train a router for ``tc.iterations`` iterations; returns (the trained
    ``SAC``, history).  The history holds a dict of floats every
    ``tc.log_every`` iterations and at the last: the ``aux`` keys,
    ``iteration``, ``transitions``, ``elapsed_s`` and, with
    ``tc.straggler_z``, ``straggler_flags``.  Only those iterations (and,
    with straggler detection, every iteration's end) wait for the
    device.  ``mesh`` shards the training (module docstring): every rank
    returns the same router."""
    if pool is None:
        pool = env_lib.make_env_pool(env_cfg)
    dev = pool.k1.device
    state = init_train_state(env_cfg, sac_cfg, tc, pool, mesh=mesh)
    iteration = make_iteration(env_cfg, tc, pool, state, graphs=graphs,
                               mesh=mesh)
    detector = None
    if tc.straggler_z is not None:
        from repro_torch.distributed.fault_tolerance import StragglerDetector
        detector = StragglerDetector(z_threshold=tc.straggler_z)
    straggler_flags = 0

    history = []
    t0 = time.time()
    for it in range(tc.iterations):
        t_it = time.time()
        aux = iteration(it)
        if detector is not None:
            _sync(dev)       # charge the iteration its own device time
            if detector.update(time.time() - t_it):
                straggler_flags += 1
                if log_fn:
                    log_fn({"iteration": it, "straggler": True,
                            "step_s": round(time.time() - t_it, 3),
                            "mean_s": round(detector.mean, 3)})
        if it % tc.log_every == 0 or it == tc.iterations - 1:
            m = {k: float(v) for k, v in aux.items()}
            m["iteration"] = it
            m["transitions"] = int((it + 1) * tc.n_envs * tc.collect_steps)
            m["elapsed_s"] = round(time.time() - t0, 1)
            if detector is not None:
                m["straggler_flags"] = straggler_flags
            history.append(m)
            if log_fn:
                log_fn(m)
    return state.sac, history
