"""The port's env step against the JAX reference on the CPU.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so the
reference env is stepped first (vmapped over envs, under ``jit``) and every
draw it made (each next arrival time and pending request) is injected into
the port's ``step``.  Actions are drawn with numpy and include drops.

Standard: expert clocks and queues bit-exact at every step; rewards and
stats within 1e-5 (``done``, ``dropped`` and ``viol`` exact).  The draws
themselves are held by distribution.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env import env as jenv, profiles as jprofiles, workload as jwl
from repro_torch.env import engine, engine_layout as layout, env as env_lib
from repro_torch.env import profiles
from repro_torch.env import workload
from repro_torch.device import generator

B, N, STEPS = 4, 6, 300
EXACT_STATS = ("done", "dropped", "viol", "routed")


def _configs(impact_mode, ragged):
    kw = dict(n_experts=N, impact_mode=impact_mode)
    jcfg = jenv.EnvConfig(**kw)
    tcfg = env_lib.EnvConfig(**kw)
    if ragged:
        jcfg = jenv.with_ragged_caps(jcfg)
        tcfg = env_lib.with_ragged_caps(tcfg)
        assert jcfg.run_caps == tcfg.run_caps
        assert jcfg.wait_caps == tcfg.wait_caps
    return jcfg, tcfg


def _actions(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, N + 1, (STEPS, B))
    a[rng.uniform(size=(STEPS, B)) < 0.1] = 0          # drops
    return a.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(impact_mode, ragged):
    """Step the reference env; returns its initial pending request, the
    per-step draws, rewards and clocks, and the final state (numpy)."""
    jcfg, _ = _configs(impact_mode, ragged)
    pool = jenv.make_env_pool(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(7), B)

    @jax.jit
    def run(keys, actions):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)

        def body(st, a):
            st, r, info = jax.vmap(
                lambda s, aa: jenv.step(jcfg, pool, s, aa))(st, a)
            return st, (r, st["clock"], st["pending"], st["expert_clock"])

        final, trace = jax.lax.scan(body, s0, actions)
        return s0["pending"], final, trace

    out = run(keys, jnp.asarray(_actions()))
    return jax.tree.map(np.asarray, out)


def _port(impact_mode, ragged):
    _, tcfg = _configs(impact_mode, ragged)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    pending0, _, (_, clock, pending, _) = _reference(impact_mode, ragged)
    t = lambda x: torch.as_tensor(np.array(x))
    st = env_lib.reset(tcfg, pool, generator("cpu", 0), B,
                       pending={k: t(v) for k, v in pending0.items()})
    rewards, clocks = [], []
    for k, a in enumerate(_actions()):
        st, r, _ = env_lib.step(
            tcfg, pool, st, t(a),
            draws={"clock": t(clock[k]),
                   "pending": {f: t(v[k]) for f, v in pending.items()}})
        rewards.append(r.numpy())
        clocks.append(st["expert_clock"].numpy())
    return st, np.stack(rewards), np.stack(clocks)


@pytest.mark.parametrize("impact_mode,ragged", (("paper", False),
                                                ("projected", True)))
def test_step_matches_reference_on_injected_draws(impact_mode, ragged):
    _, final, (rew, _, _, eclock) = _reference(impact_mode, ragged)
    st, got_rew, got_clock = _port(impact_mode, ragged)
    np.testing.assert_array_equal(eclock, got_clock)
    for k in layout.QUEUE_KEYS:
        np.testing.assert_array_equal(final["queues"][k],
                                      st["queues"][k].numpy(), err_msg=k)
    np.testing.assert_allclose(rew, got_rew, rtol=1e-5, atol=1e-5)
    for k, v in final["stats"].items():
        if k in EXACT_STATS:
            np.testing.assert_array_equal(v, st["stats"][k].numpy(),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(v, st["stats"][k].numpy(), rtol=1e-5,
                                       err_msg=k)
    # not vacuous: work completes, queues fill, some pushes are dropped
    assert st["stats"]["done"].sum() > 100
    assert (st["stats"]["dropped"] > 0).all()
    np.testing.assert_allclose(np.asarray(jenv.episode_metrics(
        jax.tree.map(jnp.asarray, {"stats": final["stats"]}))["avg_qos"]),
        env_lib.episode_metrics(st)["avg_qos"].numpy(), rtol=1e-5)


@pytest.mark.parametrize("impact_mode", ("paper", "projected"))
def test_impact_penalty_matches_reference(impact_mode):
    """The penalty of every action on a loaded state, one env at a time
    against the reference."""
    jcfg, tcfg = _configs(impact_mode, False)
    _, final, _ = _reference("paper", False)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    t = lambda x: torch.as_tensor(np.array(x))
    tstate = {"queues": {k: t(v) for k, v in final["queues"].items()},
              "clock": t(final["clock"]),
              "pending": {k: t(v) for k, v in final["pending"].items()}}
    for a in range(N + 1):
        got = env_lib.impact_penalty(tcfg, pool, tstate,
                                     torch.full((B,), a)).numpy()
        for b in range(B):
            js = jax.tree.map(lambda x: jnp.asarray(x[b]),
                              {k: final[k] for k in
                               ("queues", "clock", "pending")})
            want = float(jax.jit(lambda s: jenv.impact_penalty(
                jcfg, jpool, s, jnp.asarray(a)))(js))
            assert got[b] == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_bucketize_matches_reference():
    rng = np.random.default_rng(0)
    jcfg, tcfg = _configs("paper", False)
    s = rng.uniform(-0.1, 1.1, 500).astype(np.float32)
    d = rng.uniform(0, 400, 500).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jenv.bucketize_score(jcfg, jnp.asarray(s))),
        env_lib.bucketize_score(tcfg, torch.as_tensor(s)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jenv.bucketize_len(jcfg, jnp.asarray(d))),
        env_lib.bucketize_len(tcfg, torch.as_tensor(d)).numpy())


def test_request_conservation_with_own_draws():
    """Driven by the port's own generator: every arrival is completed,
    still queued, or dropped."""
    cfg = env_lib.EnvConfig(n_experts=N)
    pool = env_lib.make_env_pool(cfg, device="cpu")
    st = env_lib.reset(cfg, pool, generator("cpu", 3), 2)
    for k in range(100):
        st, _, _ = env_lib.step(cfg, pool, st,
                                torch.full((2,), k % N + 1))
    q = st["queues"]
    in_system = (layout.run_valid(q).sum((1, 2))
                 + layout.wait_valid(q).sum((1, 2))).numpy()
    np.testing.assert_array_equal(
        st["stats"]["done"].numpy() + in_system
        + st["stats"]["dropped"].numpy(), [100, 100])
    assert (st["expert_clock"] >= st["clock"][:, None] - 1e-3).all()


def test_scenario_and_failover_not_ported_yet():
    """Scenarios and failover are ported: the env takes both configs and
    steps under them, and an unknown scenario name fails at ``reset``, as
    the reference's does."""
    from repro_torch.env.failover import FailoverConfig
    cfg = env_lib.EnvConfig(scenario="flash_crowd",
                            failover=FailoverConfig(shed_watermark=0.9))
    pool = env_lib.make_env_pool(cfg, device="cpu")
    st = env_lib.reset(cfg, pool, generator("cpu", 0), 2)
    st, r, _ = env_lib.step(cfg, pool, st, torch.ones(2, dtype=torch.int64))
    assert bool(torch.isfinite(r).all())
    assert set(env_lib.FAILOVER_STAT_KEYS) <= set(st["stats"])
    bad = env_lib.EnvConfig(scenario="not_registered")
    with pytest.raises(KeyError, match="not_registered"):
        env_lib.reset(bad, pool, generator("cpu", 0), 1)


@pytest.mark.parametrize("make", [
    lambda d: profiles.make_pool(N, device=d).k1,
    lambda d: env_lib.make_env_pool(env_lib.EnvConfig(), device=d).k1,
    lambda d: layout.empty_queues(N, 2, 2, device=d)["run_i"],
    lambda d: layout.queues_from_numpy(
        layout.queues_to_numpy(layout.empty_queues(N, 2, 2, device="cpu")),
        device=d)["wait_f"],
    lambda d: workload.init_state(2, device=d)["burst"],
    lambda d: env_lib.queue_caps(env_lib.with_ragged_caps(
        env_lib.EnvConfig()), device=d)[0],
], ids=["make_pool", "make_env_pool", "empty_queues", "queues_from_numpy",
        "workload_state", "queue_caps"])
def test_constructors_default_to_cuda(make):
    """Left to its default, a constructor puts its tensors on the CUDA
    device, and raises where there is none: it never picks the CPU."""
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make(None)


def test_reset_packs_the_fleet_once():
    """``reset`` holds the engine's parameter pack, one row per (env,
    expert), and ``step`` carries it unchanged."""
    cfg = env_lib.with_ragged_caps(env_lib.EnvConfig(n_experts=N))
    pool = env_lib.make_env_pool(cfg, device="cpu")
    st = env_lib.reset(cfg, pool, generator("cpu", 0), 3)
    rc, wc = env_lib.queue_caps(cfg, device="cpu")
    want = engine.pool_params(pool, rc, wc)
    assert st["par"].shape == (3 * N, layout.PAR_CH)
    for b in range(3):
        assert torch.equal(st["par"][b * N:(b + 1) * N], want)
    assert torch.equal(st["wait_caps"], wc)
    st2, _, _ = env_lib.step(cfg, pool, st, torch.ones(3, dtype=torch.int64))
    assert st2["par"] is st["par"]


# ---------------------------------------------------------------------------
# Draws, held by distribution
# ---------------------------------------------------------------------------


def _arrivals(cfg, n, batch, seed):
    gen = generator("cpu", seed)
    st = workload.init_state(batch, device="cpu")
    t = torch.zeros(batch)
    bursts = []
    for _ in range(n):
        dt, st = workload.next_arrival(cfg, st, t, gen)
        t = t + dt
        bursts.append(st["burst"])
    return t, torch.stack(bursts)


def test_poisson_mean_rate():
    lam = 5.0
    t_end, _ = _arrivals(workload.WorkloadConfig(kind="poisson", rate=lam),
                         20_000, 1, 0)
    rate = 20_000 / float(t_end[0])
    assert 0.95 * lam < rate < 1.05 * lam, rate


def test_realworld_mean_rate_normalized_and_bursts_flip():
    """Long-run mean rate within 10% of λ (two chains), and the burst chain
    flips on and off at about its stationary share."""
    lam = 5.0
    t_end, bursts = _arrivals(workload.WorkloadConfig(kind="realworld",
                                                      rate=lam),
                              20_000, 2, 1)
    for b in range(2):
        rate = 20_000 / float(t_end[b])
        assert 0.9 * lam < rate < 1.1 * lam, (b, rate)
    flips_on = int((bursts[1:] & ~bursts[:-1]).sum())
    assert flips_on > 20
    assert 0.02 < float(bursts.float().mean()) < 0.2


def test_current_rate_matches_reference():
    cfg = workload.WorkloadConfig(kind="realworld", rate=5.0)
    jcfg = jwl.WorkloadConfig(kind="realworld", rate=5.0)
    t = np.linspace(0, 1200, 37).astype(np.float32)
    for burst in (False, True):
        got = workload.current_rate(
            cfg, {"burst": torch.full((37,), burst)}, torch.as_tensor(t))
        want = jax.vmap(lambda tt: jwl.current_rate(
            jcfg, {"burst": jnp.bool_(burst)}, tt))(jnp.asarray(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sample_request_distribution_matches_reference():
    """Batched request draws against the reference's, by moments."""
    jpool = jprofiles.make_pool(N)
    pool = profiles.make_pool(N, device="cpu")
    n = 4000
    got = profiles.sample_request(pool, generator("cpu", 0), n)
    want = jax.vmap(lambda k: jprofiles.sample_request(jpool, k))(
        jax.random.split(jax.random.PRNGKey(0), n))
    assert got["score"].shape == (n, N) and got["p_len"].shape == (n,)
    assert 16 <= int(got["p_len"].min()) and int(got["p_len"].max()) <= 512
    assert 8 <= int(got["out_len"].min()) and \
        int(got["out_len"].max()) <= 300
    for k in ("p_len", "score", "out_len", "type"):
        g = got[k].to(torch.float64).mean(0).numpy()
        w = np.asarray(want[k], np.float64).mean(0)
        np.testing.assert_allclose(g, w, rtol=0.06, err_msg=k)
