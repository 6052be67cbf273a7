"""The port's observation, HAN, SAC actor, routers and evaluation against
the JAX reference on the CPU.

States come from a reference rollout (numpy actions), weights from the
reference's ``init_params`` carried over by ``io.sac_params_from_numpy``,
and evaluation draws are recorded from the reference env and injected.

Standard: observations within 1e-6, HAN embeddings and actor logits within
1e-5 (float32 sums in another order; no TF32 on the CPU), router actions
identical, evaluation ``done``/``dropped`` exact and avg QoS within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat, han as jhan, io as jio
from repro.core import routers as jrouters, sac as jsac, training as jtrain
from repro.env import env as jenv
from repro_torch.core import features, io, sac, training
from repro_torch.env import env as env_lib
from repro_torch.launch import route

B, N = 3, 6
SNAP_STEPS = (15, 40, 80)


def _configs(ragged):
    jcfg, tcfg = jenv.EnvConfig(n_experts=N), env_lib.EnvConfig(n_experts=N)
    if ragged:
        jcfg, tcfg = jenv.with_ragged_caps(jcfg), env_lib.with_ragged_caps(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _snapshots(ragged):
    """Reference env states (B envs) after each of ``SNAP_STEPS`` steps of
    a numpy-drawn action stream, as numpy trees."""
    jcfg, _ = _configs(ragged)
    pool = jenv.make_env_pool(jcfg)
    rng = np.random.default_rng(1)
    acts = rng.integers(0, N + 1, (max(SNAP_STEPS), B)).astype(np.int32)

    @jax.jit
    def run(keys, acts):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)

        def body(st, a):
            st, _, _ = jax.vmap(lambda s, aa: jenv.step(jcfg, pool, s, aa))(
                st, a)
            return st, st

        return jax.lax.scan(body, s0, acts)[1]

    trace = run(jax.random.split(jax.random.PRNGKey(3), B), acts)
    keep = lambda x: np.asarray(x)[np.asarray(SNAP_STEPS) - 1]
    trace = jax.tree.map(keep, {k: trace[k] for k in
                                ("clock", "queues", "pending")})
    return [jax.tree.map(lambda x: x[i], trace)
            for i in range(len(SNAP_STEPS))]


def _torch_state(s):
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x)), s)


def _jax_obs(jcfg, pool, s, fmt):
    return jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda st: jfeat.build_obs(jcfg, pool, st, fmt=fmt)))(s))


@pytest.mark.parametrize("ragged", (False, True))
@pytest.mark.parametrize("fmt", ("padded", "segments"))
def test_build_obs_matches_reference(fmt, ragged):
    jcfg, tcfg = _configs(ragged)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    for s in _snapshots(ragged):
        want = _jax_obs(jcfg, jpool, s, fmt)
        got = features.build_obs(tcfg, pool, _torch_state(s), fmt=fmt)
        assert set(want) == set(got)
        for k in want:
            if want[k].dtype == bool:
                np.testing.assert_array_equal(want[k], got[k].numpy(), k)
            else:
                np.testing.assert_allclose(want[k], got[k].numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(jfeat.flat_expert_obs)(
            jax.tree.map(jnp.asarray, want))),
        features.flat_expert_obs(got).numpy(), rtol=1e-6)


def _sac_pair(tcfg, seed=0):
    """Reference SAC params from its own init, and the port's copy."""
    jcfg_sac = jsac.SACConfig(n_actions=N + 1,
                              n_run_edges=jfeat.seg_run_rows(tcfg),
                              run_caps=tcfg.run_caps, wait_caps=tcfg.wait_caps)
    jparams = jsac.init_params(jax.random.PRNGKey(seed), jcfg_sac)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg_sac, jparams, io.sac_params_from_numpy(
        tree, route.sac_config(tcfg), device="cpu")


@pytest.mark.parametrize("ragged", (False, True))
def test_han_and_actor_match_reference_on_carried_weights(ragged):
    jcfg, tcfg = _configs(ragged)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    jcfg_sac, jparams, tsac = _sac_pair(tcfg)
    n_run = jfeat.seg_run_rows(tcfg)

    def jax_fn(fmt):
        def one(p, o):
            if fmt == "padded":
                return jhan.forward(p["han"], o)
            return jhan.forward_segments(p["han"], o, n_run=n_run,
                                         run_caps=tcfg.run_caps,
                                         wait_caps=tcfg.wait_caps)
        return jax.jit(lambda p, o: (
            jax.vmap(lambda oo: one(p, oo))(o),
            jsac.actor_logits(p, jcfg_sac, o),
            jsac.act(p, jcfg_sac, o, None, greedy=True)))

    jax_fns = {fmt: jax_fn(fmt) for fmt in ("padded", "segments")}
    for s in _snapshots(ragged):
        ts = _torch_state(s)
        for fmt in ("padded", "segments"):
            jo = _jax_obs(jcfg, jpool, s, fmt)
            to = features.build_obs(tcfg, pool, ts, fmt=fmt)
            if fmt == "padded":
                got = tsac.han(to)
            else:
                got = tsac.han.forward_segments(
                    to, n_run=n_run, run_caps=tcfg.run_caps,
                    wait_caps=tcfg.wait_caps)
            want, jl, ja = jax_fns[fmt](jparams, jo)
            for w, g in zip(want, got):
                np.testing.assert_allclose(np.asarray(w), g.detach().numpy(),
                                           rtol=1e-5, atol=1e-5)
            tl = sac.actor_logits(tsac, to).detach().numpy()
            np.testing.assert_allclose(np.asarray(jl), tl, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(
                np.asarray(ja), sac.act(tsac, to, greedy=True).numpy())


def test_sampled_actions_follow_the_actor():
    """Sampled actions are valid and concentrate on the greedy action when
    the logits are sharp."""
    _, tcfg = _configs(False)
    tsac = sac.init_params(route.sac_config(tcfg), seed=1, device="cpu")
    with torch.no_grad():
        tsac.actor.layers[-1].w.mul_(200.0)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    obs = features.build_obs(tcfg, pool, _torch_state(_snapshots(False)[1]))
    greedy = sac.act(tsac, obs, greedy=True)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sac.act(tsac, obs, gen) for _ in range(50)])
    assert ((draws >= 0) & (draws <= N)).all()
    assert (draws == greedy).float().mean() > 0.9


def _jax_policies(jcfg):
    caps = None if jcfg.run_caps is None else (jcfg.run_caps, jcfg.wait_caps)
    return [jrouters.round_robin(N),
            jrouters.shortest_queue(N, caps=caps, env_cfg=jcfg),
            jrouters.bert_router(),
            jrouters.quality_least_loaded(caps=caps, env_cfg=jcfg)]


@pytest.mark.parametrize("ragged", (False, True))
def test_heuristic_routers_match_reference(ragged):
    jcfg, tcfg = _configs(ragged)
    tpols = route.make_policies(tcfg)
    for jp, tp in zip(_jax_policies(jcfg), tpols):
        assert jp.name == tp.name
        tstate = tp.init_state(B, "cpu")
        jstates = [jp.init_state(None) for _ in range(B)]
        for s in _snapshots(ragged):
            ta, tstate = tp.act(tstate, _torch_state(s), None, None)
            for b in range(B):
                jsb = jax.tree.map(lambda x: jnp.asarray(x[b]), s)
                ja, jstates[b] = jp.act(jstates[b], jsb, None, None)
                assert int(ja) == int(ta[b]), (tp.name, b)


@functools.lru_cache(maxsize=None)
def _reference_draws(ragged, n_steps, n_envs, seed):
    """The arrival times and pending requests the reference's ``evaluate``
    draws (they do not depend on the actions), stacked (T, B, ...)."""
    jcfg, _ = _configs(ragged)
    pool = jenv.make_env_pool(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)

    @jax.jit
    def run(keys):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)

        def body(st, _):
            st, _, _ = jax.vmap(lambda s: jenv.step(
                jcfg, pool, s, jnp.int32(0)))(st)
            return st, (st["clock"], st["pending"])

        return s0["pending"], jax.lax.scan(body, s0, None, length=n_steps)[1]

    p0, (clock, pending) = run(keys)
    t = lambda x: torch.as_tensor(np.array(x))
    return {"pending0": jax.tree.map(t, p0), "clock": t(clock),
            "pending": jax.tree.map(t, pending)}


# RR and BR ignore capacities, so the ragged fleet runs the two that read them
@pytest.mark.parametrize("ragged,policy", [
    (False, "RR"), (False, "SQF"), (False, "BR"), (False, "QLL"),
    (True, "SQF"), (True, "QLL")])
def test_evaluate_matches_reference_on_injected_draws(ragged, policy):
    n_steps, n_envs, seed = 60, 2, 1234
    jcfg, tcfg = _configs(ragged)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    draws = _reference_draws(ragged, n_steps, n_envs, seed)
    names = [p.name for p in route.make_policies(tcfg)]
    jp = _jax_policies(jcfg)[names.index(policy)]
    tp = route.make_policies(tcfg)[names.index(policy)]
    want = jtrain.evaluate(jcfg, jpool, jp, n_steps=n_steps, seed=seed,
                           n_envs=n_envs)
    got = training.evaluate(tcfg, pool, tp, n_steps=n_steps, n_envs=n_envs,
                            draws=draws)
    for k in ("completed", "dropped", "routed"):
        assert got[k] == want[k], k
    assert got["completed"] > 10
    for k in ("avg_qos", "avg_latency_per_token", "violation_rate"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    assert got["mean_reward"] == pytest.approx(want["mean_reward"],
                                               rel=1e-5, abs=1e-6)


def test_heuristics_get_no_observation(monkeypatch):
    """The heuristic routers read the env state alone, so ``evaluate``
    builds no observation for them; the SAC router reads one."""
    _, tcfg = _configs(False)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    tsac = sac.init_params(route.sac_config(tcfg), seed=0, device="cpu")
    pols = route.make_policies(tcfg, tsac, obs_fmt="segments")
    assert [p.obs_fmt for p in pols] == [None] * 4 + ["segments"]
    calls = []
    real = features.build_obs
    monkeypatch.setattr(features, "build_obs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for p in pols[:4]:
        training.evaluate(tcfg, pool, p, n_steps=5, n_envs=2)
    assert calls == []
    training.evaluate(tcfg, pool, pols[4], n_steps=5, n_envs=2)
    assert len(calls) == 5


def test_route_cli_serves_with_a_reference_checkpoint(tmp_path, capsys):
    """``launch.route --ckpt`` loads a router saved by the reference and
    serves all five policies on the CPU."""
    _, tcfg = _configs(False)
    jcfg_sac, jparams, _ = _sac_pair(tcfg, seed=2)
    path = str(tmp_path / "qos.npz")
    jio.save_pytree(path, jparams)
    tree = io.load_pytree(path)
    assert io.router_ckpt_compatible(tree)
    rows = route.main(["--device", "cpu", "--steps", "15", "--n-envs", "2",
                       "--ckpt", path])
    assert [r["policy"] for r in rows] == ["RR", "SQF", "BR", "QLL", "SAC"]
    for r in rows:
        assert r["requests"] == 30 and r["requests_per_s"] > 0
        assert r["completed"] + r["dropped"] <= 30
    assert "SAC" in capsys.readouterr().out
    # the port's own save round-trips the carried weights
    tsac = io.sac_params_from_numpy(tree, route.sac_config(tcfg), device="cpu")
    io.save_pytree(str(tmp_path / "port.npz"), dict(tsac.state_dict()))
    back = io.load_pytree(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(back["han.proj_expert"],
                                  np.asarray(jparams["han"]["proj_expert"]))


def test_route_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        route.main(["--steps", "1"])
