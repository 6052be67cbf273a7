"""The port's router training (replay, AdamW, the SAC losses and update, the
collect/update iteration, ``launch/train.py``) against the JAX reference
on the CPU.

Weights and AdamW moments come across with ``core.io``; batches and
states come from reference rollouts.  Standards: the replay buffer
bit-exact; AdamW within 1e-6; one SAC update's loss and ``aux`` within
1e-5, its parameters within ``PARAM_TOL`` and moments within
``MOMENT_TOL`` (float32 sums in another order, through Adam's
normalisation); whole iterations on the reference's own draws with
actions, masks, ``ptr`` and ``size`` exact, rewards and ``aux`` within
1e-5 and every float of the buffer within 1e-6 (the observation's
standard in ``test_torch_policy.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat, io as jio, replay as jreplay
from repro.core import sac as jsac, training as jtrain
from repro.env import env as jenv
from repro.train import optimizer as jopt
from repro_torch.core import features, io, replay, sac, training
from repro_torch.env import env as env_lib
from repro_torch.launch import route, train as train_cli
from repro_torch.train import optimizer as opt_lib

PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-7)


def tt(x):
    return torch.as_tensor(np.array(x))


def npy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def test_replay_add_wraps_and_samples_like_the_reference():
    rng = np.random.default_rng(0)
    example = {"expert": np.zeros((3, 9), np.float32),
               "run_mask": np.zeros((3, 2), bool)}
    cap = 10
    jbuf = jreplay.init(cap, jax.tree.map(jnp.asarray, example))
    buf = replay.init(cap, jax.tree.map(tt, example), device="cpu")
    for n in (4, 3, 4, 4):                              # wraps twice
        obs = {"expert": rng.normal(size=(n, 3, 9)).astype(np.float32),
               "run_mask": rng.uniform(size=(n, 3, 2)) > 0.5}
        nxt = {"expert": rng.normal(size=(n, 3, 9)).astype(np.float32),
               "run_mask": rng.uniform(size=(n, 3, 2)) > 0.5}
        a = rng.integers(0, 4, n).astype(np.int32)
        r = rng.normal(size=n).astype(np.float32)
        d = np.ones(n, np.float32)
        jbuf = jax.jit(jreplay.add_batch)(jbuf, obs, a, r, d, nxt)
        replay.add_batch(buf, jax.tree.map(tt, obs), tt(a), tt(r), tt(d),
                         jax.tree.map(tt, nxt))
        for k in ("ptr", "size", "action", "reward", "discount"):
            np.testing.assert_array_equal(np.asarray(jbuf[k]),
                                          buf[k].numpy(), k)
        for side in ("obs", "next_obs"):
            for k in example:
                np.testing.assert_array_equal(np.asarray(jbuf[side][k]),
                                              buf[side][k].numpy(), k)
    assert int(buf["ptr"]) == 5 and int(buf["size"]) == cap
    key = jax.random.PRNGKey(3)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jbuf["size"], 1))
    want = jreplay.sample(jbuf, key, 16)
    got = replay.sample(buf, None, 16, idx=tt(idx))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # the port's own draws stay below the size
    drawn = replay.sample(buf, torch.Generator().manual_seed(0), 4096)
    assert drawn["action"].shape == (4096,)
    empty = replay.init(cap, jax.tree.map(tt, example), device="cpu")
    assert replay.sample(empty, torch.Generator().manual_seed(0),
                         8)["reward"].shape == (8,)


def test_replay_draws_cover_the_filled_rows_only():
    buf = replay.init(100, {"x": torch.zeros(1)}, device="cpu")
    replay.add_batch(buf, {"x": torch.arange(7.0)[:, None]},
                     torch.arange(7), torch.zeros(7), torch.ones(7),
                     {"x": torch.zeros(7, 1)})
    gen = torch.Generator().manual_seed(1)
    got = replay.sample(buf, gen, 5000)["obs"]["x"][:, 0]
    counts = torch.bincount(got.long(), minlength=7)
    assert counts.numel() == 7 and (counts > 550).all()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_lr_schedule_and_clipping_match_reference():
    jc = jopt.OptimizerConfig(peak_lr=3e-4, warmup_steps=100,
                              total_steps=3200)
    tc = opt_lib.OptimizerConfig(peak_lr=3e-4, warmup_steps=100,
                                 total_steps=3200)
    for step in (0, 1, 57, 100, 101, 1650, 3199, 3200, 9000):
        want = float(jax.jit(lambda s: jopt.lr_schedule(jc, s))(
            jnp.asarray(step, jnp.int32)))
        got = float(opt_lib.lr_schedule(tc, torch.tensor(step,
                                                         dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    rng = np.random.default_rng(0)
    tree = [rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=(4,)).astype(np.float32),
            np.asarray(rng.normal(), np.float32)]
    for max_norm in (0.5, 100.0):                 # clipped, then not
        jc_tree, jn = jopt.clip_by_global_norm(
            [jnp.asarray(x) for x in tree], max_norm)
        tc_tree, tn = opt_lib.clip_by_global_norm([tt(x) for x in tree],
                                                  max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for w, g in zip(jc_tree, tc_tree):
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-6,
                                       atol=1e-7)
    assert float(opt_lib.global_norm([tt(x) for x in tree])) == \
        pytest.approx(float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                                        for x in tree))), rel=1e-6)


def test_adamw_three_steps_match_reference():
    rng = np.random.default_rng(1)
    names = ("w", "b", "s")
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32),
              "s": np.asarray(rng.normal(), np.float32)}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=1.0)
    jo = jopt.make_optimizer("adamw", **kw)
    jstate = jo.init(jax.tree.map(jnp.asarray, params))
    jp = jax.tree.map(jnp.asarray, params)
    tparams = {k: torch.nn.Parameter(tt(v)) for k, v in params.items()}
    to = opt_lib.AdamW(tparams, opt_lib.OptimizerConfig(**kw))
    jupd = jax.jit(jo.update)
    for step in range(3):
        grads = {k: (rng.normal(size=np.shape(v)) * (step + 1)).astype(
            np.float32) for k, v in params.items()}
        jp, jstate, jstats = jupd(jax.tree.map(jnp.asarray, grads), jstate,
                                  jp, jnp.asarray(step, jnp.int32))
        to.step.fill_(step)
        stats = to.update([tt(grads[k]) for k in names])
        assert float(stats["lr"]) == pytest.approx(float(jstats["lr"]),
                                                   rel=1e-6)
        for k in names:
            np.testing.assert_allclose(np.asarray(jp[k]),
                                       tparams[k].detach().numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(np.asarray(jstate["m"][k]),
                                       to.m[k].numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(np.asarray(jstate["v"][k]),
                                       to.v[k].numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# One SAC update on an identical batch
# ---------------------------------------------------------------------------

N = 6


@functools.lru_cache(maxsize=None)
def _rollout_obs(fmt, steps=6, b=4):
    """Reference observations (T+1, B, ...) of a random-action rollout."""
    jcfg = jenv.EnvConfig(n_experts=N)
    pool = jenv.make_env_pool(jcfg)
    acts = np.random.default_rng(2).integers(0, N + 1, (steps, b)).astype(
        np.int32)

    @jax.jit
    def run(keys, acts):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)
        obs = lambda s: jax.vmap(lambda x: jfeat.build_obs(
            jcfg, pool, x, fmt=fmt))(s)

        def body(st, a):
            st, _, _ = jax.vmap(lambda s, aa: jenv.step(jcfg, pool, s, aa))(
                st, a)
            return st, obs(st)

        o = jax.lax.scan(body, s0, acts)[1]
        return jax.tree.map(lambda x0, xs: jnp.concatenate([x0[None], xs]),
                            obs(s0), o)

    return npy(run(jax.random.split(jax.random.PRNGKey(5), b),
                   jnp.asarray(acts)))


def _batch(fmt):
    o = _rollout_obs(fmt)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    obs = {k: flat(v[:-1]) for k, v in o.items()}
    nxt = {k: flat(v[1:]) for k, v in o.items()}
    n = obs["arrived"].shape[0]
    rng = np.random.default_rng(4)
    return {"obs": obs, "next_obs": nxt,
            "action": rng.integers(0, N + 1, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "discount": np.ones(n, np.float32)}


def _sac_configs(fmt, use_han):
    jcfg = jenv.EnvConfig(n_experts=N)
    kw = dict(n_actions=N + 1, use_han=use_han, flat_dim=3 * N,
              n_run_edges=jfeat.seg_run_rows(jcfg) if fmt == "segments"
              else None)
    return jsac.SACConfig(**kw), sac.SACConfig(**kw)


@pytest.mark.parametrize("fmt,use_han", [("padded", True),
                                         ("segments", True),
                                         ("padded", False)])
def test_one_sac_update_matches_reference(fmt, use_han):
    """The reference's value_and_grad(losses) -> AdamW -> polyak against
    the port's same step, from the same weights and moments."""
    jc, tc_sac = _sac_configs(fmt, use_han)
    jparams = jsac.init_params(jax.random.PRNGKey(11), jc)
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=3200,
              weight_decay=0.0, grad_clip=10.0)
    jo = jopt.make_optimizer("adamw", **kw)
    jstate = jo.init(jsac.trainable(jparams))
    # a moment history, so the step is not Adam's first
    rng = np.random.default_rng(6)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(np.abs(rng.normal(size=x.shape)) * 1e-3,
                              jnp.float32), jstate)
    batch = _batch(fmt)
    step = 150

    @jax.jit
    def jupdate(params, opt_state, batch):
        def loss_fn(tr):
            return jsac.losses(jsac.merge_trainable(params, tr), jc, batch)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jsac.trainable(params))
        new_tr, opt_state, _ = jo.update(grads, opt_state,
                                         jsac.trainable(params),
                                         jnp.asarray(step, jnp.int32))
        params = jsac.polyak(jsac.merge_trainable(params, new_tr), jc)
        return loss, aux, params, opt_state

    want_loss, want_aux, want_p, want_state = npy(jupdate(jparams, jstate,
                                                          batch))
    model = io.sac_params_from_numpy(npy(jparams), tc_sac, device="cpu")
    opt = training.make_adamw(training.TrainConfig(iterations=400), model)
    io.adamw_from_numpy(opt, npy(jstate))
    opt.step.fill_(step)
    tbatch = jax.tree.map(tt, batch)
    loss, aux = sac.losses(model, tbatch)
    grads = sac.grads(loss, list(opt.params.values()))
    opt.update(grads)
    sac.polyak(model)

    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5,
                                        abs=1e-5)
    assert set(aux) == set(want_aux)
    for k in aux:
        assert float(aux[k]) == pytest.approx(float(want_aux[k]), rel=1e-5,
                                              abs=1e-5), k
    got_p = io.sac_params_to_numpy(model)
    assert jax.tree.structure(got_p) == jax.tree.structure(want_p)
    moved = 0
    for (path, w), g, p0 in zip(
            jax.tree_util.tree_leaves_with_path(want_p),
            jax.tree.leaves(got_p), jax.tree.leaves(npy(jparams))):
        np.testing.assert_allclose(w, g, err_msg=jax.tree_util.keystr(path),
                                   **PARAM_TOL)
        moved += int((w != p0).any())
    assert moved > 10
    got_state = io.adamw_to_numpy(opt)
    for w, g in zip(jax.tree.leaves(want_state), jax.tree.leaves(got_state)):
        np.testing.assert_allclose(w, g, **MOMENT_TOL)


def test_sampled_action_is_the_references_gumbel_max():
    """``jax.random.categorical`` is argmax(logits + gumbel(key)); the port
    takes the same noise and gives the same actions, and its own Gumbel
    draws have the standard Gumbel's mean."""
    logits = np.random.default_rng(0).normal(size=(64, 7)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax.random.categorical(key, jnp.asarray(logits), axis=-1)
    g = jax.random.gumbel(key, logits.shape)
    np.testing.assert_array_equal(
        np.asarray(want), np.argmax(logits + np.asarray(g), -1))
    jc, tc_sac = _sac_configs("padded", True)
    model = sac.init_params(tc_sac, seed=0, device="cpu")
    obs = {k: tt(v[0]) for k, v in _rollout_obs("padded").items()}
    logits_t = sac.actor_logits(model, obs).detach()
    noise = tt(np.asarray(jax.random.gumbel(key, tuple(logits_t.shape))))
    np.testing.assert_array_equal(
        sac.act(model, obs, noise=noise).numpy(),
        np.argmax(logits_t.numpy() + noise.numpy(), -1))
    draws = sac.gumbel((20000,), torch.Generator().manual_seed(0), "cpu")
    assert float(draws.mean()) == pytest.approx(0.5772, abs=0.03)


# ---------------------------------------------------------------------------
# Whole iterations on the reference's own draws
# ---------------------------------------------------------------------------

ITERS, SEED = 3, 0


def _tiny(obs_fmt):
    kw = dict(n_experts=3, run_cap=2, wait_cap=2)
    jcfg, tcfg = jenv.EnvConfig(**kw), env_lib.EnvConfig(**kw)
    skw = dict(n_actions=4, hidden=16, flat_dim=9,
               n_run_edges=(jfeat.seg_run_rows(jcfg) if obs_fmt == "segments"
                            else None))
    tkw = dict(n_envs=2, collect_steps=2, updates_per_iter=2, batch_size=8,
               buffer_capacity=64, warmup_transitions=5, iterations=ITERS,
               seed=SEED, obs_fmt=obs_fmt)
    return ((jcfg, jsac.SACConfig(**skw), jtrain.TrainConfig(**tkw)),
            (tcfg, sac.SACConfig(**skw), training.TrainConfig(**tkw)))


@functools.lru_cache(maxsize=None)
def _reference_iterations(obs_fmt):
    """Run the reference's ``make_iteration`` ITERS times as
    ``train_router`` does; returns its initial params and env states, the
    aux of each iteration and the final params, moments and buffer (numpy),
    and every draw it made."""
    (jcfg, jsc, jtc), _ = _tiny(obs_fmt)
    pool = jenv.make_env_pool(jcfg)
    key = jax.random.PRNGKey(jtc.seed)
    k_state, key = jax.random.split(key)
    params, opt, opt_state, env_states, buf = jtrain.init_train_state(
        jcfg, jsc, jtc, pool, k_state)
    init = npy((params, env_states))
    it_fn = jtrain.make_iteration(jcfg, jsc, jtc, pool, opt)
    auxs, sample_idx = [], []
    for it in range(ITERS):
        # the sample indices from the key chain: a split per collect step,
        # then per update a split and ``replay.sample``'s randint
        k = key
        for _ in range(jtc.collect_steps):
            k, _ = jax.random.split(k)
        size = min((it + 1) * jtc.n_envs * jtc.collect_steps,
                   jtc.buffer_capacity)
        idx = []
        for _ in range(jtc.updates_per_iter):
            k, k_s = jax.random.split(k)
            idx.append(np.asarray(jax.random.randint(
                k_s, (jtc.batch_size,), 0, max(size, 1))))
        sample_idx.append(np.stack(idx))
        params, opt_state, env_states, buf, key, aux = it_fn(
            params, opt_state, env_states, buf, key,
            jnp.asarray(it * jtc.updates_per_iter, jnp.int32))
        auxs.append(npy(aux))
    final = npy((params, opt_state, buf))

    # actions from the buffer; arrivals by re-stepping the env on them
    n_tr = ITERS * jtc.collect_steps * jtc.n_envs
    acts = final[2]["action"][:n_tr].reshape(
        ITERS * jtc.collect_steps, jtc.n_envs)

    @jax.jit
    def restep(s0, acts):
        def body(st, a):
            st, _, _ = jax.vmap(lambda s, aa: jenv.step(jcfg, pool, s, aa))(
                st, a)
            return st, (st["clock"], st["pending"])
        return jax.lax.scan(body, s0, acts)[1]

    clock, pending = npy(restep(jax.tree.map(jnp.asarray, init[1]), acts))
    shape = (ITERS, jtc.collect_steps, jtc.n_envs)
    draws = {"action": acts.reshape(shape),
             "clock": clock.reshape(shape),
             "pending": {k: v.reshape(shape + v.shape[2:])
                         for k, v in pending.items()},
             "sample_idx": np.stack(sample_idx)}
    return init, auxs, final, draws


@pytest.mark.parametrize("obs_fmt", ["padded", "segments"])
def test_iterations_match_reference_on_its_draws(obs_fmt):
    (jcfg, _, jtc), (tcfg, tsc, tc) = _tiny(obs_fmt)
    (jparams, jenv0), auxs, (want_p, want_state, want_buf), draws = \
        _reference_iterations(obs_fmt)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    model = io.sac_params_from_numpy(jparams, tsc, device="cpu")
    state = training.init_train_state(
        tcfg, tsc, tc, pool, sac=model,
        pending={k: tt(v) for k, v in jenv0["pending"].items()})
    it_fn = training.make_iteration(tcfg, tc, pool, state,
                                    draws=jax.tree.map(tt, draws))
    updated = 0
    for it in range(ITERS):
        aux = it_fn(it)
        assert set(aux) == set(auxs[it])
        for k in aux:
            assert float(aux[k]) == pytest.approx(float(auxs[it][k]),
                                                  rel=1e-5, abs=1e-5), (it, k)
        updated += float(aux["critic_loss"]) != 0.0
    assert updated == 2                       # warmup: iterations 1 and 2
    buf = state.buf
    for k in ("ptr", "size", "action", "discount"):
        np.testing.assert_array_equal(want_buf[k], buf[k].numpy(), k)
    assert int(buf["size"]) == ITERS * jtc.collect_steps * jtc.n_envs
    np.testing.assert_allclose(want_buf["reward"], buf["reward"].numpy(),
                               rtol=1e-5, atol=1e-5)
    for side in ("obs", "next_obs"):
        for k, w in want_buf[side].items():
            g = buf[side][k].numpy()
            if w.dtype == bool:
                np.testing.assert_array_equal(w, g, f"{side} {k}")
            else:
                np.testing.assert_allclose(w, g, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{side} {k}")
    # the envs were driven on the same draws: the final clocks agree
    for w, g in zip(jax.tree.leaves(want_p),
                    jax.tree.leaves(io.sac_params_to_numpy(state.sac))):
        np.testing.assert_allclose(w, g, **PARAM_TOL)
    got_state = io.adamw_to_numpy(state.opt)
    for w, g in zip(jax.tree.leaves(want_state), jax.tree.leaves(got_state)):
        np.testing.assert_allclose(w, g, **MOMENT_TOL)


def test_train_router_history_and_sizes():
    """``train_router`` on the port's own draws: the history's keys and
    iterations and finite rewards; the router is the one that
    ``init_train_state`` and ``make_iteration`` train from the same seeds,
    and their buffer's ring counters are exact."""
    _, (tcfg, tsc, tc) = _tiny("padded")
    tc = training.TrainConfig(**{**tc.__dict__, "iterations": 5,
                                 "log_every": 2, "straggler_z": 4.0})
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    logged = []
    model, hist = training.train_router(tcfg, tsc, tc, pool=pool,
                                        log_fn=logged.append)
    assert [h["iteration"] for h in hist] == [0, 2, 4]
    assert hist[-1]["transitions"] == 20
    assert [m for m in logged if not m.get("straggler")] == hist
    for h in hist:
        assert set(h) >= {"critic_loss", "actor_loss", "alpha", "entropy",
                          "q_mean", "collect_reward", "straggler_flags"}
        assert all(np.isfinite(v) for v in h.values())
    state = training.init_train_state(tcfg, tsc, tc, pool)
    it_fn = training.make_iteration(tcfg, tc, pool, state)
    for it in range(tc.iterations):
        it_fn(it)
    assert int(state.buf["size"]) == 20 and int(state.buf["ptr"]) == 20
    for k, x in model.state_dict().items():
        assert torch.equal(x, state.sac.state_dict()[k]), k


# ---------------------------------------------------------------------------
# The CLI and the checkpoint
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "router.npz")
    model, hist = train_cli.main([
        "--router", "--iters", "3", "--device", "cpu", "--scenario",
        "rolling_outage", "--failover", "--shed-watermark", "0.9",
        "--straggler-z", "4.0", "--out", path])
    assert hist[-1]["iteration"] == 2
    assert "straggler_flags" in hist[-1]
    assert np.isfinite(hist[-1]["collect_reward"])
    out = capsys.readouterr().out
    assert "rolling_outage" in out and "watermark=0.9" in out
    assert io.router_ckpt_compatible(io.load_pytree(path))
    # --router-mesh in one process: a world of one gloo rank, which the
    # CLI starts and ends
    mesh_path = str(tmp_path / "mesh.npz")
    train_cli.main(["--router", "--router-mesh", "--iters", "1",
                    "--device", "cpu", "--out", mesh_path])
    assert "sharded over DeviceMesh((expert=1)" in capsys.readouterr().out
    assert io.router_ckpt_compatible(io.load_pytree(mesh_path))
    assert not torch.distributed.is_initialized()
    # the LM path with a mesh flag in one process: a world of one, the
    # host mesh clipped to 1 x 1, trained without a mesh as the reference
    # does; the CLI ends the world it started
    state, trainer = train_cli.main(["--steps", "1", "--device", "cpu",
                                     "--reduced", "--data-parallel", "2"])
    assert int(state["step"]) == 1 and trainer.mesh is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(KeyError):
        train_cli.main(["--router", "--iters", "1", "--device", "cpu",
                        "--scenario", "no_such_scenario"])


def test_port_trained_router_loads_in_the_reference(tmp_path):
    """A router the port trained, saved with ``core.io.save_pytree`` in the
    reference's layout, loads with the reference's ``load_pytree`` and
    acts greedily as the port does."""
    _, (tcfg, tsc, tc) = _tiny("padded")
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    model, _ = training.train_router(tcfg, tsc, tc, pool=pool)
    path = str(tmp_path / "port.npz")
    io.save_pytree(path, io.sac_params_to_numpy(model))
    jparams = jio.load_pytree(path)
    (jcfg, jsc, _), _ = _tiny("padded")
    jpool = jenv.make_env_pool(jcfg)
    states = jax.vmap(lambda k: jenv.reset(jcfg, jpool, k))(
        jax.random.split(jax.random.PRNGKey(2), 8))
    jobs = jax.vmap(lambda s: jfeat.build_obs(jcfg, jpool, s))(states)
    want = jsac.act(jparams, jsc, jobs, None, greedy=True)
    got = sac.act(model, jax.tree.map(tt, npy(jobs)), greedy=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # and back: the same file becomes the same module in the port
    back = io.sac_params_from_numpy(io.load_pytree(path), tsc, device="cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    assert route.sac_config(tcfg).n_actions == tsc.n_actions
    # the Fig. 18 ablations zero the prediction channels in both layouts
    zt = training.TrainConfig(zero_score_pred=True, zero_len_pred=True)
    for fmt in ("padded", "segments"):
        o = features.build_obs(tcfg, pool, training.init_train_state(
            tcfg, tsc, tc, pool).env, fmt=fmt)
        z = training._maybe_zero_preds(zt, o)
        assert (z["expert"][..., 3:5] == 0).all()
        assert (z["arrived"][..., 1:3] == 0).all()
        for k in ("req",) if fmt == "segments" else ("run", "wait"):
            assert (z[k][..., features.REQ_PRED_S] == 0).all()
            assert (z[k][..., features.REQ_PRED_D] == 0).all()
