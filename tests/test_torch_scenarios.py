"""The port's scenarios (``repro_torch.scenarios``) and its scenario env
against the JAX reference on the CPU.

The compiled tables of every registered scenario, and of a test script
registered in both packages, must be equal arrays; ``at_time`` and
``evict_beyond_cap`` bit-exact.  The env is stepped as in
``test_torch_env.py``: the reference env runs first (vmapped over envs,
under ``jit``) and every draw it made is injected into the port's
``step``.  Standard: expert clocks and queues bit-exact at every step,
``evicted``/``done``/``dropped`` exact, rewards and the other stats within
1e-5; observations within 1e-6 and router actions identical on the
reference's states.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import features as jfeat, routers as jrouters
from repro.env import engine as jengine, env as jenv
from repro_torch import scenarios
from repro_torch.core import features, routers
from repro_torch.device import generator
from repro_torch.env import engine_layout as layout, env as env_lib

B, N, R, W, STEPS = 4, 6, 4, 4, 300
EXACT_STATS = ("done", "dropped", "viol", "routed", "evicted", "shed",
               "retried", "redispatched")

# A flash crowd, one expert failure and recovery, a cap shrink (with
# eviction) and a straggler, timed so a 300-step drive at 5/s crosses
# every event (the reference tests' script).
EVENTS = {
    "FlashCrowd": dict(t0=5.0, t1=12.0, mult=3.0),
    "ExpertDown": dict(expert=1, t0=8.0, t1=18.0),
    "CapClaim": dict(expert=0, t0=10.0, t1=45.0, run_cap=1, wait_cap=2),
    "Slowdown": dict(expert=4, t0=3.0, t1=40.0, factor=2.5),
}
TEST_NAME = "_torch_test_stress"


def register_both(name, events, horizon=60.0, dt=0.5):
    """Register one script under ``name`` in both packages (once), from
    ``{event class name: fields}`` pairs; returns the name."""
    for pkg in (jscen, scenarios):
        try:
            pkg.get(name)
        except KeyError:
            pkg.register(pkg.ScenarioSpec(
                name=name, horizon=horizon, dt=dt,
                events=tuple(getattr(pkg, k)(**v) for k, v in events)))
    return name


register_both(TEST_NAME, tuple(EVENTS.items()))


def configs(**kw):
    kw = dict(n_experts=N, run_cap=R, wait_cap=W, **kw)
    return jenv.EnvConfig(**kw), env_lib.EnvConfig(**kw)


def actions(seed=0, steps=STEPS, batch=B):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, N + 1, (steps, batch))
    a[rng.uniform(size=(steps, batch)) < 0.1] = 0          # drops
    return a.astype(np.int32)


def reference_drive(jcfg, acts, seed=7):
    """Step the reference env on ``acts (T, B)``; returns its initial
    pending request, its final state and the per-step (reward, clock,
    pending, expert clocks, queues), as numpy."""
    pool = jenv.make_env_pool(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), acts.shape[1])

    @jax.jit
    def run(keys, acts):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)

        def body(st, a):
            st, r, _ = jax.vmap(
                lambda s, aa: jenv.step(jcfg, pool, s, aa))(st, a)
            return st, (r, st["clock"], st["pending"], st["expert_clock"],
                        st["queues"])

        final, trace = jax.lax.scan(body, s0, acts)
        return s0["pending"], final, trace

    return jax.tree.map(np.asarray, run(keys, jnp.asarray(acts)))


def tt(x):
    return torch.as_tensor(np.array(x))


def port_drive(tcfg, acts, ref):
    """The port's env on the reference's draws; returns its final state and
    the per-step rewards, expert clocks and queues."""
    pending0, _, (_, clock, pending, _, _) = ref
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    st = env_lib.reset(tcfg, pool, generator("cpu", 0), acts.shape[1],
                       pending={k: tt(v) for k, v in pending0.items()})
    rewards, clocks, queues = [], [], []
    for k, a in enumerate(acts):
        st, r, _ = env_lib.step(
            tcfg, pool, st, tt(a),
            draws={"clock": tt(clock[k]),
                   "pending": {f: tt(v[k]) for f, v in pending.items()}})
        rewards.append(r.numpy())
        clocks.append(st["expert_clock"].numpy())
        queues.append(layout.queues_to_numpy(st["queues"]))
    return st, np.stack(rewards), np.stack(clocks), queues


def assert_drive_matches(ref, got):
    _, final, (rew, _, _, eclock, equeues) = ref
    st, got_rew, got_clock, got_queues = got
    for k, q in enumerate(got_queues):
        for key in layout.QUEUE_KEYS:
            np.testing.assert_array_equal(equeues[key][k], q[key],
                                          err_msg=f"step {k} {key}")
    np.testing.assert_array_equal(eclock, got_clock)
    np.testing.assert_allclose(rew, got_rew, rtol=1e-5, atol=1e-5)
    assert set(final["stats"]) == set(st["stats"])
    for k, v in final["stats"].items():
        if k in EXACT_STATS:
            np.testing.assert_array_equal(v, st["stats"][k].numpy(),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(v, st["stats"][k].numpy(), rtol=1e-5,
                                       err_msg=k)


@functools.lru_cache(maxsize=None)
def stress_drive():
    jcfg, _ = configs(scenario=TEST_NAME)
    return reference_drive(jcfg, actions())


# ---------------------------------------------------------------------------
# Compile and runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", (False, True))
def test_compiled_tables_equal_the_references(ragged):
    assert set(jscen.names()) >= set(scenarios.names())
    assert {"always_up", "flash_crowd", "rolling_outage", "memory_pressure",
            "stress", TEST_NAME} <= set(scenarios.names())
    caps = ((2, 4, 1, 3, 4, 2), (2, 3, 1, 4, 2, 3)) if ragged else (None,
                                                                     None)
    for name in scenarios.names():
        want = jscen.compile_spec(jscen.get(name), N, R, W, *caps)
        got = scenarios.compile_spec(scenarios.get(name), N, R, W, *caps,
                                     device="cpu")
        for k in want._fields:
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            assert w.dtype == g.dtype, (name, k)
            np.testing.assert_array_equal(w, g, err_msg=f"{name} {k}")


def test_unknown_scenario_fails_at_reset_and_lookup():
    cfg = env_lib.EnvConfig(scenario="no_such_scenario")
    with pytest.raises(KeyError, match="no_such_scenario"):
        env_lib.reset(cfg, env_lib.make_env_pool(cfg, device="cpu"),
                      generator("cpu", 0), 1)
    with pytest.raises(KeyError):
        scenarios.get("no_such_scenario")


def test_at_time_and_evict_match_reference():
    jst = jscen.compile_spec(jscen.get("stress"), N, R, W)
    st = scenarios.compile_spec(scenarios.get("stress"), N, R, W,
                                device="cpu")
    t = np.concatenate([np.linspace(0, 130, 97), [-1.0, 1e6, 39.999, 40.0]]
                       ).astype(np.float32)
    got = scenarios.at_time(st, torch.as_tensor(t))
    want = jax.jit(jax.vmap(lambda x: jscen.at_time(jst, x)))(jnp.asarray(t))
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(), k)
    # evict on loaded queues from the stress drive, at caps of each row
    _, _, (_, _, _, _, queues) = stress_drive()
    rng = np.random.default_rng(0)
    for k in (40, 120, 250):
        q = {key: queues[key][k] for key in layout.QUEUE_KEYS}
        rc = rng.integers(1, R + 1, (B, N)).astype(np.int32)
        wc = rng.integers(1, W + 1, (B, N)).astype(np.int32)
        jq, jn = jax.jit(jax.vmap(jscen.evict_beyond_cap))(q, rc, wc)
        tq, tn = scenarios.evict_beyond_cap(
            {key: tt(v) for key, v in q.items()}, tt(rc), tt(wc))
        for key in layout.QUEUE_KEYS:
            np.testing.assert_array_equal(np.asarray(jq[key]),
                                          tq[key].numpy(), key)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        assert tn.sum() > 0


# ---------------------------------------------------------------------------
# The env under a scenario
# ---------------------------------------------------------------------------


def test_scenario_env_matches_reference_on_injected_draws():
    """300 steps across a flash crowd, an outage, a cap claim and a
    straggler: clocks and queues bit-exact at every step."""
    _, tcfg = configs(scenario=TEST_NAME)
    ref = stress_drive()
    got = port_drive(tcfg, actions(), ref)
    assert_drive_matches(ref, got)
    st = got[0]
    # not vacuous: every env is past the outage's recovery, inside the
    # cap claim, and some occupants were evicted
    assert float(st["clock"].min()) > 18.0
    assert st["stats"]["evicted"].sum() > 0
    assert st["stats"]["done"].sum() > 100
    assert (st["stats"]["dropped"] > 0).all()


def test_always_up_is_byte_identical_to_no_scenario():
    """The port's env under ``always_up`` against itself without a
    scenario, on its own draws: every tensor of the state equal."""
    cfg0 = env_lib.EnvConfig(n_experts=N)
    cfg1 = env_lib.EnvConfig(n_experts=N, scenario="always_up")
    pool = env_lib.make_env_pool(cfg0, device="cpu")
    out = []
    for cfg in (cfg0, cfg1):
        st = env_lib.reset(cfg, pool, generator("cpu", 5), 3)
        rs = []
        for k in range(150):
            st, r, _ = env_lib.step(cfg, pool, st, torch.full((3,),
                                                              k % N + 1))
            rs.append(r)
        out.append((st, torch.stack(rs)))
    (s0, r0), (s1, r1) = out
    assert torch.equal(r0, r1)
    for k in ("clock", "expert_clock"):
        assert torch.equal(s0[k], s1[k]), k
    for k in layout.QUEUE_KEYS:
        assert torch.equal(s0["queues"][k], s1["queues"][k]), k
    for k in s0["stats"]:
        assert torch.equal(s0["stats"][k], s1["stats"][k]), k
    for k in s0["pending"]:
        assert torch.equal(s0["pending"][k], s1["pending"][k]), k


def test_routing_to_a_down_expert_is_a_doomed_push():
    """The doomed-push penalty and the drop, against the reference, on the
    drive's states while expert 1 is down."""
    jcfg, tcfg = configs(scenario=TEST_NAME)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    _, _, (_, clock, pending, _, queues) = stress_drive()
    k = int(np.argmax(clock[:, 0] > 10.0))                   # expert 1 down
    js = {"clock": clock[k], "pending": jax.tree.map(lambda v: v[k], pending),
          "queues": {key: queues[key][k] for key in layout.QUEUE_KEYS}}
    ts = jax.tree.map(tt, js)
    j_pen = jax.jit(jax.vmap(lambda s, a: jenv.impact_penalty(
        jcfg, jpool, s, a), in_axes=(0, None)))
    for a in range(N + 1):
        got = env_lib.impact_penalty(tcfg, pool, ts, torch.full((B,), a))
        want = j_pen(js, jnp.asarray(a, jnp.int32))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                                   atol=1e-6)
    down = env_lib.impact_penalty(tcfg, pool, ts, torch.full((B,), 2))
    assert (down >= ts["pending"]["pred_s"][:, 1] - 1e-6).all()


# ---------------------------------------------------------------------------
# Features and availability-aware routers on the reference's states
# ---------------------------------------------------------------------------

SNAPS = (30, 60, 110, 200, 299)


@pytest.mark.parametrize("fmt", ("padded", "segments"))
def test_obs_scenario_channels_match_reference(fmt):
    jcfg, tcfg = configs(scenario=TEST_NAME)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    _, _, (_, clock, pending, _, queues) = stress_drive()
    obs_fn = jax.jit(jax.vmap(lambda s: jfeat.build_obs(jcfg, jpool, s,
                                                        fmt=fmt)))
    up_seen = set()
    for k in SNAPS:
        js = {"clock": clock[k],
              "pending": jax.tree.map(lambda v: v[k], pending),
              "queues": {key: queues[key][k] for key in layout.QUEUE_KEYS}}
        want = jax.tree.map(np.asarray, obs_fn(js))
        got = features.build_obs(tcfg, pool, jax.tree.map(tt, js), fmt=fmt)
        assert set(want) == set(got)
        for key in want:
            np.testing.assert_allclose(want[key], got[key].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
        up_seen.update(got["expert"][..., 7].flatten().tolist())
        if k == 110:                             # the cap claim on expert 0
            assert (got["expert"][:, 0, 8] < 1.0).all()
    assert up_seen == {0.0, 1.0}


def test_availability_aware_routers_match_reference():
    jcfg, tcfg = configs(scenario=TEST_NAME)
    _, _, (_, clock, pending, _, queues) = stress_drive()
    jpols = [jrouters.shortest_queue(N, env_cfg=jcfg),
             jrouters.quality_least_loaded(env_cfg=jcfg)]
    tpols = [routers.shortest_queue(N, env_cfg=tcfg),
             routers.quality_least_loaded(env_cfg=tcfg)]
    avoided = 0
    for jp, tp in zip(jpols, tpols):
        j_act = jax.jit(jax.vmap(lambda s: jp.act({}, s, None, None)[0]))
        for k in range(0, STEPS, 7):
            js = {"clock": clock[k],
                  "pending": jax.tree.map(lambda v: v[k], pending),
                  "queues": {key: queues[key][k]
                             for key in layout.QUEUE_KEYS}}
            ta, _ = tp.act({}, jax.tree.map(tt, js), None, None)
            np.testing.assert_array_equal(np.asarray(j_act(js)), ta.numpy(),
                                          err_msg=f"{tp.name} step {k}")
            if 8.0 <= clock[k].min() and clock[k].max() < 18.0:
                assert (ta != 2).all(), (tp.name, k)     # expert 1 is down
                avoided += 1
    assert avoided > 0


def test_scenario_routers_drop_on_a_fully_down_fleet():
    name = register_both("_torch_test_all_down", tuple(
        ("ExpertDown", dict(expert=i, t0=0.0, t1=1e9)) for i in range(N)),
        horizon=10.0)
    cfg = env_lib.EnvConfig(n_experts=N, scenario=name)
    pool = env_lib.make_env_pool(cfg, device="cpu")
    st = env_lib.reset(cfg, pool, generator("cpu", 4), 2)
    for pol in (routers.shortest_queue(N, env_cfg=cfg),
                routers.quality_least_loaded(env_cfg=cfg)):
        a, _ = pol.act({}, st, None, None)
        assert (a == 0).all(), pol.name


def test_jengine_and_port_agree_on_slot_masks():
    """``slot_valid`` with a leading env axis is the reference's per env."""
    caps = np.random.default_rng(0).integers(1, W + 1, (3, N)).astype(
        np.int32)
    got = layout.slot_valid(tt(caps), W).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            np.asarray(jengine.slot_valid(jnp.asarray(caps[b]), W)), got[b])
