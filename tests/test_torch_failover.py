"""The port's failure-aware request lifecycle (``repro_torch.env.failover``)
against the JAX reference on the CPU.

``drain_failed``, ``readmit``, ``occupancy`` and ``admit_min_of`` are held
bit-exact against the reference's (vmapped over envs, under ``jit``) on
loaded queues and retry buffers.  The env under a rolling outage with
failover armed is stepped on the reference's own draws, as in
``test_torch_scenarios.py``: queues, retry buffers and clocks bit-exact at
every step, the counters exact.  The reference tests' failover drive
sheds nothing, so this drive runs at a lower shed watermark and asserts
that it drains and sheds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat, routers as jrouters
from repro.env import env as jenv, failover as jfo
from repro_torch.core import features, routers
from repro_torch.device import generator
from repro_torch.env import engine_layout as layout, env as env_lib, failover

from test_torch_scenarios import (B, N, actions, assert_drive_matches,
                                  configs, port_drive, reference_drive,
                                  register_both, tt)

STEPS = 320
# one failure and recovery crossed by the drive, and a second outage that
# overlaps it (the reference tests' script)
FO_NAME = register_both("_torch_test_failover", (
    ("ExpertDown", dict(expert=1, t0=6.0, t1=20.0)),
    ("ExpertDown", dict(expert=3, t0=12.0, t1=30.0))))
# the reference tests' config but for the watermark, 0.7 there: at 0.45
# the fleet crosses it and the admit gate sheds
FO_KW = dict(retry_budget=2, backoff_base=0.05, buffer_cap=12,
             max_redispatch=3, shed_watermark=0.45, shed_pred_s=0.5)


def fo_configs(**kw):
    return configs(scenario=FO_NAME, **kw), (jfo.FailoverConfig(**FO_KW),
                                             failover.FailoverConfig(**FO_KW))


@functools.lru_cache(maxsize=None)
def failover_drive():
    (jcfg, _), (jf, _) = fo_configs()
    jcfg = dataclasses.replace(jcfg, failover=jf)
    acts = actions(seed=3, steps=STEPS)
    return acts, reference_drive(jcfg, acts, seed=11)


@functools.lru_cache(maxsize=None)
def reference_states(every=8):
    """(clock, queues, retry buffer) of the reference's failover drive at
    every ``every``-th step, as numpy (re-run to capture the buffer)."""
    (jcfg, _), (jf, _) = fo_configs()
    jcfg = dataclasses.replace(jcfg, failover=jf)
    pool = jenv.make_env_pool(jcfg)
    acts, _ = failover_drive()
    keys = jax.random.split(jax.random.PRNGKey(11), B)

    @jax.jit
    def run(keys, acts):
        s0 = jax.vmap(lambda k: jenv.reset(jcfg, pool, k))(keys)

        def body(st, a):
            st, _, _ = jax.vmap(
                lambda s, aa: jenv.step(jcfg, pool, s, aa))(st, a)
            return st, {k: st[k] for k in ("clock", "queues", "retry_buf",
                                           "pending")}

        return jax.lax.scan(body, s0, acts)[1]

    trace = jax.tree.map(np.asarray, run(keys, jnp.asarray(acts)))
    return [jax.tree.map(lambda x: x[k], trace)
            for k in range(0, STEPS, every)]


def test_failover_env_matches_reference_and_sheds():
    """320 steps with failover armed across two outages: queues, buffers
    and clocks bit-exact, counters exact, and the drive drains and sheds."""
    (_, tcfg), (_, tf) = fo_configs()
    tcfg = dataclasses.replace(tcfg, failover=tf)
    acts, ref = failover_drive()
    got = port_drive(tcfg, acts, ref)
    assert_drive_matches(ref, got)
    final = ref[1]
    for k in ("buf_i", "buf_f", "buf_t"):
        np.testing.assert_array_equal(final["retry_buf"][k],
                                      got[0]["retry_buf"][k].numpy(), k)
    stats = got[0]["stats"]
    assert float(stats["retried"].sum()) > 0, "nothing drained"
    assert float(stats["shed"].sum()) > 0, "nothing shed"
    assert float(stats["redispatched"].sum()) > 0
    assert float(stats["done"].sum()) > 100


def test_failover_request_conservation():
    """On the port's own draws, every arrival is done, dropped, evicted,
    shed, queued or in the retry buffer."""
    (_, tcfg), (_, tf) = fo_configs()
    cfg = dataclasses.replace(tcfg, failover=tf)
    pool = env_lib.make_env_pool(cfg, device="cpu")
    st = env_lib.reset(cfg, pool, generator("cpu", 2), 3)
    n = 250
    for k in range(n):
        st, _, _ = env_lib.step(cfg, pool, st, torch.full((3,), k % N + 1))
    s, q = st["stats"], st["queues"]
    in_flight = (layout.run_valid(q).sum((1, 2)) + layout.wait_valid(q).sum(
        (1, 2))).to(torch.float32) + failover.in_buffer(st["retry_buf"])
    total = (s["done"] + s["dropped"] + s["evicted"] + s["shed"]
             + in_flight)
    np.testing.assert_array_equal(total.numpy(), [n] * 3)
    assert float(s["retried"].sum()) > 0


@pytest.mark.parametrize("order", ("fifo", "qos", "edf"))
def test_drain_readmit_occupancy_match_reference(order):
    """The lifecycle's pieces, one call each on the reference drive's
    states, with the down mask and caps varied per env."""
    (jcfg, _), (jf, tf) = fo_configs()
    L = jcfg.latency_L
    rng = np.random.default_rng(1)
    drained = readmitted = shed = 0
    j_drain = jax.jit(jax.vmap(lambda q, b, u, t: jfo.drain_failed(
        q, b, u, t, L, jf)))
    j_readmit = jax.jit(jax.vmap(lambda q, b, u, t, c: jfo.readmit(
        q, b, u, t, c, L, jf, admit_order=order)))
    j_occ = jax.jit(jax.vmap(jfo.occupancy))
    j_floor = jax.jit(jax.vmap(lambda o: jfo.admit_min_of(o, jf, N)))
    for s in reference_states():
        up = rng.uniform(size=(B, N)) > 0.3
        rc = rng.integers(1, jcfg.run_cap + 1, (B, N)).astype(np.int32)
        wc = rng.integers(1, jcfg.wait_cap + 1, (B, N)).astype(np.int32)
        t = s["clock"] + np.float32(0.3)
        q, buf = s["queues"], s["retry_buf"]
        tq, tbuf = jax.tree.map(tt, q), jax.tree.map(tt, buf)

        want = j_drain(q, buf, up, t)
        got = failover.drain_failed(tq, tbuf, tt(up), tt(t), L, tf)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        drained += float(got[2].sum())
        shed += float(got[3].sum())

        q2, buf2 = jax.tree.map(np.asarray, (want[0], want[1]))
        want = j_readmit(q2, buf2, up, t, wc)
        got = failover.readmit(jax.tree.map(tt, q2), jax.tree.map(tt, buf2),
                               tt(up), tt(t), tt(wc), L, tf,
                               admit_order=order)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        readmitted += float(got[2].sum())

        occ_w = j_occ(q, rc, wc)
        occ = failover.occupancy(tq, tt(rc), tt(wc))
        np.testing.assert_array_equal(np.asarray(occ_w), occ.numpy())
        np.testing.assert_array_equal(np.asarray(j_floor(occ_w)),
                                      failover.admit_min_of(occ, tf, N).numpy())
    assert drained > 0 and readmitted > 0 and shed > 0


def test_admit_min_floor_at_the_watermark():
    """Occupancy exactly at the watermark arms the floor in both packages
    (compared in float32)."""
    jf = jfo.FailoverConfig(shed_watermark=0.9, shed_pred_s=0.45)
    tf = failover.FailoverConfig(shed_watermark=0.9, shed_pred_s=0.45)
    occ = np.asarray([54 / 60, 0.8999, 0.9001, 1.0], np.float32)
    want = jax.vmap(lambda o: jfo.admit_min_of(o, jf, N))(jnp.asarray(occ))
    got = failover.admit_min_of(tt(occ), tf, N)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert float(got[0, 0]) == np.float32(0.45)


def test_failover_armed_without_failures_is_the_plain_env():
    """Failover armed but nothing failing (no scenario, no watermark):
    queues, clocks, rewards and the shared stats byte-identical to the
    failover-free env."""
    cfg0 = env_lib.EnvConfig(n_experts=4, run_cap=3, wait_cap=3)
    cfg1 = dataclasses.replace(cfg0, failover=failover.FailoverConfig())
    pool = env_lib.make_env_pool(cfg0, device="cpu")
    s0 = env_lib.reset(cfg0, pool, generator("cpu", 11), 3)
    s1 = env_lib.reset(cfg1, pool, generator("cpu", 11), 3)
    for i in range(120):
        a = torch.full((3,), i % 5)                 # drops included
        s0, r0, _ = env_lib.step(cfg0, pool, s0, a)
        s1, r1, _ = env_lib.step(cfg1, pool, s1, a)
        assert torch.equal(r0, r1)
    for k in layout.QUEUE_KEYS:
        assert torch.equal(s0["queues"][k], s1["queues"][k]), k
    assert torch.equal(s0["expert_clock"], s1["expert_clock"])
    for k in s0["stats"]:
        assert torch.equal(s0["stats"][k], s1["stats"][k]), k
    for k in env_lib.FAILOVER_STAT_KEYS:
        assert float(s1["stats"][k].sum()) == 0.0
    assert float(failover.in_buffer(s1["retry_buf"]).sum()) == 0.0


def test_failover_aware_routers_and_obs_match_reference():
    """SQF/QLL with the overload guard and the retry channel of the
    observation (normalised by the retry budget), on the drive's states."""
    (jcfg, tcfg), (jf, tf) = fo_configs()
    jcfg = dataclasses.replace(jcfg, failover=jf)
    tcfg = dataclasses.replace(tcfg, failover=tf)
    jpool = jenv.make_env_pool(jcfg)
    pool = env_lib.make_env_pool(tcfg, device="cpu")
    jpols = [jrouters.shortest_queue(N, env_cfg=jcfg),
             jrouters.quality_least_loaded(env_cfg=jcfg)]
    tpols = [routers.shortest_queue(N, env_cfg=tcfg),
             routers.quality_least_loaded(env_cfg=tcfg)]
    obs_fn = jax.jit(jax.vmap(lambda s: jfeat.build_obs(jcfg, jpool, s)))
    j_acts = [jax.jit(jax.vmap(lambda x, p=p: p.act({}, x, None, None)[0]))
              for p in jpols]
    guarded = retry_seen = 0
    for s in reference_states():
        js = {k: s[k] for k in ("clock", "queues", "pending")}
        # the same state with weak requests, which the overload guard drops
        weak = {**js, "pending": {**js["pending"],
                                  "pred_s": js["pending"]["pred_s"] * 0.5}}
        for x in (js, weak):
            for j_act, tp in zip(j_acts, tpols):
                ta, _ = tp.act({}, jax.tree.map(tt, x), None, None)
                np.testing.assert_array_equal(np.asarray(j_act(x)),
                                              ta.numpy(), err_msg=tp.name)
                guarded += int((ta == 0).sum())
        ts = jax.tree.map(tt, js)
        want = jax.tree.map(np.asarray, obs_fn(js))
        got = features.build_obs(tcfg, pool, ts)
        for k in want:
            np.testing.assert_allclose(want[k], got[k].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        retry_seen += int((got["wait"][..., features.REQ_RETRY] > 0).sum())
    assert guarded > 0 and retry_seen > 0
