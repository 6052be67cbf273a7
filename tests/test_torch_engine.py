"""The port's scheduling engine against the JAX reference on the CPU.

Every input is drawn with numpy and handed to both packages.  The JAX side
runs under ``jit`` on its ``xla`` backend and its Pallas kernel in
interpret mode (``backend="pallas"``); the port runs its plain PyTorch loop
(``backend="torch"``), which is also the CUDA kernel's oracle.

Standard: queues, clocks and wait-valid bits bit-exact; ``done``/``viol``
exact; the other accumulators within rtol 1e-6 (they are sums over slots,
which the two packages may add in another order).
"""
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env import engine as jengine, profiles as jprofiles
from repro.env.profiles import ExpertPool as JPool
from repro_torch.env import engine, engine_layout as layout, profiles
from repro_torch.env.profiles import ExpertPool
from repro_torch.kernels.lockstep_advance import ops

N, R, W = 6, 4, 4
STEPS = 300
LAT_L = 0.030
RUN_CAPS = (2, 4, 1, 3, 4, 2)
WAIT_CAPS = (2, 3, 1, 4, 2, 3)
EXACT_ACC = ("done", "viol")
F32 = np.float32


def _stream(steps, seed, rate=5.0, n=N):
    """Arrival stream drawn with numpy; ``t`` holds each step's push time
    and ``t_next`` the time the fleet advances to (float32 running sums,
    so both packages see the same clocks)."""
    rng = np.random.default_rng(seed)
    dt = (rng.exponential(1.0, steps) / rate).astype(F32)
    t_next = np.zeros(steps, F32)
    t = F32(0.0)
    for k in range(steps):
        t = F32(t + dt[k])
        t_next[k] = t
    return {
        "t": np.concatenate([[F32(0.0)], t_next[:-1]]).astype(F32),
        "t_next": t_next,
        "expert": rng.integers(0, n, steps).astype(np.int32),
        "p": rng.integers(16, 512, steps).astype(np.int32),
        "d_true": rng.integers(8, 300, steps).astype(np.int32),
        "score": rng.uniform(0.2, 0.95, steps).astype(F32),
        "pred_s": rng.uniform(0.2, 0.95, steps).astype(F32),
        "pred_d": rng.uniform(8.0, 300.0, steps).astype(F32),
    }


FIELDS = ("p", "d_true", "score", "pred_s", "pred_d")


@functools.lru_cache(maxsize=None)
def _jax_runner(backend, admit_order, ragged, fleet_conds):
    """A jitted scan of (push -> advance) over one env's stream."""
    pool = jprofiles.make_pool(N)
    wc = jnp.asarray(WAIT_CAPS, jnp.int32) if ragged else None
    kw = dict(backend=backend, admit_order=admit_order)
    if ragged:
        kw.update(run_caps=RUN_CAPS, wait_caps=WAIT_CAPS)
    if fleet_conds:
        kw.update(up=jnp.asarray(UP), admit_min=jnp.asarray(ADMIT_MIN))

    def step(carry, x):
        q, clocks = carry
        q, _ = jengine.push_wait(q, x["expert"], p=x["p"], d_true=x["d_true"],
                                 score=x["score"], pred_s=x["pred_s"],
                                 pred_d=x["pred_d"], t=x["t"], wait_cap=wc)
        q, clocks, acc = jengine.advance_all(pool, LAT_L, q, clocks,
                                             x["t_next"], **kw)
        return (q, clocks), (clocks, acc)

    @jax.jit
    def run(stream):
        init = (jengine.empty_queues(N, R, W), jnp.zeros((N,), jnp.float32))
        (q, clocks), (trace, acc) = jax.lax.scan(step, init, stream)
        return q, trace, acc

    return run


UP = np.array([True, True, False, True, True, True])
ADMIT_MIN = np.array([-1e30, 0.5, -1e30, 0.7, -1e30, -1e30], F32)


def _jax_drive(streams, backend, admit_order="fifo", ragged=False,
               fleet_conds=False):
    """One JAX call per env; stacked to (B, ...)."""
    run = _jax_runner(backend, admit_order, ragged, fleet_conds)
    outs = [jax.tree.map(np.asarray, run(s)) for s in streams]
    q = {k: np.stack([o[0][k] for o in outs]) for k in layout.QUEUE_KEYS}
    trace = np.stack([o[1] for o in outs], axis=1)            # (T, B, N)
    acc = {k: np.stack([o[2][k] for o in outs], axis=1) for k in outs[0][2]}
    return q, trace, acc


def _torch_drive(streams, admit_order="fifo", ragged=False,
                 fleet_conds=False, backend="torch"):
    """All envs in one engine call per step, each with its own t_next."""
    pool = profiles.make_pool(N, device="cpu")
    b = len(streams)
    st = {k: torch.as_tensor(np.stack([s[k] for s in streams], 1))
          for k in streams[0]}                                # (T, B)
    wc = torch.tensor(WAIT_CAPS, dtype=torch.int32) if ragged else None
    kw = dict(backend=backend, admit_order=admit_order)
    if ragged:
        kw.update(run_caps=RUN_CAPS, wait_caps=WAIT_CAPS)
    if fleet_conds:
        kw.update(up=torch.as_tensor(UP), admit_min=torch.as_tensor(ADMIT_MIN))
    q = layout.empty_queues(N, R, W, batch=b, device="cpu")
    clocks = torch.zeros((b, N))
    trace, accs = [], []
    for k in range(st["t"].shape[0]):
        q, _ = layout.push_wait(q, st["expert"][k], t=st["t"][k],
                                wait_cap=wc,
                                **{f: st[f][k] for f in FIELDS})
        q, clocks, acc = engine.advance_all(pool, LAT_L, q, clocks,
                                            st["t_next"][k], **kw)
        trace.append(clocks.numpy())
        accs.append({kk: v.numpy() for kk, v in acc.items()})
    acc = {kk: np.stack([a[kk] for a in accs]) for kk in accs[0]}
    return layout.queues_to_numpy(q), np.stack(trace), acc


def _assert_same(ref, got):
    (rq, rtrace, racc), (gq, gtrace, gacc) = ref, got
    np.testing.assert_array_equal(rtrace, gtrace, err_msg="clock trace")
    for k in layout.QUEUE_KEYS:
        np.testing.assert_array_equal(rq[k], gq[k], err_msg=k)
    for k in racc:
        if k in EXACT_ACC:
            np.testing.assert_array_equal(racc[k], gacc[k], err_msg=k)
        else:
            np.testing.assert_allclose(racc[k], gacc[k], rtol=1e-6, atol=0,
                                       err_msg=k)


STREAMS = [_stream(STEPS, seed) for seed in (0, 1)]
# qos_aged needs waiters that coexist: a crowded stream (λ=40 over six
# experts) on which the aged key picks differently from fifo
CROWDED = [_stream(150, seed, rate=40.0) for seed in (5, 6)]


@pytest.fixture(scope="module")
def torch_runs():
    """The port's drives, each computed once per module."""
    cache = {}

    def get(streams="uniform", **kw):
        key = (streams,) + tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _torch_drive(
                STREAMS if streams == "uniform" else CROWDED, **kw)
        return cache[key]

    return get


@pytest.mark.parametrize("backend", ("xla", "pallas"))
@pytest.mark.parametrize("admit_order", ("fifo", "qos", "edf"))
def test_drive_matches_reference(torch_runs, backend, admit_order):
    """The 300-step Poisson drive, two envs with their own t_next in one
    port call, against one reference call per env."""
    got = torch_runs(admit_order=admit_order)
    _assert_same(_jax_drive(STREAMS, backend, admit_order), got)
    assert got[2]["done"].sum() > 50          # the drive does real work


@pytest.mark.parametrize("backend", ("xla", "pallas"))
def test_fleet_conditions_drive_matches_reference(torch_runs, backend):
    """Ragged caps, a down expert and per-expert admission floors, as
    ``advance_all(run_caps=, wait_caps=, up=, admit_min=)`` take them."""
    got = torch_runs(ragged=True, fleet_conds=True)
    _assert_same(_jax_drive(STREAMS, backend, ragged=True, fleet_conds=True),
                 got)
    q = got[0]
    jq0 = {k: jnp.asarray(v[0]) for k, v in q.items()}
    mpt = profiles.make_pool(N, device="cpu").mem_per_token
    np.testing.assert_array_equal(
        np.asarray(jengine.mem_used(jq0, jprofiles.make_pool(N).mem_per_token)),
        layout.mem_used(layout.queues_from_numpy(q, device="cpu"),
                        mpt)[0].numpy())
    for n in range(N):   # nothing ever lands beyond a cap
        assert not q["run_i"][:, n, RUN_CAPS[n]:, 0].any()
        assert not q["wait_i"][:, n, WAIT_CAPS[n]:, 0].any()
    assert not q["run_i"][:, 2, :, 0].any()    # the down expert admits none
    assert got[2]["done"].sum() > 50


def test_ragged_caps_reject_full_queue():
    """The smallest expert (1 wait slot) rejects pushes, in both packages
    alike."""
    s = STREAMS[0]
    wc_t = torch.tensor(WAIT_CAPS, dtype=torch.int32)
    jq = jengine.empty_queues(N, R, W)
    tq = layout.empty_queues(N, R, W, batch=1, device="cpu")
    rejected = 0
    for k in range(40):
        fields = {f: s[f][k] for f in FIELDS}
        n = int(s["expert"][k]) if k % 2 else 2
        jq, jpushed = jengine.push_wait(jq, n, t=s["t"][k],
                                        wait_cap=jnp.asarray(WAIT_CAPS),
                                        **fields)
        tq, tpushed = layout.push_wait(tq, n, t=s["t"][k], wait_cap=wc_t,
                                       **fields)
        assert bool(jpushed) == bool(tpushed[0])
        rejected += not bool(tpushed[0])
    assert rejected > 0
    for k in ("wait_i", "wait_f"):
        np.testing.assert_array_equal(np.asarray(jq[k]), tq[k][0].numpy())


@pytest.mark.parametrize("backend", ("xla", "pallas"))
def test_qos_aged_drive_matches_reference_and_differs_from_fifo(
        torch_runs, backend):
    got = torch_runs("crowded", admit_order="qos_aged")
    _assert_same(_jax_drive(CROWDED, backend, "qos_aged"), got)
    fifo = _jax_drive(CROWDED, backend, "fifo")
    assert not np.array_equal(got[0]["run_f"], fifo[0]["run_f"])


@pytest.mark.parametrize("order,expect", (("qos", 0.9), ("qos_aged", 0.2),
                                          ("fifo", 0.2)))
def test_qos_aged_prevents_starvation(order, expect):
    """An old low-score waiter beats a fresh high-score one under qos_aged
    (pure qos admits the 0.9), in both packages."""
    jpool = jprofiles.make_pool(1)
    pool = profiles.make_pool(1, device="cpu")
    jq = jengine.empty_queues(1, 1, 2)
    tq = layout.empty_queues(1, 1, 2, batch=1, device="cpu")
    for t, s in ((0.0, 0.2), (4.0, 0.9)):
        kw = dict(p=10, d_true=50, score=s, pred_s=s, pred_d=50.0, t=t)
        jq, _ = jengine.push_wait(jq, 0, **kw)
        tq, _ = layout.push_wait(tq, 0, **kw)
    t_next = F32(4.0) + F32(F32(pool.k1[0].item()) * F32(5.0))
    jq, _, _ = jax.jit(lambda q: jengine.advance_all(
        jpool, LAT_L, q, jnp.full((1,), 4.0), jnp.float32(t_next),
        admit_order=order))(jq)
    tq, _, _ = engine.advance_all(pool, LAT_L, tq, torch.full((1, 1), 4.0),
                                  torch.tensor([t_next]), admit_order=order)
    assert float(layout.run_pred_s(tq)[0, 0, 0]) == pytest.approx(expect)
    for k in layout.QUEUE_KEYS:
        np.testing.assert_array_equal(np.asarray(jq[k]), tq[k][0].numpy())


def test_push_sequences_layout_identical():
    """Random push sequences (ragged caps, gates, retries) give the same
    packed tensors as the reference's push, env by env."""
    rng = np.random.default_rng(3)
    b, steps = 3, 60
    wc = rng.integers(1, W + 1, N).astype(np.int32)
    tq = layout.empty_queues(N, R, W, batch=b, device="cpu")
    jqs = [jengine.empty_queues(N, R, W) for _ in range(b)]
    for _ in range(steps):
        n = rng.integers(0, N, b)
        f = {"p": rng.integers(16, 512, b).astype(np.int32),
             "d_true": rng.integers(8, 300, b).astype(np.int32),
             "score": rng.uniform(0, 1, b).astype(F32),
             "pred_s": rng.uniform(0, 1, b).astype(F32),
             "pred_d": rng.uniform(8, 300, b).astype(F32),
             "t": rng.uniform(0, 100, b).astype(F32),
             "retry": rng.integers(0, 3, b).astype(np.int32)}
        gate = rng.uniform(size=b) < 0.8
        tq, tpushed = layout.push_wait(
            tq, torch.as_tensor(n), gate=torch.as_tensor(gate),
            wait_cap=torch.as_tensor(wc),
            **{k: torch.as_tensor(v) for k, v in f.items()})
        for i in range(b):
            jqs[i], jp = jengine.push_wait(
                jqs[i], int(n[i]), gate=bool(gate[i]),
                wait_cap=jnp.asarray(wc), **{k: v[i] for k, v in f.items()})
            assert bool(jp) == bool(tpushed[i])
        # drain a random slot now and then so pushes keep landing
        victim, vslot = int(rng.integers(0, N)), int(rng.integers(0, W))
        tq["wait_i"][:, victim, vslot, 0] = 0
        for i in range(b):
            jqs[i] = {**jqs[i], "wait_i": jqs[i]["wait_i"].at[
                victim, vslot, 0].set(0)}
    for i in range(b):
        for k in layout.QUEUE_KEYS:
            np.testing.assert_array_equal(np.asarray(jqs[i][k]),
                                          tq[k][i].numpy(), err_msg=k)


@pytest.mark.parametrize("n,seed", ((6, 0), (64, 3), (1024, 0)))
def test_make_pool_bit_exact(n, seed):
    jp = jprofiles.make_pool(n, seed=seed)
    tp = profiles.make_pool(n, seed=seed, device="cpu")
    for f in ("quality_mean", "quality_std", "log_len_mean", "log_len_std",
              "k1", "k2", "mem_capacity", "mem_per_token"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
    for a, b in zip(jprofiles.memory_caps(jp, 5, 5),
                    profiles.memory_caps(tp, 5, 5)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The four multiply-add sites: inputs where a fused and an unfused multiply-
# add round differently, so that only an engine that fuses exactly where the
# reference does can agree with it.
# ---------------------------------------------------------------------------


def _fma_ref(a, b, c):
    """Correctly rounded float32 a*b + c, computed with exact rationals."""
    out = []
    for x, y, z in zip(np.ravel(a), np.ravel(b), np.ravel(c)):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        g = np.float32(float(v))
        cands = (np.nextafter(g, F32(-np.inf)), g, np.nextafter(g, F32(np.inf)))
        out.append(min(cands, key=lambda q: (abs(Fraction(float(q)) - v),
                                             int(np.float32(q).view(np.int32))
                                             & 1)))
    return np.array(out, F32)


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, 4000).astype(F32)
    b = rng.uniform(-600, 600, 4000).astype(F32)
    c = (rng.uniform(-1, 1, 4000) * 10.0 ** rng.integers(-6, 3, 4000)
         ).astype(F32)
    got = engine.fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                         torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(got, _fma_ref(a, b, c))


def _pools(n, k1, k2, cap, mpt):
    j = lambda x: jnp.asarray(np.broadcast_to(np.asarray(x, F32), (n,)))
    t = lambda x: torch.as_tensor(np.broadcast_to(np.asarray(x, F32),
                                                  (n,)).copy())
    z = np.zeros((n, 1), F32)
    jp = JPool(n_experts=n, n_types=1, quality_mean=jnp.asarray(z),
               quality_std=jnp.asarray(z), log_len_mean=jnp.asarray(z),
               log_len_std=jnp.asarray(z), k1=j(k1), k2=j(k2),
               mem_capacity=j(cap), mem_per_token=j(mpt))
    tp = ExpertPool(n_experts=n, n_types=1, quality_mean=torch.as_tensor(z),
                    quality_std=torch.as_tensor(z),
                    log_len_mean=torch.as_tensor(z),
                    log_len_std=torch.as_tensor(z), k1=t(k1), k2=t(k2),
                    mem_capacity=t(cap), mem_per_token=t(mpt))
    return jp, tp


M_FMA = 512
T_STOP = F32(0.011)


def _fma_case(site):
    """(jax pool, torch pool, numpy queues, clocks, admit order, fused,
    unfused) for one site; clocks sit just below T_STOP so each expert
    takes exactly one action before stopping."""
    rng = np.random.default_rng({"adm": 1, "dec": 2, "fits": 3, "edf": 4}[site])
    m = M_FMA
    clk = np.minimum(rng.uniform(0.0105, 0.011, m).astype(F32),
                     np.nextafter(T_STOP, F32(0)))
    ri = np.zeros((m, 2, 5), np.int32)
    rf = np.zeros((m, 2, 5), F32)
    wi = np.zeros((m, 2, 4), np.int32)
    wf = np.zeros((m, 2, 4), F32)
    k1, k2, cap, mpt = F32(2e-4), F32(3e-5), F32(2e9), F32(1e3)
    order = "fifo"
    if site == "adm":
        k1 = rng.uniform(1e-4, 3e-4, m).astype(F32)
        p = rng.integers(16, 512, m).astype(np.int32)
        wi[:, 0, :3] = np.stack([np.ones(m, np.int32), p,
                                 np.full(m, 50, np.int32)], 1)
        fused = _fma_ref(k1, p.astype(F32), clk)
        plain = (k1 * p.astype(F32)).astype(F32) + clk   # outcome: clocks
    elif site == "dec":
        k2 = rng.uniform(1e-5, 4e-5, m).astype(F32)
        p = rng.integers(16, 512, m).astype(np.int32)
        d = rng.integers(1, 100, m).astype(np.int32)
        ri[:, 0, :4] = np.stack([np.ones(m, np.int32), p,
                                 np.full(m, 10000, np.int32), d], 1)
        tok = (p + d).astype(F32)
        fused = _fma_ref(k2, tok, clk)
        plain = (k2 * tok).astype(F32) + clk
    elif site == "fits":
        rows = []
        while len(rows) < m:
            tk = rng.integers(20, 800, 4096).astype(F32)
            mp = (rng.uniform(0.8, 1.2, 4096) * 0.8e6).astype(F32)
            hp = rng.integers(16, 512, 4096).astype(F32)
            fused_ = _fma_ref(tk[:64], mp[:64], (mp[:64] * (hp[:64] + 1))
                              .astype(F32))
            plain_ = (tk[:64] * mp[:64]).astype(F32) + \
                (mp[:64] * (hp[:64] + 1)).astype(F32)
            for i in np.nonzero(fused_ != plain_)[0]:
                rows.append((tk[i], mp[i], hp[i], fused_[i], plain_[i]))
        tk, mpt, hp, fused, plain = (np.array(c, F32)
                                     for c in zip(*rows[:m]))
        cap = np.minimum(fused, plain)        # admits under one rounding only
        fused, plain = fused <= cap, plain <= cap      # outcome: admitted
        ri[:, 0, :4] = np.stack([np.ones(m, np.int32),
                                 tk.astype(np.int32) - 1,
                                 np.full(m, 10000, np.int32),
                                 np.ones(m, np.int32)], 1)
        wi[:, 0, :3] = np.stack([np.ones(m, np.int32), hp.astype(np.int32),
                                 np.full(m, 50, np.int32)], 1)
    else:  # edf: two waiters whose unfused keys tie and fused keys do not
        order = "edf"
        lat = F32(LAT_L)
        rows = []
        while len(rows) < m:
            t1 = rng.uniform(0, 20, 4096).astype(F32)
            pd1 = rng.uniform(8, 300, 4096).astype(F32)
            pd2 = rng.uniform(8, 300, 4096).astype(F32)
            k1n = (lat * pd1).astype(F32) + t1
            t2 = (k1n - (lat * pd2).astype(F32)).astype(F32)
            k2n = (lat * pd2).astype(F32) + t2
            cand = np.nonzero((k1n == k2n) & (t2 >= 0))[0][:64]
            k1f = _fma_ref(np.full(len(cand), lat), pd1[cand], t1[cand])
            k2f = _fma_ref(np.full(len(cand), lat), pd2[cand], t2[cand])
            for i, j in enumerate(cand):
                if k2f[i] < k1f[i]:
                    rows.append((t1[j], pd1[j], t2[j], pd2[j]))
        t1, pd1, t2, pd2 = (np.array(c, F32) for c in zip(*rows[:m]))
        wi[:, :, 0] = 1
        wi[:, :, 1] = 16
        wi[:, :, 2] = 50
        wf[:, 0, 3], wf[:, 0, 2], wf[:, 1, 3], wf[:, 1, 2] = t1, pd1, t2, pd2
        # outcome: waiter 0 still waits (the fused keys pick waiter 1)
        fused, plain = np.ones(m, bool), np.zeros(m, bool)
    jp, tp = _pools(m, k1, k2, cap, mpt)
    q = {"run_i": ri, "run_f": rf, "wait_i": wi, "wait_f": wf}
    return jp, tp, q, clk, order, fused, plain


# The memory check is left out for the Pallas kernel: in interpret mode it
# takes the queue update and the clock update from differently rounded
# copies of that check on exactly these boundary rows (ROADMAP, queue C).
@pytest.mark.parametrize("site,backend", [
    (site, backend) for site in ("adm", "dec", "fits", "edf")
    for backend in ("xla", "pallas") if (site, backend) != ("fits", "pallas")])
def test_fused_multiply_add_sites_match_reference(site, backend):
    jp, tp, q, clk, order, fused, plain = _fma_case(site)
    assert (fused != plain).any()            # the case can tell them apart
    # under jit, as the reference always runs: eager JAX does not fuse
    jq, jclk, _ = jax.jit(lambda q, c: jengine.advance_all(
        jp, LAT_L, q, c, jnp.float32(T_STOP), backend=backend,
        admit_order=order))({k: jnp.asarray(v) for k, v in q.items()},
                            jnp.asarray(clk))
    tq, tclk, _ = engine.advance_all(
        tp, LAT_L, layout.queues_from_numpy(q, device="cpu"),
        torch.as_tensor(clk),
        torch.tensor(T_STOP), admit_order=order)
    np.testing.assert_array_equal(np.asarray(jclk), tclk.numpy())
    for k in layout.QUEUE_KEYS:
        np.testing.assert_array_equal(np.asarray(jq[k]), tq[k].numpy(),
                                      err_msg=k)
    outcome = {"adm": tclk.numpy(), "dec": tclk.numpy(),
               "fits": tq["run_i"][:, 1, 0].numpy() == 1,
               "edf": tq["wait_i"][:, 0, 0].numpy() == 1}[site]
    np.testing.assert_array_equal(outcome, fused)


# ---------------------------------------------------------------------------
# Dispatch and the kernel wrapper on the CPU
# ---------------------------------------------------------------------------


def _small_args(m=4):
    q = layout.empty_queues(m, R, W, device="cpu")
    par = engine.pool_params(profiles.make_pool(m, device="cpu"))
    return (q["run_i"], q["run_f"], q["wait_i"], q["wait_f"], par,
            torch.zeros(m), torch.ones(m))


def test_backend_dispatch_and_validation():
    pool = profiles.make_pool(N, device="cpu")
    q = layout.empty_queues(N, R, W, batch=2, device="cpu")
    clocks = torch.zeros((2, N))
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.advance_all(pool, LAT_L, q, clocks, torch.ones(2),
                           backend="cuda")
    with pytest.raises(ValueError, match="admit_order"):
        engine.advance_all(pool, LAT_L, q, clocks, torch.ones(2),
                           admit_order="lifo")
    with pytest.raises(ValueError, match="backend"):
        engine.advance_all(pool, LAT_L, q, clocks, torch.ones(2),
                           backend="xla")
    _, new_clocks, acc = engine.advance_all(pool, LAT_L, q, clocks,
                                            torch.tensor([1.0, 2.0]))
    np.testing.assert_array_equal(new_clocks.numpy(),
                                  [[1.0] * N, [2.0] * N])
    assert set(acc) == set(engine.ACC_KEYS) and acc["done"].shape == (2, N)


def test_row_flattened_queues_equal_env_axis():
    """(B, N, ...) queues and the same rows flattened to (B*N, ...) with a
    per-row t_next advance identically."""
    pool = profiles.make_pool(N, device="cpu")
    s = _stream(40, 9)
    q = layout.empty_queues(N, R, W, batch=2, device="cpu")
    for k in range(40):
        q, _ = layout.push_wait(q, torch.tensor([s["expert"][k], k % N]),
                                t=s["t"][k], **{f: s[f][k] for f in FIELDS})
    t_env = torch.tensor([0.5, 3.0])
    a = engine.advance_all(pool, LAT_L, q, torch.zeros((2, N)), t_env)
    flat = {k: v.reshape(2 * N, *v.shape[2:]) for k, v in q.items()}
    b = engine.advance_all(pool, LAT_L, flat, torch.zeros(2 * N),
                           t_env.repeat_interleave(N))
    for k in layout.QUEUE_KEYS:
        np.testing.assert_array_equal(a[0][k].reshape(2 * N, -1).numpy(),
                                      b[0][k].reshape(2 * N, -1).numpy())
    np.testing.assert_array_equal(a[1].reshape(-1).numpy(), b[1].numpy())


def test_prebuilt_par_equals_channels():
    """A pack built once by ``pool_params``, per expert or per row, advances
    exactly as the channels passed on every call; passing both raises."""
    pool = profiles.make_pool(N, device="cpu")
    s = _stream(40, 5)
    q = layout.empty_queues(N, R, W, batch=2, device="cpu")
    for k in range(40):
        q, _ = layout.push_wait(q, torch.tensor([s["expert"][k], k % N]),
                                t=s["t"][k], **{f: s[f][k] for f in FIELDS})
    caps = dict(run_caps=torch.tensor(RUN_CAPS, dtype=torch.int32),
                wait_caps=torch.tensor(WAIT_CAPS, dtype=torch.int32))
    t_env = torch.tensor([0.5, 3.0])
    want = engine.advance_all(pool, LAT_L, q, torch.zeros((2, N)), t_env,
                              **caps)
    par = engine.pool_params(pool, **caps)
    for p in (par, par.repeat(2, 1)):
        got = engine.advance_all(pool, LAT_L, q, torch.zeros((2, N)), t_env,
                                 par=p)
        for k in layout.QUEUE_KEYS:
            assert torch.equal(got[0][k], want[0][k]), k
        assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="par"):
        engine.advance_all(pool, LAT_L, q, torch.zeros((2, N)), t_env,
                           par=par, **caps)


def test_wrapper_takes_plain_version_on_cpu_without_building():
    """On CPU tensors the wrapper runs the plain version: no launch is
    counted and no library gets loaded."""
    before = ops.LAUNCHES
    out = ops.lockstep_advance(*_small_args(), latency_L=LAT_L)
    assert ops.LAUNCHES == before
    assert ops.build._LOADED == {}
    assert [tuple(x.shape) for x in out] == [(4, R, 5), (4, R, 5), (4, W),
                                              (4,), (4, 6)]
