"""What lets the serving steps be captured as CUDA graphs, checked on the
CPU: each step writes the cache in place, so every cache tensor keeps its
storage across prefills and decodes (a replayed graph reads and writes the
addresses it was captured with); a server takes its inputs through device
buffers that also keep their storage; the steps run eagerly where there
is no card; and the launch counters that a graph replay advances.

The graphs themselves, and their launches, are checked on the card
(``tests/test_torch_cuda.py``); the servers' tokens against the
reference's in ``tests/test_torch_serve.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.configs import get_config, reduce_config
from repro_torch.env.serve_engine import ExpertServer, Request
from repro_torch.launch import steps
from repro_torch.models import model as model_lib


def _leaves(tree, prefix=""):
    """Every tensor of a cache by its path."""
    if isinstance(tree, dict):
        out = {}
        for k, x in tree.items():
            out.update(_leaves(x, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, x in enumerate(tree):
            out.update(_leaves(x, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _storage(tree):
    return {k: x.data_ptr() for k, x in _leaves(tree).items()}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-3-4b",
                                  "dbrx-132b"])
def test_server_steps_keep_every_cache_tensor_and_input_buffer(arch):
    """Dense, sliding-window and MoE caches: after prefills into reused
    slots and decodes past the ring, ``pos``, ``kv_pos``, ``k`` and ``v``
    and the server's input buffers have the storage they started with,
    and the host mirror of the positions agrees with the cache."""
    cfg = reduce_config(get_config(arch))
    srv = ExpertServer("s", cfg, model_lib.init_params(cfg, seed=1,
                                                       device="cpu"),
                       slots=2, max_len=64)
    assert not srv.graphed and srv._pool is None          # no card: eager
    cache = _storage(srv.cache)
    rng = np.random.default_rng(3)
    for rid, (p, n) in enumerate(((12, 4), (40, 30), (9, 3), (20, 5))):
        srv.submit(Request(rid=rid, tokens=rng.integers(2, cfg.vocab, p),
                           max_new=n))
    buffers = None
    while srv.has_work():
        srv.step()
        assert _storage(srv.cache) == cache
        now = {b: x.data_ptr() for b, x in srv._prompts.items()}
        now.update(length=srv._length.data_ptr(), slot=srv._slot.data_ptr(),
                   tokens=srv._tokens.data_ptr())
        if buffers is not None:
            assert {k: v for k, v in now.items() if k in buffers} == buffers
        buffers = now
        np.testing.assert_array_equal(srv.pos, srv.cache["pos"].numpy())
    assert srv.iterations["prefill"] == 4 and srv.iterations["decode"] > 20
    assert set(srv._prompts) == {16, 64, 32}
    assert srv._graphs == {}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_recurrent_decode_keeps_every_state_tensor(arch):
    """RWKV6 and RecurrentGemma caches (states, conv windows, rings, the
    shared pos): 20 decode steps, past a ring of 16, write them in place,
    and change them."""
    overrides = {"window": 16} if arch == "recurrentgemma-2b" else {}
    cfg = reduce_config(get_config(arch), **overrides)
    params = model_lib.init_params(cfg, seed=2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(2, cfg.vocab,
                                                             (2, 16)),
                           dtype=torch.int32)
    _, cache = steps.make_prefill_step(cfg, 40)(params, toks)
    storage = _storage(cache)
    before = {k: x.clone() for k, x in _leaves(cache).items()}
    decode = steps.make_decode_step(cfg)
    tok = toks[:, -1]
    for _ in range(20):
        logits, out = decode(params, cache, tok)
        assert out is cache and _storage(cache) == storage
        tok = logits.argmax(-1).to(torch.int32)
    assert int(cache["pos"]) == 36
    changed = [k for k, x in _leaves(cache).items()
               if not torch.equal(x, before[k])]
    assert "pos" in changed and len(changed) > 1


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b",
                                  "qwen1.5-0.5b"])
def test_decode_step_on_cpu_is_the_models_step(arch):
    """``make_decode_step`` on CPU tensors is the model's decode step: the
    same logits, the same cache, updated in place; it captures nothing."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=6, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(2, cfg.vocab,
                                                             (2, 8)),
                           dtype=torch.int32)
    _, cache = steps.make_prefill_step(cfg, 24)(params, toks)
    caches = [steps.clone_cache(cache) for _ in range(2)]
    tok = toks[:, -1]
    decode = steps.make_decode_step(cfg)
    out, c = decode(params, caches[0], tok)
    ref, _ = model_lib.decode_step(params, cfg, caches[1], tok)
    assert c is caches[0] and decode.graphs == {}
    assert torch.equal(out, ref)
    for k, x in _leaves(caches[1]).items():
        assert torch.equal(x, _leaves(caches[0])[k]), k


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_cache_copies_keep_storage_and_values(arch):
    """``clone_cache`` gives equal tensors in storage of their own;
    ``copy_cache_`` writes a second prompt's cache into the first's
    storage, as the graphed decode step takes in each new prompt."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=8, device="cpu")
    rng = np.random.default_rng(9)
    prefill = steps.make_prefill_step(cfg, 24)
    a, b = (prefill(params, torch.as_tensor(rng.integers(2, cfg.vocab,
                                                         (2, 8)),
                                            dtype=torch.int32))[1]
            for _ in range(2))
    clone = steps.clone_cache(a)
    assert set(_storage(clone).values()).isdisjoint(_storage(a).values())
    for k, x in _leaves(clone).items():
        assert torch.equal(x, _leaves(a)[k]), k
    storage = _storage(a)
    steps.copy_cache_(a, b)
    assert _storage(a) == storage
    for k, x in _leaves(a).items():
        assert torch.equal(x, _leaves(b)[k]), k
    assert any(not torch.equal(x, _leaves(clone)[k])
               for k, x in _leaves(a).items())


def test_launch_counts_add_and_restore():
    """``add_launch_counts`` moves every kernel's counter by its delta, in
    the order of ``COUNTERS``, as a graph replay does."""
    from repro_torch.kernels.decode_attn import ops as b3
    from repro_torch.kernels.moe_gemm import ops as b4

    start = graphs.launch_counts()
    assert len(start) == len(graphs.COUNTERS) == 7
    delta = tuple(range(1, 8))
    graphs.add_launch_counts(delta)
    try:
        assert graphs.launch_counts() == tuple(a + d for a, d in
                                               zip(start, delta))
        names = [f"{m}.{a}" for m, a in graphs.COUNTERS]
        assert b3.LAUNCHES == start[names.index("decode_attn.LAUNCHES")] + 3
        assert b4.GEMM_LAUNCHES == \
            start[names.index("moe_gemm.GEMM_LAUNCHES")] + 5
    finally:
        graphs.add_launch_counts(tuple(-d for d in delta))
    assert graphs.launch_counts() == start


# ---------------------------------------------------------------------------
# The routing loop and the recurrent prefill as the graphs run them
# ---------------------------------------------------------------------------


def _routing_setup(fmt):
    from repro_torch.core import sac
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(6, ragged_caps=fmt == "segments",
                                   device="cpu")
    model = sac.init_params(route.sac_config(env_cfg), seed=4, device="cpu")
    pols = {p.name: p for p in route.make_policies(env_cfg, model,
                                                   obs_fmt=fmt)}
    return env_cfg, pool, pols


def _own_draws(env_cfg, pool, n_steps, b, seed):
    """Arrival times and pending requests drawn once, to inject."""
    from repro_torch.env import env as env_lib

    gen = torch.Generator().manual_seed(seed)
    rows = [env_lib._new_request(env_cfg, pool, gen, b)
            for _ in range(n_steps + 1)]
    return {"pending0": rows[0],
            "clock": torch.cumsum(torch.rand((n_steps, b), generator=gen)
                                  * 0.4, 0),
            "pending": {k: torch.stack([r[k] for r in rows[1:]])
                        for k in rows[0]}}


def _same_state(a, b):
    for k, x in a.items():
        if k == "gen" or x is None:
            continue
        if isinstance(x, dict):
            _same_state(x, b[k])
        else:
            assert torch.equal(x, b[k]), k


def _functional_loop(env_cfg, pool, policy, n_steps, b, draws, seed=1234):
    """The routing loop of functional steps (each ``env.step`` returns a new
    state), as the reference's scan runs it, on injected draws."""
    from repro_torch.core import features
    from repro_torch.env import env as env_lib

    state = env_lib.reset(env_cfg, pool, torch.Generator().manual_seed(seed),
                          b, pending=draws["pending0"])
    pstate = policy.init_state(b, "cpu")
    act_gen = torch.Generator().manual_seed(seed + 1)
    rew_sum = torch.zeros(b)
    for i in range(n_steps):
        obs = (None if policy.obs_fmt is None else
               features.build_obs(env_cfg, pool, state, fmt=policy.obs_fmt))
        a, pstate = policy.act(pstate, state, obs, act_gen)
        state, r, _ = env_lib.step(env_cfg, pool, state, a, draws={
            "clock": draws["clock"][i],
            "pending": {k: v[i] for k, v in draws["pending"].items()}})
        rew_sum += r
    out = {k: float(v.mean())
           for k, v in env_lib.episode_metrics(state).items()}
    out["mean_reward"] = float((rew_sum / n_steps).mean())
    return out, state


@pytest.mark.parametrize("fmt", ["padded", "segments"])
@pytest.mark.parametrize("policy", ["QLL", "RR", "SAC"])
def test_routing_step_on_static_tensors_equals_functional_loop(fmt, policy):
    """The routing step as the CUDA graph runs it (``RoutingLoop``: the env
    state, the policy state and the reward sum in static tensors updated
    in place, each step's draws copied into buffers) equals a loop of
    functional steps on the same injected draws: the same metrics and
    final state, bit for bit.  Every static tensor keeps its storage, the
    draws are left as they were, on the CPU nothing is captured, and
    ``evaluate`` is that loop."""
    from repro_torch.core import training

    env_cfg, pool, pols = _routing_setup(fmt)
    pol = pols[policy]
    n_steps, b = 24, 3
    draws = _own_draws(env_cfg, pool, n_steps, b, seed=5)
    kept = {k: x.clone() for k, x in _leaves(draws).items()}
    want, want_state = _functional_loop(env_cfg, pool, pol, n_steps, b,
                                        draws)
    loop = training.RoutingLoop(env_cfg, pool, pol, b, draws=draws)
    owned = lambda: {k: x.data_ptr() for k, x in _leaves(
        {"state": {k: v for k, v in loop.state.items()
                   if k not in ("gen", "wait_caps")},
         "pstate": loop.pstate, "rew": loop.rew_sum}).items()}
    static = owned()
    for _ in range(n_steps):
        loop.run(1)
        assert owned() == static
    assert loop.graph is None and loop.steps == n_steps
    assert loop.metrics() == want
    _same_state(loop.state, want_state)
    got, got_state = training.evaluate(env_cfg, pool, pol, n_steps=n_steps,
                                       n_envs=b, draws=draws,
                                       return_state=True)
    assert got == want
    _same_state(got_state, want_state)
    for k, x in _leaves(draws).items():
        assert torch.equal(x, kept[k]), k
    assert want["completed"] > 0


@pytest.mark.parametrize("policy", ["SQF", "BR", "SAC"])
def test_evaluate_on_cpu_runs_the_eager_loop_either_way(policy):
    """On the CPU ``evaluate`` runs eagerly with or without ``graphs``, from
    its own seeded draws: both calls agree, and ``timing`` splits the
    first step from the rest."""
    from repro_torch.core import training

    env_cfg, pool, pols = _routing_setup("padded")
    runs = []
    for g in (True, False):
        timing = {}
        runs.append(training.evaluate(env_cfg, pool, pols[policy],
                                      n_steps=25, n_envs=2, graphs=g,
                                      timing=timing, return_state=True))
        assert set(timing) == {"first_s", "rest_s"}
        assert timing["first_s"] > 0 and timing["rest_s"] > 0
    assert runs[0][0] == runs[1][0]
    _same_state(runs[0][1], runs[1][1])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_prefill_step_on_cpu_is_the_models_prefill(arch):
    """``make_prefill_step`` on CPU tensors is the model's prefill, call
    after call, and captures nothing."""
    cfg = reduce_config(get_config(arch))
    params = model_lib.init_params(cfg, seed=12, device="cpu")
    rng = np.random.default_rng(13)
    prefill = steps.make_prefill_step(cfg, 24)
    for shape in ((2, 8), (1, 16), (2, 8)):
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, shape),
                               dtype=torch.int32)
        logits, cache = prefill(params, toks)
        ref, ref_cache = model_lib.prefill(params, cfg, toks, 24)
        assert torch.equal(logits, ref)
        for k, x in _leaves(ref_cache).items():
            assert torch.equal(_leaves(cache)[k], x), k
    assert prefill.graphs == {}
