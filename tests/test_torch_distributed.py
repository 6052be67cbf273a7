"""The port's sharded router training on the CPU: the capacity-sharded
replay bodies against the reference's, the sharding helpers' errors, and
multi-process runs on gloo (``tests/torch_dist_worker.py``, one process
per rank on a ``FileStore`` under ``tmp_path``):

  * three sharded iterations on 4 ranks (``expert`` = 4), on 2 x 2
    (``data`` x ``expert``) and on a world of one with ``data`` = 1,
    bit-equal to the unsharded iteration (parameters, AdamW moments,
    env state, the shards' buffer rows concatenated, ``aux``);
  * ``launch/train.py --router --router-mesh`` on 2 ranks.

The engine's ``"shard"`` backend and the collectives are in
``tests/test_torch_collectives.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay as jreplay
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro_torch.core import replay, sac, training
from repro_torch.distributed import sharding
from repro_torch.env import engine, env as env_lib
from repro_torch.launch import mesh as mesh_lib
from torch_dist_worker import run_world

def tt(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# The shard bodies against the reference's, in one process
# ---------------------------------------------------------------------------


def _transitions(rng, n):
    obs = {"a": rng.normal(size=(n, 3)).astype(np.float32),
           "b": rng.integers(0, 7, (n, 2)).astype(np.int32)}
    nxt = {"a": obs["a"] + 1, "b": obs["b"] + 1}
    return (obs, rng.integers(0, 4, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32), np.ones(n, np.float32),
            nxt)


def _jsplit(buf, i, n_shards):
    per = buf["action"].shape[0] // n_shards
    cut = lambda x: x[i * per:(i + 1) * per]
    out = {k: jax.tree.map(cut, buf[k]) for k in ("obs", "next_obs")}
    out.update({k: cut(buf[k]) for k in ("action", "reward", "discount")})
    out.update({k: buf[k] for k in ("ptr", "size", "capacity")})
    return out


def _same(want, got):
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _rows(buf):
    return {k: buf[k] for k in ("obs", "next_obs", "action", "reward",
                                "discount")}


INSERT = [("insert", s, cap, b, rounds) for s in (1, 2, 4, 8)
          for cap, b, rounds in ((16, 4, 2), (16, 4, 7), (32, 6, 9))]
SAMPLE = [("sample", s, 16, b, 3) for s in (1, 2, 4) for b in (1, 8, 32)]
OWNERSHIP = [("ownership", 4, 16, 32, 1)]


@pytest.mark.parametrize("kind,n_shards,capacity,batch,rounds",
                         INSERT + SAMPLE + OWNERSHIP,
                         ids=lambda v: str(v))
def test_shard_bodies_match_reference(kind, n_shards, capacity, batch,
                                      rounds):
    """The grid of the reference's ``tests/test_replay_sharded.py``: each
    shard's insert (ring wraps, batches across shard boundaries, shards
    smaller than a batch) and each shard's sample part bit-equal to the
    reference's shard bodies; the shards' union equal to ``add_batch`` and
    the sum of their parts to ``sample``; each sampled row from one
    shard."""
    rng = np.random.default_rng(capacity * 100 + n_shards * 10 + batch)
    fill = 4 if kind == "sample" else 16 if kind == "ownership" else batch
    example = jax.tree.map(lambda x: x[0], _transitions(rng, 1)[0])
    jref = jreplay.init(capacity, jax.tree.map(jnp.asarray, example))
    ref = replay.init(capacity, jax.tree.map(tt, example), device="cpu")
    fresh = replay.init(capacity, jax.tree.map(tt, example), device="cpu")
    jshards = [_jsplit(jref, i, n_shards) for i in range(n_shards)]
    shards = [sharding.shard_replay_buffer(fresh, _Mesh(i, expert=n_shards))
              for i in range(n_shards)]
    jins = jax.jit(jreplay.shard_add_batch,
                   static_argnames=("shard_idx", "n_shards"))
    for _ in range(rounds):
        tr = _transitions(rng, fill)
        jref = jax.jit(jreplay.add_batch)(jref, *tr)
        jshards = [jins(s, *tr, shard_idx=i, n_shards=n_shards)
                   for i, s in enumerate(jshards)]
        ttr = [jax.tree.map(tt, x) for x in tr]
        replay.add_batch(ref, *ttr)
        for i, s in enumerate(shards):
            replay.shard_add_batch(s, *ttr, shard_idx=i, n_shards=n_shards)
    for js, s in zip(jshards, shards):
        _same(_rows(js), _rows(s))
        assert int(s["ptr"]) == int(jref["ptr"])
        assert int(s["size"]) == int(jref["size"])
        assert s["capacity"] == capacity
    union = jax.tree.map(lambda *xs: torch.cat(xs),
                         *[_rows(s) for s in shards])
    _same(_rows(jref), union)
    if kind == "insert":
        return

    key = jax.random.PRNGKey(7 + batch)
    idx = jax.random.randint(key, (batch,), 0, jnp.maximum(jref["size"], 1))
    jsample = jax.jit(jreplay.shard_sample_local,
                      static_argnames=("batch_size", "shard_idx", "n_shards"))
    parts = []
    for i, (js, s) in enumerate(zip(jshards, shards)):
        want = jsample(js, key, batch, shard_idx=i, n_shards=n_shards)
        got = replay.shard_sample_local(s, None, batch, shard_idx=i,
                                        n_shards=n_shards, idx=tt(idx))
        _same(want, got)
        parts.append(got)
    _same(jreplay.sample(jref, key, batch),
          jax.tree.map(lambda *xs: sum(xs), *parts))
    if kind == "ownership":
        hits = np.stack([p["reward"].numpy() != 0.0 for p in parts])
        assert (hits.sum(0) == 1).all()


def test_shard_draws_match_the_unsharded_sample():
    """Without ``idx`` every shard draws what ``sample`` draws from the
    same generator state."""
    rng = np.random.default_rng(5)
    example = jax.tree.map(lambda x: tt(x[0]), _transitions(rng, 1)[0])
    buf = replay.init(12, example, device="cpu")
    replay.add_batch(buf, *[jax.tree.map(tt, x)
                            for x in _transitions(rng, 10)])
    want = replay.sample(buf, torch.Generator().manual_seed(3), 64)
    parts = [replay.shard_sample_local(
        sharding.shard_replay_buffer(buf, _Mesh(i, expert=3)),
        torch.Generator().manual_seed(3), 64, shard_idx=i, n_shards=3)
        for i in range(3)]
    got = jax.tree.map(lambda *xs: sum(xs), *parts)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert torch.equal(w, g)


# ---------------------------------------------------------------------------
# Errors, against the reference's
# ---------------------------------------------------------------------------


class _Mesh:
    """What the helpers read of a mesh: axis names and sizes, and this
    rank's coordinate ``at`` on every axis (a stand-in for each shard of
    a mesh in one process)."""

    def __init__(self, at=0, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.sizes, self.at = sizes, at
        # the reference's helpers read ``.shape`` as a dict
        self.shape = sizes

    def size(self, i):
        return self.sizes[self.mesh_dim_names[i]]

    def get_local_rank(self, axis):
        return self.at


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("call", ["replay", "data", "mesh", "mesh0"])
def test_sharding_errors_match_reference(call):
    if call == "replay":
        m = _Mesh(expert=2)
        assert sharding.replay_shards(None, 63) == 1
        assert sharding.replay_shards(m, 64) == jsharding.replay_shards(m, 64)
        args = (m, 63)
        names = "replay_shards"
    elif call == "data":
        m = _Mesh(data=2, expert=1)
        assert sharding.data_shards(None, 3) == 1
        assert sharding.data_shards(m, 4) == jsharding.data_shards(m, 4) == 2
        args = (m, 3)
        names = "data_shards"
    else:
        data = 3 if call == "mesh" else 0
        assert _error(mesh_lib.make_train_mesh, 4, data=data) == _error(
            jmesh.make_train_mesh, 4, data=data)
        return
    assert _error(getattr(sharding, names), *args) == _error(
        getattr(jsharding, names), *args)


def test_a_second_nccl_rank_on_one_gpu_raises(monkeypatch):
    """NCCL takes one GPU per rank: a local rank without a GPU of its own
    raises, naming the cause, before any process group starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    assert mesh_lib._rank_device(cuda, 0, 2) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        mesh_lib._rank_device(cuda, 1, 2)
    assert mesh_lib._rank_device(torch.device("cpu"), 3, 4).type == "cpu"
    assert mesh_lib.backend_for(cuda) == "nccl"
    assert mesh_lib.backend_for(torch.device("cpu")) == "gloo"


def test_expert_rows_split_only_when_the_axis_divides():
    assert sharding.expert_rows(None, 6) == slice(0, 6)
    assert sharding.expert_rows(_Mesh(expert=1), 6) == slice(0, 6)
    assert sharding.expert_rows(_Mesh(expert=4), 6) == slice(0, 6)
    assert sharding.expert_rows(_Mesh(expert=3), 6) == slice(0, 2)
    assert sharding.expert_rows(_Mesh(2, expert=3), 6) == slice(4, 6)


def test_engine_and_training_errors_match_reference():
    """The reference's messages (``engine.py:410-413``,
    ``training.py:255-261``), with the port's backend names."""
    from repro_torch.env import engine_layout as layout, profiles

    pool = profiles.make_pool(6, device="cpu")
    q = layout.empty_queues(6, 2, 2, batch=1, device="cpu")
    clocks = torch.zeros((1, 6))
    assert _error(engine.advance_all, pool, 0.03, q, clocks, 1.0,
                  backend="shard", mesh=_Mesh(expert=4)) == (
        "n_experts=6 not divisible by mesh axis 'expert'=4")
    assert _error(engine.advance_all, pool, 0.03, q, clocks, 1.0,
                  backend="shard", mesh=_Mesh(expert=1),
                  shard_body="xla") == "unknown shard_body 'xla'"

    env_cfg = env_lib.EnvConfig(n_experts=3, run_cap=2, wait_cap=2)
    pool = env_lib.make_env_pool(env_cfg, device="cpu")
    sac_cfg = sac.SACConfig(n_actions=4, hidden=16, flat_dim=9)
    tc = training.TrainConfig(n_envs=2, buffer_capacity=64)
    st = training.init_train_state(env_cfg, sac_cfg, tc, pool)
    shard_cfg = env_lib.EnvConfig(n_experts=3, run_cap=2, wait_cap=2,
                                  engine_backend="shard")
    assert _error(training.make_iteration, shard_cfg, tc, pool, st,
                  mesh=_Mesh(expert=1)) == (
        "engine_backend='shard' cannot nest inside the sharded training "
        "iteration; use 'torch' or 'cuda' for the env engine")
    no_expert = _Mesh(data=1)
    assert _error(training.init_train_state, env_cfg, sac_cfg, tc, pool,
                  mesh=no_expert) == (
        f"training mesh has no 'expert' axis: {no_expert}")


# ---------------------------------------------------------------------------
# Multi-process runs on gloo
# ---------------------------------------------------------------------------


BUF_RING = ("buf ptr", "buf size")


@pytest.mark.parametrize("world,data", [(4, 0), (4, 2), (1, 1)],
                         ids=["expert4", "data2xexpert2", "one-rank-data1"])
def test_sharded_iteration_equals_unsharded(tmp_path, world, data):
    """Three iterations of the reference test's config on
    ``make_train_mesh(data=...)``: every rank's parameters, moments,
    AdamW step, observation and ring scalars equal the unsharded run's;
    each data row's buffer shards, concatenated in ``expert`` order,
    equal the unsharded buffer; the data rows' env states, concatenated,
    equal the unsharded envs; ``aux`` equal on every rank."""
    res = run_world("iteration", world, tmp_path, str(data))
    plain = res[0]["plain"]
    n_data, n_exp = res[0]["sizes"]
    assert (n_data, n_exp) == ((data or 1), world // (data or 1))
    for rank, r in enumerate(res):
        # the mesh's ranks are device_order verbatim, row-major
        assert r["ranks"] == r["order"] == list(range(world))
        assert r["coord"] == divmod(rank, n_exp)
    by = {r["coord"]: r["sharded"] for r in res}
    want = plain["tensors"]
    assert int(want["buf size"]) == 12 and int(want["buf ptr"]) == 12
    assert plain["aux"][-1]["critic_loss"] != 0.0
    for name, x in want.items():
        if name.startswith("buf ") and name not in BUF_RING:
            for d in range(n_data):
                got = torch.cat([by[(d, e)]["tensors"][name]
                                 for e in range(n_exp)])
                assert torch.equal(got, x), (name, d)
        elif name.startswith("env "):
            for e in range(n_exp):
                got = torch.cat([by[(d, e)]["tensors"][name]
                                 for d in range(n_data)])
                assert torch.equal(got, x), (name, e)
        else:
            for coord, s in by.items():
                assert torch.equal(s["tensors"][name], x), (name, coord)
    for s in by.values():
        assert s["aux"] == plain["aux"]


def test_router_mesh_cli_on_two_ranks(tmp_path):
    """``launch/train.py --router --router-mesh --iters 2`` in a world of
    two: rank 0 alone writes ``--out``, and the router equals the
    unsharded CLI's."""
    res = run_world("cli", 2, tmp_path)
    assert res[0]["wrote"] and res[1]["wrote"] is None
    got = np.load(tmp_path / "mesh.npz")
    want = np.load(tmp_path / "plain.npz")
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], k)
