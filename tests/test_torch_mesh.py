"""The port's LM model mesh on the CPU against the JAX reference.

In one process, with the reference's duck-typed ``FakeMesh``
(``tests/test_sharding_rules.py``) for the production meshes:

  * every parameter's spec, for training and serving, of every
    architecture on both production meshes, through the port's own
    module paths (``models.io.reference_groups``); the Adafactor and AdamW state specs (the reference's ``state_specs``);
  * the cache specs of four architectures by the reference's cache names;
    ``batch_axes``' fallbacks, ``activation_rules``, ``MeshPolicy``,
    ``use_mesh_policy`` and ``make_host_mesh``'s clipping;
  * ``_moe_sharded``: the port's per-rank bodies, summed over every
    coordinate of a 2 x 2 mesh, against the reference's ``_moe_sharded``
    on a 2 x 2 mesh of four forced host devices (a subprocess, as
    ``tests/test_multidevice.py`` runs it), reduced dbrx-132b in float32
    with a capacity that drops tokens, and the fallbacks.

On 4 and 2 gloo ranks (``tests/torch_dist_worker.py``, one CPU process
each): LM training (reduced qwen1.5-0.5b, dbrx-132b, whisper-medium,
rwkv6-7b and recurrentgemma-2b, the last under remat with Adafactor) on
2 x 2, 4 x 1 and 1 x 4 against one process, computing Megatron-style on
each rank's blocks, which are all a rank holds (and two rwkv6 variants
whose channel mix keeps one width whole, on 1 x 4); a batch that does not
split over the data axis; an elastic restart, in a world of one from a
2 x 2 checkpoint and by ``reshard_state`` between meshes of the same
world; serving every arch under
1 x 4 and 2 x 2 policies; the residual stream split by sequence over
``model`` (``cfg.seq_parallel``: training and prefill of qwen and dbrx on
1 x 4 and 2 x 2 against one process and the flag off, and the sequence
split's bytes against the specs); and ``launch/train.py --data-parallel
2`` and ``--arch recurrentgemma-2b --model-parallel 2``.  In one
process: the recurrent families' training blocks by ``block_spec`` on
1 x 2 and 2 x 2 coordinates, and ``best_mesh_after_failure`` against
the reference's.  The per-rank bodies of the split, summed in one
process, are ``tests/test_torch_megatron.py``.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, list_archs
from repro.distributed import api as japi, sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import api, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import io, model as model_lib, moe
from repro_torch.train import checkpoint, optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib
from torch_dist_worker import (CKPT22, LM_ARCHS, LM_BATCH, LM_SEQ,
                               LM_SHAPES, LM_STEPS, LM_TRAIN, MIXED_RUNS,
                               RESHARD_ARCHS,
                               RESHARD_SHAPES, SEQ_ARCHS, SEQ_PROMPTS,
                               SEQ_SHAPES, SERVE_ARCHS, SERVE_DECODES,
                               SERVE_PROMPTS, SERVE_SHAPES, TRAIN_ARCHS,
                               lm_cfg, moe_dp_grads, moe_dp_inputs,
                               run_world)

REPO = os.path.join(os.path.dirname(__file__), "..")


class FakeMesh:
    """Duck-typed mesh exposing .shape only (rules never touch devices)."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {
    "pod16x16": FakeMesh({"data": 16, "model": 16}),
    "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}


def _ref_paths(tree) -> dict:
    """A reference tree's leaves by ``/``-joined path: (names, shape)."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        out["/".join(map(str, names))] = (path, tuple(x.shape))
    return out


def _port_leaves(cfg) -> dict:
    """The port's leaves of ``cfg`` at full size on the meta device:
    ``/``-joined reference path -> stacked shape."""
    model, _ = io._model_and_offsets(cfg, torch.device("meta"))
    out = {}
    for k, leaf in io.reference_groups(model, cfg).items():
        if isinstance(leaf, torch.Tensor):
            out[k] = tuple(leaf.shape)
        else:
            out[k] = (len(leaf),) + tuple(leaf[0].shape)
    return out


# ---------------------------------------------------------------------------
# The rules against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(list_archs()))
def test_param_and_state_specs_match_reference(arch, mesh_name):
    """Every tensor's spec, train and serve, equals the reference's; the
    port's module paths reach every reference leaf (whisper-medium's two
    stacks too); Adafactor's and AdamW's state specs equal the reference's
    ``state_specs`` rule (``param_spec`` of the moment's own shape by its
    leaf's path)."""
    mesh = MESHES[mesh_name]
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                       cfg))
    ref = _ref_paths(shapes)
    port = _port_leaves(get_config(arch))
    assert port == {k: shape for k, (_, shape) in ref.items()}
    for train in (True, False):
        got = sharding.shard_params_specs(port, mesh, train=train)
        for k, (path, shape) in ref.items():
            want = tuple(jsharding.param_spec(path, shape, mesh, train=train))
            assert got[k] == want, (k, train, got[k], want)
    specs = sharding.shard_params_specs(port, mesh, train=True)
    leaves = {k: torch.empty(sharding.local_shape(s, specs[k], mesh),
                             device="meta") for k, s in port.items()}
    layout = types.SimpleNamespace(mesh=mesh, specs=specs, shapes=port)
    for name in ("adafactor", "adamw"):
        jstate = jax.eval_shape(jopt.make_optimizer(name).init, shapes)
        want = {}
        for k, (path, shape) in _ref_paths(jstate).items():
            sub = [p for p in path if getattr(p, "key", None)
                   not in ("m", "v", "vr", "vc")]
            want[k] = tuple(jsharding.param_spec(sub, shape, mesh, train=True))
        opt = opt_lib.make_optimizer(name)(leaves, layout)
        assert opt.state_specs() == want, name
        assert {k: tuple(x.shape) for k, x in opt.state().items()} == {
            k: sharding.local_shape(_ref_paths(jstate)[k][1], want[k], mesh)
            for k in want}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_cache_specs_match_reference(arch):
    mesh = MESHES["pod16x16"]
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_cache(cfg, 128, 1024))
    tree = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), shapes)
    got = sharding.shard_cache_specs(tree, mesh, 128)
    for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want = tuple(jsharding.cache_spec(path, x.shape, mesh, 128))
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert node == want, (arch, path, node, want)
        names = [getattr(p, "key", None) for p in path]
        assert sharding.cache_spec(names, x.shape, mesh, 128) == want


def test_batch_axes_data_spec_and_batch_spec():
    mesh = MESHES["pod2x16x16"]
    assert sharding.batch_axes(mesh, 256) == ("pod", "data")
    assert sharding.batch_axes(mesh, 32) == ("pod", "data")
    assert sharding.batch_axes(mesh, 16) == ("data",)   # largest divisible
    assert sharding.batch_axes(mesh, 8) == ("pod",)
    assert sharding.batch_axes(mesh, 1) is None
    for m in MESHES.values():
        for b in range(1, 513):
            assert sharding.batch_axes(m, b) == jsharding.batch_axes(m, b)
    host = FakeMesh({"data": 2, "model": 2})
    assert sharding.data_spec(host, 8, 3) == ("data", None, None)
    assert sharding.batch_spec(host, 8, 1) == ("data", None)
    assert sharding.batch_spec(host, 8, 2) == (None, "data", None)
    # rows that do not split over the data axis: every data rank holds
    # them all (the reference's fallback; the loss divides its share,
    # test_batch_that_does_not_split_matches_one_process)
    assert sharding.batch_spec(host, 6, 2) == (None, None, None)
    assert sharding.batch_spec(MESHES["pod2x16x16"], 16) == ("data", None)


def test_activation_rules_policy_and_its_nesting():
    for m in MESHES.values():
        for train in (True, False):
            assert sharding.activation_rules(m, train=train) == \
                jsharding.activation_rules(m, train=train)
        rules = sharding.activation_rules(m, train=True)
        axes = ("batch", "seq", "embed", "experts", None)
        assert api.MeshPolicy(m, rules).spec(axes) == tuple(
            japi.MeshPolicy(m, rules).spec(axes))
    outer, inner = api.MeshPolicy(None, {}), api.MeshPolicy(None, {})
    assert api.current_policy() is None
    with api.use_mesh_policy(outer):
        with api.use_mesh_policy(inner):
            assert api.current_policy() is inner
            with api.use_mesh_policy(None):
                assert api.current_policy() is None
            assert api.current_policy() is inner
        assert api.current_policy() is outer
    assert api.current_policy() is None
    x = torch.ones(3)
    assert api.constrain(x, "batch") is x


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_host_mesh_clips_as_the_reference(world, monkeypatch):
    """``make_host_mesh(data, model)``'s shape in a world of ``world``
    ranks equals the reference's on as many devices; the production
    meshes need 256 (512) ranks and raise with the reference's message
    below."""
    monkeypatch.setattr(mesh_lib.dist, "get_world_size", lambda *a: world)
    monkeypatch.setattr(mesh_lib, "_grid", lambda shape, names: (shape,
                                                                 names))
    monkeypatch.setattr(jmesh.jax, "devices", lambda *a: [None] * world)
    monkeypatch.setattr(jmesh, "make_mesh_compat", lambda shape, axes: (
        tuple(shape), tuple(axes)))
    for data in range(1, 10):
        for model in range(1, 10):
            assert mesh_lib.make_host_mesh(data, model) == \
                jmesh.make_host_mesh(data, model), (data, model)
    for multi in (False, True):
        with pytest.raises(ValueError) as e:
            mesh_lib.make_production_mesh(multi_pod=multi)
        assert str(e.value) == (f"Number of devices {world} must be >= the "
                                f"product of mesh_shape "
                                f"{(2, 16, 16) if multi else (16, 16)}")
    monkeypatch.setattr(mesh_lib.dist, "get_world_size", lambda *a: 512)
    assert mesh_lib.make_production_mesh() == ((16, 16), ("data", "model"))
    assert mesh_lib.make_production_mesh(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_reference_weights_carried_onto_each_rank(arch, train):
    """``sharded_params_from_numpy`` on every coordinate of a 2 x 2 mesh:
    each rank's blocks are the reference's tree cut by the reference's
    spec at that coordinate, and they are the parameters of the model it
    computes with: no whole tensor of a split leaf; a block split over
    ``data`` carries its spec to be gathered at its use."""
    from repro.configs import reduce_config as jax_reduce_config
    from repro.models import transformer as jtf

    cfg = reduce_config(get_config(arch))
    jcfg = jax_reduce_config(jax_get_config(arch))
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(1), jcfg))
    fake = FakeMesh({"data": 2, "model": 2})
    ref = _ref_paths(tree)
    whole = {k: np.asarray(x) for k, x in
             zip(ref, jax.tree_util.tree_leaves(tree))}
    for d in range(2):
        for m in range(2):
            sp = io.sharded_params_from_numpy(
                tree, cfg, sharding.Coord({"data": 2, "model": 2},
                                          {"data": d, "model": m}),
                train=train, device="cpu")
            assert set(sp.leaves) == set(ref)
            for k, (path, shape) in ref.items():
                spec = jsharding.param_spec(path, shape, fake, train=train)
                want = whole[k]
                for dim, entry in enumerate(spec):
                    axes = sharding.spec_axes(entry)
                    if axes:
                        n = int(np.prod([2 for _ in axes]))
                        i = (d * 2 + m if axes == ("data", "model")
                             else {"data": d, "model": m}[axes[0]])
                        per = want.shape[dim] // n
                        want = np.take(want, range(i * per, (i + 1) * per),
                                       axis=dim)
                leaf = sp.leaves[k]
                got = (leaf if isinstance(leaf, torch.Tensor)
                       else torch.stack(list(leaf)))
                np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
            held = {id(x) for leaf in sp.leaves.values() for x in
                    (leaf if isinstance(leaf, list) else [leaf])}
            assert {id(p) for p in sp.model.parameters()} == held
            for k, leaf in sp.leaves.items():
                spec = sp.specs[k]
                for x in (leaf if isinstance(leaf, list) else [leaf]):
                    data = any("data" in sharding.spec_axes(e)
                               for e in spec)
                    assert (getattr(x, "gather_spec", None) ==
                            (spec[-x.dim():] if data else None)), k
            for name, p in sp.model.named_parameters():
                if ".moe.w_" in name:
                    assert p.shape[0] == cfg.n_experts // 2, name


# ---------------------------------------------------------------------------
# _moe_sharded against the reference's on four forced host devices
# ---------------------------------------------------------------------------

# (name, config overrides, tokens): capacity that drops tokens; a bf16
# combine; the reference's two fallbacks (E % model, T % n_data)
MOE_CASES = [("drops", {"capacity_factor": 0.5}, 64),
             ("drops_more", {"capacity_factor": 0.25}, 128),
             ("bf16_combine", {"capacity_factor": 0.5,
                               "moe_psum_dtype": "bfloat16"}, 64),
             ("fallback_experts", {"n_experts": 3, "capacity_factor": 0.5}, 64),
             ("fallback_tokens", {"capacity_factor": 0.5}, 63)]
# float32 products and sums in another order than XLA's, on outputs up to
# ~70 that are sums of many terms of either sign: within 1e-5 relative, or
# 1e-6 of the largest output; a bf16 combine rounds each partial
MOE_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}


def _close_moe(got, want, dtype):
    rtol, scale = MOE_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))

REFERENCE_MOE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduce_config
from repro.models import moe
from repro.launch.mesh import make_mesh_compat
mesh = make_mesh_compat((2, 2), ("data", "model"))
out = {}
for name, over, t in json.loads(sys.argv[1]):
    cfg = reduce_config(get_config("dbrx-132b"), **over)
    key = jax.random.PRNGKey(3)
    params = moe.init_moe(key, cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(4), (t, cfg.d_model))
    with mesh:
        y, aux = jax.jit(lambda p, x: moe._moe_sharded(p, x, cfg, mesh))(
            params, x)
    yl, auxl = jax.jit(lambda p, x: moe._moe_local(p, x, cfg))(params, x)
    for k, v in params.items():
        out[f"{name} {k}"] = np.asarray(v)
    out[f"{name} x"] = np.asarray(x)
    out[f"{name} out"] = np.asarray(y)
    out[f"{name} aux"] = np.asarray(aux)
    out[f"{name} local"] = np.asarray(yl)
    out[f"{name} local_aux"] = np.asarray(auxl)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_moe(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_MOE,
                          json.dumps(MOE_CASES), str(path)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name,over,t", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_sharded_bodies_match_reference(reference_moe, name, over, t):
    """Each (data, model) coordinate's ``moe_shard_body`` on its rows and
    experts, the partials summed over ``model`` in ``moe_psum_dtype`` and
    the auxes averaged over ``data``, equal the reference's
    ``_moe_sharded``, dropping by the local capacity; where ``moe_plan``
    falls back, the reference's output is ``_moe_local``'s, which the
    port's ``_moe_local`` on every token gives."""
    cfg = reduce_config(get_config("dbrx-132b"), **over)
    ref = {k.split(" ", 1)[1]: v for k, v in reference_moe.items()
           if k.split(" ", 1)[0] == name}
    p = types.SimpleNamespace(**{k: torch.as_tensor(ref[k]) for k in
                                 ("router", "w_gate", "w_up", "w_down")})
    x = torch.as_tensor(ref["x"])
    plan = moe.moe_plan(cfg, t, 2, 2)
    if name.startswith("fallback"):
        assert plan is None
        np.testing.assert_array_equal(ref["out"], ref["local"])
        y, aux = moe._moe_local(p, x, cfg)
        _close_moe(y.numpy(), ref["out"], "float32")
        np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-6)
        return
    e_local, cap_local = plan
    assert (e_local, cap_local) == (2, moe._capacity(t // 2, cfg))
    rows, auxes, kept = [], [], 0
    for d in range(2):
        xd = x[d * t // 2:(d + 1) * t // 2]
        gates, ids, probs = moe.route_topk(xd @ p.router, cfg.top_k)
        auxes.append(moe._aux_loss(probs, ids, cfg.n_experts))
        parts = [moe.moe_shard_body(moe.local_experts(p, m, e_local), xd,
                                    gates, ids, cfg, m, e_local, cap_local)
                 for m in range(2)]
        rows.append((parts[0] + parts[1]).to(x.dtype))
        slot = moe._slot_in_expert(ids.reshape(-1), cfg.n_experts)
        kept += int((slot < cap_local).sum())
    assert kept < t * cfg.top_k          # the local capacity drops tokens
    _close_moe(torch.cat(rows).numpy(), ref["out"], cfg.moe_psum_dtype)
    np.testing.assert_allclose(float(sum(auxes) / 2), ref["aux"], rtol=1e-6)
    # the global capacity keeps other assignments: not the local path's
    assert np.abs(ref["out"] - ref["local"]).max() > 1e-3


def test_moe_sharded_on_a_world_of_one_is_the_local_moe():
    """``_moe_sharded`` on a 1 x 1 mesh holds every expert at the whole
    capacity: ``_moe_local``'s output, but for the combine's float32 sum
    (bit-equal here in float32); ``moe_block`` under a 1 x 1 policy is
    ``_moe_local`` itself."""
    cfg = reduce_config(get_config("dbrx-132b"))
    p = types.SimpleNamespace(**{
        k: torch.randn(s, generator=torch.Generator().manual_seed(i))
        for i, (k, s) in enumerate(
            (("router", (64, 4)), ("w_gate", (4, 64, 128)),
             ("w_up", (4, 64, 128)), ("w_down", (4, 128, 64))))})
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(9))
    mesh_lib.init_world("cpu")
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        y, aux = moe._moe_sharded(p, x, cfg, mesh)
        with api.use_mesh_policy(api.MeshPolicy(mesh, {})):
            yb, auxb = moe.moe_block(p, x, cfg)
    finally:
        mesh_lib.close_world()
    yl, auxl = moe._moe_local(p, x, cfg)
    assert torch.equal(yb, yl) and torch.equal(auxb, auxl)
    np.testing.assert_allclose(y.numpy(), yl.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(aux, auxl)


# ---------------------------------------------------------------------------
# Multi-process runs on gloo
# ---------------------------------------------------------------------------

# 3 steps in float32: sums in another order (per-rank partial sums, the
# gathered gradients summed over ranks) move values by float32 rounding;
# Adafactor divides by a root of the squared gradient, so an element whose
# gradient is near 0 can move its update by a share of the lr
PARAM_TOL = dict(atol=2e-6, rtol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
RUNS = [(arch, shape) for arch in TRAIN_ARCHS for shape in LM_SHAPES]
# and the rwkv6 variants whose channel mix keeps one width whole
MATCH_RUNS = RUNS + list(MIXED_RUNS.items())
SERVE_RUNS = [(arch, shape) for arch in (*LM_ARCHS, *SERVE_ARCHS)
              for shape in SERVE_SHAPES]
SERVED_ONLY = [(arch, shape) for arch in SERVE_ARCHS for shape in SERVE_SHAPES]
# serving logits in float32 against one process: row-parallel partial
# sums added over the ranks in another order than one product's
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    return d, run_world("lm_mesh", 4, d)


def _excess(got, want, tol) -> float:
    """The largest amount by which a leaf of ``got`` is off ``want``
    beyond ``tol`` (below 0: every element within it)."""
    return max(float((np.abs(g - want[k]) - tol["atol"]
                      - tol["rtol"] * np.abs(want[k])).max())
               for k, g in got.items())


def _same_run(got, want, param_tol, metric_tol):
    assert set(got["state"]) == set(want["state"])
    for k, w in want["state"].items():
        np.testing.assert_allclose(got["state"][k], w, err_msg=k,
                                   **param_tol)
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "aux_loss", "grad_norm", "lr", "perplexity"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **metric_tol)


def _oracle(res, arch, shape):
    """One process's run that ``arch`` on ``shape`` should equal: dbrx on
    2 x 2 averages each data rank's load-balancing loss (the reference's
    ``_moe_sharded``), everything else computes the whole batch's."""
    if arch == "dbrx-132b" and shape == (2, 2):
        return res[0]["dbrx-132b plain data-rank aux"]
    return res[0][f"{arch} plain"]


@pytest.mark.parametrize("arch,shape", MATCH_RUNS,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in MATCH_RUNS])
def test_mesh_training_matches_one_process(lm_world, arch, shape):
    """Three training steps on ``make_host_mesh(*shape)`` of 4 ranks (the
    trainer's; whisper's through ``launch.steps.make_train_step``): the
    whole parameters and optimizer state (gathered), loss, aux loss, grad
    norm and lr of every step equal one process's; every rank's metrics
    alike; the one process's parameters moved from their start by more
    than a hundred times the tolerance, so a state left as it was fails."""
    _, res = lm_world
    want = _oracle(res, arch, shape)
    got = res[0][f"{arch} {shape}"]
    _same_run(got, want, PARAM_TOL, METRIC_TOL)
    for r in res[1:]:
        assert r[f"{arch} {shape}"]["metrics"] == got["metrics"]
    params = {k: v for k, v in want["state"].items()
              if k.startswith("params/")}
    init = {k: want["init"][k] for k in params}
    moved = {k: float(np.abs(v - init[k]).max()) for k, v in params.items()}
    assert min(moved.values()) > 100 * PARAM_TOL["atol"], moved


def test_2x2_moe_differs_only_by_the_data_rank_aux(lm_world):
    """dbrx on 2 x 2 equals the one-process run whose load-balancing loss
    is the mean of each data rank's (test_mesh_training_matches_one_process)
    and not the run whose loss is the whole batch's: the parameters of the
    two one-process runs differ by more than the tolerance, and so does
    the mesh's from the second, so the comparison sees the data-rank mean."""
    _, res = lm_world
    got = res[0]["dbrx-132b (2, 2)"]["state"]
    rank_aux = res[0]["dbrx-132b plain data-rank aux"]["state"]
    whole_aux = res[0]["dbrx-132b plain"]["state"]
    assert _excess(got, rank_aux, PARAM_TOL) <= 0
    assert _excess(rank_aux, whole_aux, PARAM_TOL) > 10 * PARAM_TOL["atol"]
    assert _excess(got, whole_aux, PARAM_TOL) > 10 * PARAM_TOL["atol"]


def _share(spec, sizes, axes=("data", "model")) -> int:
    """How many blocks the axes ``axes`` of ``spec`` cut a leaf into."""
    n = 1
    for e in spec:
        for a in sharding.spec_axes(e):
            n *= sizes[a] if a in axes else 1
    return n


@pytest.mark.parametrize("arch,shape", RUNS, ids=[f"{a}-{s[0]}x{s[1]}"
                                                  for a, s in RUNS])
def test_each_rank_stores_its_blocks(lm_world, arch, shape):
    """Between steps a rank holds, for every leaf, its block and nothing
    whole: a leaf split over all 4 ranks is a quarter on every rank
    (parameters and moments); the tensors the model computes with are
    the parameter blocks themselves; and all a rank holds (blocks and
    optimizer state) is below the whole parameters.  No weight gathered
    at its use is alive after a training forward, nor after its backward.
    A training step's ``"lm_params"`` bytes are the leaves split over
    ``data`` gathered twice for each use (at the forward's product and
    again where the backward reads it; the embedding's lookup saves no
    weight, so one gather there); ``"lm_grads"`` are one reduce-scatter
    into each such block for each forward use, plus the all-reduce of
    every block that ``data`` does not split: no whole gradient of a
    split leaf crosses the mesh.  Served on the same shape, a rank's K/V
    cache is its rows and ``1/m`` of the heads where they divide, else
    ``1/m`` of the slots (qwen's 2 KV heads on 4 ranks)."""
    _, res = lm_world
    cfg = lm_cfg(arch)
    plain = res[0][f"{arch} plain"]
    whole_params = sum(v for k, v in plain["whole_bytes"].items()
                       if k.startswith("params/"))
    assert plain["held_bytes"] == sum(plain["whole_bytes"].values())
    sizes = {"data": shape[0], "model": shape[1]}
    for r in res:
        run = r[f"{arch} {shape}"]
        n_split = 0
        for k, spec in run["specs"].items():
            share = _share(spec, sizes)
            assert run["block_bytes"][k] * share == run["whole_bytes"][k], k
            n_split += share == 4
        assert n_split >= 8
        blocks = {k[len("params/"):]: v for k, v in run["block_bytes"].items()
                  if k.startswith("params/")}
        assert run["compute_bytes"] == sum(blocks.values())
        assert run["held_bytes"] == sum(run["block_bytes"].values())
        assert run["held_bytes"] < whole_params
        assert run["live_gathers"] == (0, 0)
        # the collectives of one training step
        want_params = want_grads = 0
        for k, b in blocks.items():
            spec = run["specs"][f"params/{k}"]
            n_data = _share(spec, sizes, ("data",))
            uses = (1 + (2 if cfg.tie_embeddings else 0)) if k == "embed" \
                else 2
            if k == "layers/wB" and shape[1] > 1:
                # RWKV6's decay product saves its own copy of the rank's
                # columns of wB, so the backward gathers nothing
                uses = 1
            fwd = 2 if k == "embed" and cfg.tie_embeddings else 1
            if n_data > 1:
                assert all(g == spec[-len(g):]
                           for g in run["gather_specs"][k]), k
                want_params += uses * b * n_data * cfg.microbatches
                want_grads += fwd * b * cfg.microbatches
            else:
                assert set(run["gather_specs"][k]) == {None}, k
                want_grads += b * (shape[0] > 1)
        got = run["step_bytes"]
        assert got.get("lm_params", 0) == want_params, (got, want_params)
        assert got.get("lm_grads", 0) == want_grads, (got, want_grads)
        assert (want_params > 0) == (shape[0] > 1)
    if shape not in SERVE_SHAPES:
        return
    # serving: each rank's K/V cache holds its rows and its KV/m heads
    # where the KV heads divide, else S/m slots (qwen's 2 on 4 ranks:
    # the cache split by sequence)
    n_data, m = shape
    kv = cfg.n_kv_heads if cfg.family != "encdec" else cfg.n_heads
    held = kv // m if kv % m == 0 else kv
    assert kv % m or arch != "qwen1.5-0.5b" or m != 4
    want = res[0][f"serve {arch} plain"]["cache_shapes"]
    for r in res:
        got = r[f"serve {arch} {shape}"]["cache_shapes"]
        for k in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            if k in want:
                w = want[k]
                slots = w[2] // m if kv % m else w[2]
                assert kv % m == 0 or w[2] % m == 0
                assert got[k] == (w[0], w[1] // n_data, slots, held,
                                  w[4]), (k, got[k], w)


def test_data_parallel_moe_is_the_local_moe_of_all_tokens(lm_world):
    """``_moe_data_parallel`` on the 4 x 1 mesh, each rank its 16 of 64
    tokens, with a capacity that drops assignments: the rows of its
    outputs, served and trained, and its aux are ``_moe_local``'s on all
    64 tokens, and the gradients of a loss over them (x's rows; the
    router's and experts', summed over the ranks) are that one process's."""
    _, res = lm_world
    cfg, p, x, c = moe_dp_inputs()
    ids = moe.route_topk(x @ p.router, cfg.top_k)[1].reshape(-1).long()
    kept = moe._slot_in_expert(ids, cfg.n_experts) < moe._capacity(64, cfg)
    assert 0 < int(kept.sum()) < ids.numel()        # the capacity drops
    with torch.no_grad():
        serve, serve_aux = moe._moe_local(p, x, cfg)
    xr = x.clone().requires_grad_(True)
    y, aux = moe._moe_local(p, xr, cfg, train=True)
    grads = moe_dp_grads(y, aux, c, p, xr)
    ranks = [r["moe data parallel"] for r in res]
    for key, want in (("serve", serve), ("y", y.detach())):
        _close_moe(torch.cat([r[key] for r in ranks]).numpy(), want.numpy(),
                   "float32")
    for r in ranks:
        np.testing.assert_allclose(float(r["serve_aux"]), float(serve_aux),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(r["aux"]), float(aux.detach()),
                                   rtol=1e-6)
    _close_moe(torch.cat([r["grads"][0] for r in ranks]).numpy(),
               grads[0].numpy(), "float32")
    for j in range(1, 5):
        _close_moe(sum(r["grads"][j] for r in ranks).numpy(),
                   grads[j].numpy(), "float32")


def test_checkpoint_from_2x2_restores_in_a_world_of_one(lm_world):
    """qwen's step-2 checkpoint, written by rank 0 of the 2 x 2 mesh
    whole, restores into a ``Trainer`` on a 1 x 1 mesh in a world of one
    (each leaf its block of the new mesh) and its third step equals the
    straight run's."""
    d, res = lm_world
    ckpt = str(d / "ckpt22")
    assert checkpoint.latest_step(ckpt) == 2
    cfg = lm_cfg("qwen1.5-0.5b")
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from torch_dist_worker import LM_BATCH, LM_SEQ

    mesh_lib.init_world("cpu")
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        tc = trainer_lib.TrainerConfig(ckpt_dir=ckpt, ckpt_every=10,
                                       **LM_TRAIN)
        tr = trainer_lib.Trainer(cfg, tc, mesh=mesh, device="cpu",
                                 log_fn=lambda *a: None)
        st = tr.init_or_restore(seed=0)
        assert int(st["step"]) == 2
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=LM_SEQ,
                                      global_batch=LM_BATCH), mesh=mesh,
                           device="cpu")
        st = tr.run(st, data)
        got = {k: checkpoint._to_numpy(v) for k, v in
               checkpoint._flatten(trainer_lib.tree(st)).items()}
    finally:
        mesh_lib.close_world()
    want = res[0]["qwen1.5-0.5b plain"]["state"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **PARAM_TOL)


def test_moe_serving_steps_under_a_2x2_policy(lm_world):
    """Reduced dbrx's prefill and greedy decode steps under a 2 x 2 policy
    (serving blocks: experts, heads, ff and vocab over ``model``,
    replicated over ``data``; each data rank its two prompts;
    ``_moe_sharded`` with B4b and B4a's plain versions): each data row's
    logits, concatenated, equal the unsharded steps'; the model ranks
    alike; the collectives counted: no parameter gathered, the row-parallel
    sums, the experts' combine and the logits' gather over ``model``."""
    _, res = lm_world
    by = {r["coord(2, 2)"]: r["serve dbrx-132b (2, 2)"]["logits"]
          for r in res}
    for d in range(2):
        assert torch.equal(by[(d, 0)], by[(d, 1)])
    got = torch.cat([by[(0, 0)], by[(1, 0)]], dim=1)
    np.testing.assert_allclose(
        got.numpy(), res[0]["serve dbrx-132b plain"]["logits"].numpy(),
        rtol=1e-5, atol=1e-5)
    seen = res[0]["serve bytes dbrx-132b (2, 2)"]
    assert seen["moe_combine"] > 0 and seen["tp_sum"] > 0
    assert seen["lm_logits"] > 0
    assert "lm_grads" not in seen and "lm_params" not in seen


@pytest.mark.parametrize("arch,shape", SERVE_RUNS,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in SERVE_RUNS])
def test_mesh_serving_matches_one_process(lm_world, arch, shape):
    """A prefill and greedy decode steps under a policy on
    ``make_host_mesh(*shape)``: every data rank's rows of the whole logits
    (its vocab slices gathered over ``model``), concatenated, within
    ``SERVE_TOL`` of one process's, the model ranks bit-equal, and the
    greedy tokens equal (each rank's cache: test_each_rank_stores_its_blocks)."""
    _, res = lm_world
    cfg = lm_cfg(arch)
    plain = res[0][f"serve {arch} plain"]
    by = {r[f"coord{shape}"]: r[f"serve {arch} {shape}"] for r in res}
    n_data, m = shape
    for d in range(n_data):
        for j in range(1, m):
            assert torch.equal(by[(d, 0)]["logits"], by[(d, j)]["logits"])
    logits = torch.cat([by[(d, 0)]["logits"] for d in range(n_data)], 1)
    tokens = torch.cat([by[(d, 0)]["tokens"] for d in range(n_data)], 1)
    np.testing.assert_allclose(logits.numpy(), plain["logits"].numpy(),
                               **SERVE_TOL)
    assert torch.equal(tokens, plain["tokens"])


def test_batch_that_does_not_split_matches_one_process(lm_world):
    """Reduced qwen on 4 x 1 with 6 rows, which do not split over a data
    axis of 4: ``batch_spec`` falls back to no split, every rank holds all
    6 rows, and the loss divides its share among the 4 copies, so the
    gradients summed over ``data`` are one process's: the state and every
    step's metrics equal the one-process run of 6 rows, whose parameters
    moved far past the tolerance."""
    _, res = lm_world
    want = res[0]["qwen replicated rows plain"]
    _same_run(res[0]["qwen replicated rows"], want, PARAM_TOL, METRIC_TOL)
    params = {k: v for k, v in want["state"].items()
              if k.startswith("params/")}
    moved = min(float(np.abs(v - want["init"][k]).max())
                for k, v in params.items())
    assert moved > 100 * PARAM_TOL["atol"]


SEQ_RUNS = [(arch, shape) for arch in SEQ_ARCHS for shape in SEQ_SHAPES]
SEQ_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in SEQ_RUNS]


def _seq_bytes(step_bytes: dict) -> dict:
    return {k: v for k, v in step_bytes.items() if k.startswith("sp_")}


@pytest.mark.parametrize("arch,shape", SEQ_RUNS, ids=SEQ_IDS)
def test_seq_parallel_training_matches_one_process(lm_world, arch, shape):
    """Three training steps with the residual stream split by sequence
    over ``model`` (dbrx's under remat as well; the qwen whose attention
    and MLP a model axis of 4 does not split, every rank computing them
    whole) on ``make_host_mesh(*shape)``: the whole state and every
    step's metrics equal one
    process's and the same mesh's with the flag off, within the Megatron
    runs' tolerances; every rank's metrics alike; and the bytes the first
    step's sequence-split collectives brought each rank (its
    microbatches' forwards, recomputes and backwards) are the specs'
    (``sharding.seq_split_bytes``)."""
    _, res = lm_world
    got = res[0][f"{arch} {shape} seq"]
    _same_run(got, _oracle(res, arch, shape), PARAM_TOL, METRIC_TOL)
    _same_run(got, res[0][f"{arch} {shape}"], PARAM_TOL, METRIC_TOL)
    cfg = lm_cfg(arch, seq=True)
    n_data, m = shape
    mb = cfg.microbatches
    want = {k: mb * v for k, v in sharding.seq_split_bytes(
        cfg, m, LM_BATCH // n_data // mb, LM_SEQ, train=True).items()}
    assert set(want) == {"sp_gather", "sp_scatter", "sp_norms"}
    for r in res:
        assert r[f"{arch} {shape} seq"]["metrics"] == got["metrics"]
        assert _seq_bytes(r[f"{arch} {shape} seq"]["step_bytes"]) == want
        assert not _seq_bytes(r[f"{arch} {shape}"]["step_bytes"])


@pytest.mark.parametrize("arch,shape", SEQ_RUNS, ids=SEQ_IDS)
def test_seq_parallel_prefill_matches_the_flag_off(lm_world, arch, shape):
    """Prefills with the residual stream split by sequence against the
    same mesh's with the flag off, at a length that ``model`` divides and
    at one that it does not (the split's padding; right-padded rows
    through ``lengths``): on every rank the whole logits and the caches
    (K/V from each layer's gathered input) within ``SERVE_TOL``,
    ``kv_pos`` and ``pos`` equal, and the sequence split's bytes the
    specs'."""
    _, res = lm_world
    cfg = lm_cfg(arch, seq=True)
    n_data, m = shape
    assert any(n % m for n in SEQ_PROMPTS)
    for r in res:
        for n in SEQ_PROMPTS:
            on = r[f"prefill {arch} {shape} seq=True"][n]
            off = r[f"prefill {arch} {shape} seq=False"][n]
            np.testing.assert_allclose(on["logits"].numpy(),
                                       off["logits"].numpy(), **SERVE_TOL)
            assert set(on["cache"]) == set(off["cache"])
            for k, x in off["cache"].items():
                if x.is_floating_point():
                    np.testing.assert_allclose(on["cache"][k].numpy(),
                                               x.numpy(), err_msg=k,
                                               **SERVE_TOL)
                else:
                    assert torch.equal(on["cache"][k], x), k
            assert _seq_bytes(on["bytes"]) == sharding.seq_split_bytes(
                cfg, m, 4 // n_data, n, train=False)
            assert not _seq_bytes(off["bytes"])


def _paths(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_mesh_cli_on_two_ranks(tmp_path):
    """``launch/train.py --arch qwen1.5-0.5b --reduced --data-parallel 2``
    in a world of two equals the CLI without a mesh; rank 0 alone logs
    and writes the checkpoint, which holds the gathered parameters;
    ``--production-mesh`` raises as the reference's ``jax.make_mesh``
    does; ``--arch recurrentgemma-2b --reduced --model-parallel 2``
    trains on the mesh and equals its CLI without one."""
    res = run_world("lm_cli", 2, tmp_path)
    r0, r1 = res
    assert "data=1, model=2" in r0["rg_mesh"]
    rg, rg1 = _paths(r0["rg_params"]), _paths(r1["rg_params"])
    assert set(rg) == set(rg1) == set(r0["rg_plain"])
    for k, w in r0["rg_plain"].items():
        np.testing.assert_allclose(rg[k], w, err_msg=k, **PARAM_TOL)
        np.testing.assert_array_equal(rg[k], rg1[k])
    assert "data=2, model=1" in r0["mesh"]
    assert any("done at step 2" in line for line in r0["logs"])
    assert r1["logs"] == []
    for r in res:
        assert r["production"] == ("Number of devices 2 must be >= the "
                                   "product of mesh_shape (16, 16)")
    flat, flat1 = _paths(r0["params"]), _paths(r1["params"])
    assert set(flat) == set(flat1) == set(r0["plain"])
    for k, w in r0["plain"].items():
        np.testing.assert_allclose(flat[k], w, err_msg=k, **PARAM_TOL)
        np.testing.assert_array_equal(flat[k], flat1[k])
    saved = np.load(tmp_path / "cli_ckpt" / "step_00000002" / "shard_0.npz")
    manifest = json.loads((tmp_path / "cli_ckpt" / "step_00000002" /
                           "manifest.json").read_text())
    for k, w in flat.items():
        meta = manifest["leaves"][f"params/{k}"]
        np.testing.assert_array_equal(saved[meta["name"]], w)
    assert not (tmp_path / "cli_ckpt" / "step_00000002" /
                "shard_1.npz").exists()


def serve_bytes(cfg, m, rows, n_prompt, decodes) -> dict:
    """``sharding.serve_step_bytes`` summed over a prefill of ``rows`` x
    ``n_prompt`` tokens and ``decodes`` decode steps of the serving runs
    (``torch_dist_worker._serve``)."""
    max_len = SERVE_PROMPTS.get(cfg.name, (8, 16))[1]
    cache_len = (min(cfg.window, max_len) if cfg.family == "hybrid"
                 else max_len)
    got = {}
    for decode in [False] + [True] * decodes:
        for k, v in sharding.serve_step_bytes(cfg, m, rows, n_prompt,
                                              cache_len, decode).items():
            got[k] = got.get(k, 0) + v
    return got


@pytest.mark.parametrize("arch,shape", SERVED_ONLY,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in SERVED_ONLY])
def test_served_caches_and_bytes_follow_the_specs(lm_world, arch, shape):
    """Reduced rwkv6-7b, recurrentgemma-2b and granite-34b served on
    ``make_host_mesh(*shape)`` (test_mesh_serving_matches_one_process
    holds their logits and tokens): each rank's cache is its rows and,
    over ``model``, RWKV6's ``S`` its ``H/m`` heads, the RG-LRU's ``h``
    and ``conv`` its ``rnn/m`` channels, the K/V of one KV head (the ring
    and granite's cache) its ``S/m`` slots, ``kv_pos``, ``tm_prev`` and
    ``cm_prev`` whole; and the bytes each reader's collectives brought a
    rank are the specs' count (``sharding.serve_step_bytes``)."""
    _, res = lm_world
    cfg = lm_cfg(arch)
    n_data, m = shape
    want = res[0][f"serve {arch} plain"]["cache_shapes"]
    div = {"S": (2, m), "h": (1, m), "conv": (2, m), "k": (-3, m),
           "v": (-3, m)}
    n_prompt = SERVE_PROMPTS.get(arch, (8, 16))[0]
    for r in res:
        got = r[f"serve {arch} {shape}"]["cache_shapes"]
        assert set(got) == set(want)
        for key, w in want.items():
            name = key.rsplit("/", 1)[-1]
            shape_want = list(w)
            if name != "pos" or len(w) == 1:
                batch = 0 if cfg.family == "hybrid" or name == "kv_pos" \
                    else (1 if len(w) > 1 else 0)
                shape_want[batch] //= n_data
            if name in div:
                dim, k = div[name]
                shape_want[dim] //= k
            assert got[key] == tuple(shape_want), (key, got[key], w)
        assert r[f"serve bytes {arch} {shape}"] == serve_bytes(
            cfg, m, 4 // n_data, n_prompt, SERVE_DECODES), r[
                f"serve bytes {arch} {shape}"]


def test_recurrent_training_is_refused_on_a_mesh():
    """(Named for the refusal this test once held.)  ``ShardedLM`` trains
    the recurrent families on a mesh by ``sharding.block_spec``: on every
    coordinate of 1 x 2 and 2 x 2, every stacked leaf's spec keeps its
    layer axis whole; RWKV6's ``wk``/``wv`` are column-parallel and
    ``wo`` row-parallel over ``model``, with ``data`` on the other dim
    (where the reference's 3-D rules would split ``wo``'s layer axis);
    every other leaf keeps ``param_spec``; and the blocks put together as
    ``sharded_params_to_numpy`` gathers them are the tree, in the
    reference's layout, they were cut from, bit for bit."""
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = lm_cfg(arch)
        tree = {}
        for path, leaf in io.reference_groups(model_lib.init_params(
                cfg, seed=3, device="cpu"), cfg).items():
            node = tree
            *head, name = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[name] = (leaf if isinstance(leaf, torch.Tensor)
                          else torch.stack(list(leaf))).detach().numpy()
        for sizes in ({"data": 1, "model": 2}, {"data": 2, "model": 2}):
            coords = [sharding.Coord(sizes, dict(zip(sizes, c)))
                      for c in np.ndindex(*sizes.values())]
            sps = [io.sharded_params_from_numpy(tree, cfg, coord, train=True,
                                                device="cpu")
                   for coord in coords]
            for path, spec in sps[0].specs.items():
                assert all(sp.specs[path] == spec for sp in sps)
                stacked = not isinstance(sps[0].leaves[path], torch.Tensor)
                assert not stacked or spec[0] is None, (path, spec)
                want = sharding.param_spec(path, sps[0].shapes[path],
                                           coords[0], train=True)
                name = path.split("/")[-1]
                if cfg.family == "ssm" and name in ("wk", "wv", "wo"):
                    data = "data" if sizes["data"] > 1 else None
                    mine = ((data, "model") if name != "wo"
                            else ("model", data))
                    assert spec == (None,) + mine, (path, spec)
                    # the reference's: wo's layer axis over model, wk's
                    # and wv's over data
                    assert want[0] == ("model" if name == "wo"
                                       else data), (path, want)
                else:
                    assert spec == want, (path, spec, want)
            # every coordinate's blocks put together by their specs, as
            # sharded_params_to_numpy's gathers put them: the reference's
            got = _paths(_gathered(sps, coords))
            assert got.keys() == _paths(tree).keys()
            for k, w in _paths(tree).items():
                np.testing.assert_array_equal(got[k], w, err_msg=k)


def _gathered(sps, coords) -> dict:
    """Every coordinate's ``ShardedLM`` (``sps``, at ``coords``) put
    together into the whole tree by the blocks' specs."""
    out = {}
    for path, spec in sps[0].specs.items():
        stacked = not isinstance(sps[0].leaves[path], torch.Tensor)
        members = lambda sp: sp.leaves[path] if stacked else [sp.leaves[path]]
        mspec = spec[1:] if stacked else spec
        layers = []
        for i in range(len(members(sps[0]))):
            full = torch.empty(sps[0].shapes[path][int(stacked):])
            for coord, sp in zip(coords, sps):
                idx = []
                for dim, e in enumerate(mspec):
                    j, k = sharding.block_index(coord, sharding.spec_axes(e))
                    per = full.shape[dim] // k
                    idx.append(slice(j * per, (j + 1) * per))
                full[tuple(idx)] = members(sp)[i].detach()
            layers.append(full)
        node = out
        *head, name = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[name] = (torch.stack(layers) if stacked else layers[0]).numpy()
    return out


def test_recurrent_checkpoint_from_2x2_restores_in_a_world_of_one(lm_world):
    """recurrentgemma's step-2 checkpoint (Adafactor, remat), written
    whole by rank 0 of the 2 x 2 mesh, restores into a ``Trainer`` on a
    1 x 1 mesh in a world of one and into the meshless ``Trainer``; each
    third step equals the straight one-process run's."""
    d, res = lm_world
    arch = "recurrentgemma-2b"
    ckpt = str(d / CKPT22[arch])
    assert checkpoint.latest_step(ckpt) == 2
    cfg = lm_cfg(arch)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    want = res[0][f"{arch} plain"]["state"]
    mesh_lib.init_world("cpu")
    try:
        for mesh in (mesh_lib.make_host_mesh(1, 1), None):
            tc = trainer_lib.TrainerConfig(ckpt_dir=ckpt, ckpt_every=10,
                                           **LM_TRAIN)
            tr = trainer_lib.Trainer(cfg, tc, mesh=mesh, device="cpu",
                                     log_fn=lambda *a: None)
            st = tr.init_or_restore(seed=0)
            assert int(st["step"]) == 2
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=LM_SEQ,
                                          global_batch=LM_BATCH), mesh=mesh,
                               device="cpu")
            tc = trainer_lib.TrainerConfig(**LM_TRAIN)
            tr.cfg = tc                   # no save after the third step
            st = tr.run(st, data)
            got = {k: checkpoint._to_numpy(v) for k, v in
                   checkpoint._flatten(trainer_lib.tree(st)).items()}
            assert set(got) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, err_msg=k,
                                           **PARAM_TOL)
    finally:
        mesh_lib.close_world()


RESHARDS = [(a, s) for a in RESHARD_ARCHS for s in RESHARD_SHAPES]


@pytest.mark.parametrize("arch,shape", RESHARDS,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in RESHARDS])
def test_reshard_state_equals_a_restore_on_the_new_mesh(lm_world, arch,
                                                        shape):
    """``reshard_state`` of a 2 x 2 state after ``LM_STEPS`` steps onto
    ``shape`` (the same world of 4): on every rank, every parameter
    block, moment and the step are bit-equal to the state saved on 2 x 2
    and restored onto that mesh, with the same specs, and a leaf split
    over all 4 ranks there is a quarter of the whole."""
    _, res = lm_world
    sizes = {"data": shape[0], "model": shape[1]}
    n_quarter = 0
    for r in res:
        run = r[f"reshard {arch}"][shape]
        assert run["step"] == LM_STEPS
        assert run["specs"] == run["restored_specs"]
        assert run["moved"].keys() == run["restored"].keys()
        for k, w in run["restored"].items():
            np.testing.assert_array_equal(run["moved"][k], w, err_msg=k)
        whole = res[0][f"{arch} (2, 2)"]["state"]
        for k, spec in run["specs"].items():
            if _share(spec, sizes) == 4:
                n_quarter += 1
                assert run["moved"][k].size * 4 == whole[k].size, k
    assert n_quarter >= 8


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_best_mesh_after_failure_is_the_references(n_devices, monkeypatch):
    """``best_mesh_after_failure`` over ``n_devices`` (the world's size)
    for every ``model_parallel`` in (1, 2, 4), with and without the pod
    axis: the reference's mesh shape and axes (its ``jax.devices`` and
    ``make_mesh_compat`` stood in for), or the reference's error where no
    ``model`` group fits; a count other than the world's raises."""
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as ft

    monkeypatch.setattr(mesh_lib.dist, "get_world_size",
                        lambda *a: n_devices)
    monkeypatch.setattr(ft.dist, "get_world_size", lambda *a: n_devices)
    monkeypatch.setattr(mesh_lib, "_grid", lambda shape, names: (shape,
                                                                 names))
    monkeypatch.setattr(jmesh.jax, "devices", lambda *a: [None] * n_devices)
    monkeypatch.setattr(jmesh, "make_mesh_compat", lambda shape, axes: (
        tuple(shape), tuple(axes)))
    for mp in (1, 2, 4):
        for pod in (False, True):
            try:
                want = jft.best_mesh_after_failure(n_devices, mp, pod)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    ft.best_mesh_after_failure(n_devices, mp, pod)
                assert str(got.value) == str(e)
                assert n_devices < mp
                continue
            assert ft.best_mesh_after_failure(n_devices, mp, pod) == want
            with pytest.raises(ValueError, match="world"):
                ft.best_mesh_after_failure(2 * n_devices, mp, pod)
