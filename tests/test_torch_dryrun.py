"""The port's tooling on the CPU against the JAX reference: the spec
functions of ``launch/steps.py``, the step cost counter
(``launch/cost_analysis.py``) and the dry run (``launch/dryrun.py``).

* Every (arch x shape) cell on both production meshes: the leaves of
  ``input_specs`` against the reference's ``input_specs`` on an abstract
  mesh of the same shape: whole shapes, dtypes and specs, and each
  rank's block cut by its spec.  Named departures: RWKV6's ``wk``, ``wv``
  and ``wo`` (and AdamW's moments of them) split by head (ROADMAP queue
  C); the serving caches' K/V split by KV head where the heads divide
  ``model`` (the reference splits the sequence) and RWKV6's
  ``tm_prev``/``cm_prev`` whole over ``model``
  (``sharding.serve_cache_spec``).
* Reduced qwen1.5-0.5b and dbrx-132b, the prefill, decode and training
  steps on one rank on the CPU: the counter's ``flops`` against the
  reference's ``hlo_analysis`` of the compiled step (``attn_impl="xla"``),
  equal to 1e-9 of the reference's count, but for the prefill's
  attention: the reference's blockwise attention computes whole
  (query, key) blocks that hold any unmasked pair, the flash-attention
  kernel's formula only the pairs the mask keeps, and that share is
  taken apart exactly.
* The same steps, and rwkv6-7b's and recurrentgemma-2b's (B5, B6), run
  on the meta device count exactly what the CPU run counts: every total,
  the kernels by their formulas, the peak of live bytes; no kernel's
  ``LAUNCHES`` moves.
* ``python -m repro_torch.launch.dryrun`` in subprocesses: qwen1.5-0.5b
  ``decode_32k`` on both meshes (the reference's
  ``test_dryrun_tiny_cell_both_meshes``) and the full-width ``train_4k``
  cell on 16 x 16, which runs the backward under the mesh on meta
  tensors; each record's keys, and ``argument_bytes`` against the specs'
  arithmetic (and, for training, ``scripts/torch_mesh_bytes.rank_bytes``).
  The dry run refuses to start in a process that runs another world.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.configs import supported_shapes as jax_supported_shapes
from repro.launch import hlo_analysis, steps as jsteps
from repro.models import layers as jlayers, model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 reduce_config, supported_shapes)
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.launch import cost_analysis, steps
from repro_torch.models import io, model as model_lib
from repro_torch.train import optimizer as opt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_mesh_bytes  # noqa: E402


class FakeMesh:
    """``tests/test_sharding_rules.py``'s duck-typed mesh (.shape only)."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
KV_NAMES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v")


def _names(path) -> list:
    return [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]


def _spec(x) -> tuple:
    """A reference leaf's spec as a tuple with one entry per dim."""
    spec = tuple(x.sharding.spec)
    return spec + (None,) * (len(x.shape) - len(spec))


def _torch_dtype(x):
    return getattr(torch, str(x.dtype))


def _rwkv_by_head(cfg, path: str) -> bool:
    """RWKV6's time-mix ``wk``/``wv``/``wo`` (and their moments), which
    the port splits by head (``sharding.block_spec``)."""
    names = path.split("/")
    return cfg.family == "ssm" and "layers" in names and \
        names[-1] in ("wk", "wv", "wo")


def _heads_first(spec: tuple, shape: tuple, mesh) -> tuple:
    """The reference's K/V cache spec with ``model`` on the KV heads where
    they divide it (the port's layout) instead of on the sequence."""
    m = sharding.mesh_shape(mesh)["model"]
    out = list(spec)
    if shape[-2] % m == 0 and out[-3] == "model":
        out[-3], out[-2] = None, "model"
    return tuple(out)


def _check_block(t: torch.Tensor, shape, spec, mesh, what):
    assert tuple(t.shape) == sharding.local_shape(shape, spec, mesh), what


def _check_params(cfg, sp, ref_params, mesh, train):
    assert isinstance(sp, io.ShardedLM)
    seen = set()
    for path, x in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        key = "/".join(_names(path))
        seen.add(key)
        shape, spec = tuple(x.shape), sp.specs[key]
        assert tuple(sp.shapes[key]) == shape, key
        if _rwkv_by_head(cfg, key):
            fsdp = sharding.spec_entry(sharding.fsdp_axes_for(mesh, train))
            want = ((None, fsdp or None, "model") if key.endswith(("wk", "wv"))
                    else (None, "model", fsdp or None))
            assert spec == want, (key, spec)
        else:
            assert spec == _spec(x), (key, spec, _spec(x))
        leaf = sp.leaves[key]
        blocks = [leaf] if isinstance(leaf, torch.Tensor) else list(leaf)
        for b in blocks:
            assert b.device.type == "meta" and b.dtype == _torch_dtype(x), key
            if isinstance(leaf, torch.Tensor):
                _check_block(b, shape, spec, mesh, key)
            else:
                _check_block(b, shape[1:], spec[1:], mesh, key)
    assert seen == set(sp.specs)


def _check_opt(cfg, opt, ref_opt, mesh):
    state, specs = opt.state(), opt.state_specs()
    seen = set()
    for path, x in jax.tree_util.tree_flatten_with_path(ref_opt)[0]:
        key = "/".join(_names(path))
        seen.add(key)
        leaf = "/".join(n for n in key.split("/")
                        if n not in ("m", "v", "vr", "vc"))
        if _rwkv_by_head(cfg, leaf) and key.split("/")[-1] not in ("vr", "vc"):
            assert specs[key] == opt.layout.specs[leaf], key
        else:
            assert specs[key] == _spec(x), (key, specs[key], _spec(x))
        _check_block(state[key], tuple(x.shape), specs[key], mesh, key)
        assert state[key].dtype == _torch_dtype(x), key
    assert seen == set(state)


def _check_tensor(t, x, mesh, what, want_spec=None):
    assert t.device.type == "meta" and t.dtype == _torch_dtype(x), what
    assert t.global_shape == tuple(x.shape), what
    assert t.spec == (_spec(x) if want_spec is None else want_spec), \
        (what, t.spec, _spec(x))
    _check_block(t, tuple(x.shape), t.spec, mesh, what)


def _port_cache_leaf(cfg, cache, names):
    """The port's cache tensor of the reference's cache path ``names``,
    and whether the reference stacks it over layers the port keeps apart
    (RecurrentGemma)."""
    if cfg.family != "hybrid" or names[0] == "pos":
        node = cache
        for n in names:
            node = node[n]
        return [node], False
    n_super = cfg.n_layers // 3
    if names[0] == "super":
        first = ("rec1", "rec2", "attn").index(names[1])
        idx = [3 * i + first for i in range(n_super)]
    else:
        idx = [3 * n_super + j for j in range(cfg.n_layers - 3 * n_super)]
    return [cache["layers"][i][names[-1]] for i in idx], True


def _check_cache(cfg, cache, ref_cache, mesh):
    for path, x in jax.tree_util.tree_flatten_with_path(ref_cache)[0]:
        names = _names(path)
        tensors, stacked = _port_cache_leaf(cfg, cache, names)
        shape, spec = tuple(x.shape), _spec(x)
        if stacked:
            assert len(tensors) == shape[0], names
            shape, spec = shape[1:], spec[1:]
        name = names[-1]
        if name in KV_NAMES:           # by KV head where they divide
            spec = _heads_first(spec, shape, mesh)
        elif name in ("tm_prev", "cm_prev"):     # whole over model
            spec = tuple(None if e == "model" else e for e in spec)
        for t in tensors:
            assert t.device.type == "meta" and t.dtype == _torch_dtype(x)
            assert t.global_shape == shape, names
            assert t.spec == spec, (names, t.spec, spec)
            _check_block(t, shape, spec, mesh, names)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(list_archs()))
def test_input_specs_match_reference(arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    amesh = AbstractMesh(tuple(MESHES[mesh_name].values()),
                         tuple(MESHES[mesh_name]))
    cfg = get_config(arch)
    assert supported_shapes(cfg) == jax_supported_shapes(jax_get_config(arch))
    for shape_name in supported_shapes(cfg):
        ref = jsteps.input_specs(jax_get_config(arch), shape_name, amesh)
        got = steps.input_specs(cfg, shape_name, mesh)
        kind = SHAPES[shape_name].kind
        if kind == "train":
            (state, batch), (rstate, rbatch) = got, ref
            _check_params(cfg, state["params"], rstate["params"], mesh, True)
            _check_opt(cfg, state["opt"], rstate["opt"], mesh)
            assert state["step"] is state["opt"].step
            assert state["step"].shape == () and \
                state["step"].dtype == torch.int32
            assert set(batch) == set(rbatch)
            for k in batch:
                _check_tensor(batch[k], rbatch[k], mesh, k)
            continue
        _check_params(cfg, got[0], ref[0], mesh, False)
        if kind == "prefill":
            if cfg.family == "encdec":
                _check_tensor(got[1]["frames"], ref[1]["frames"], mesh,
                              "frames")
            else:
                _check_tensor(got[1], ref[1], mesh, "tokens")
        else:
            _check_cache(cfg, got[1], ref[1], mesh)
            _check_tensor(got[2], ref[2], mesh, "token")


# ---------------------------------------------------------------------------
# The counter against the reference's hlo_analysis, and meta against CPU
# ---------------------------------------------------------------------------

B, S = 2, 64
COUNTED = {"qwen1.5-0.5b": {}, "dbrx-132b": {}, "rwkv6-7b": {},
           "recurrentgemma-2b": {"n_layers": 5, "window": 16}}
LAUNCH_COUNTERS = ((flash_ops, "LAUNCHES"), (decode_ops, "LAUNCHES"),
                   (moe_ops, "GEMM_LAUNCHES"), (moe_ops, "SWIGLU_LAUNCHES"),
                   (wkv_ops, "LAUNCHES"), (lru_ops, "LAUNCHES"))


def _port_step(cfg, kind, device):
    """(step, args) of the reduced ``cfg`` on one rank: random weights on
    the CPU, the empty model on the meta device."""
    params = (model_lib.init_params(cfg, seed=0, device="cpu")
              if device == "cpu" else io.empty_model(cfg, "meta"))
    tokens = torch.randint(2, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32).to(device)
    if kind == "prefill":
        return steps.make_prefill_step(cfg, S), (params, tokens)
    if kind == "decode":
        cache = model_lib.init_cache(cfg, B, S, device=device)
        return steps.make_decode_step(cfg), (params, cache, tokens[:, 0])
    state = steps.train_state(cfg, params, opt_lib.make_optimizer(cfg.optimizer))
    return steps.make_train_step(cfg), (state, {"tokens": tokens})


def _count(cfg, kind, device):
    step, args = _port_step(cfg, kind, device)
    with cost_analysis.CostCounter(steps.arg_tensors(args)) as counter:
        step(*args)
    return counter


def _reference_flops(arch, kind) -> float:
    cfg = jax_reduce_config(jax_get_config(arch))
    params = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                       cfg))
    tokens = jax.ShapeDtypeStruct((B, S), jax.numpy.int32)
    if kind == "prefill":
        fn, args = jsteps.make_prefill_step(cfg, S), (params, tokens)
    elif kind == "decode":
        cache = jax.eval_shape(lambda: jmodel.init_cache(cfg, B, S))
        fn, args = jsteps.make_decode_step(cfg), (
            params, cache, jax.ShapeDtypeStruct((B,), jax.numpy.int32))
    else:
        opt = jopt.make_optimizer(cfg.optimizer)
        state = {"params": params, "opt": jax.eval_shape(opt.init, params),
                 "step": jax.ShapeDtypeStruct((), jax.numpy.int32)}
        fn, args = jsteps.make_train_step(cfg, opt), (state,
                                                      {"tokens": tokens})
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze(text).flops


def _attention_excess(cfg) -> float:
    """The reference prefill's attention products over whole blocks less
    the pairs the causal mask keeps, all layers."""
    bq, bkv = min(cfg.attn_block_q, S), min(cfg.attn_block_kv, S)
    blocks = len(jlayers._block_pairs(S // bq, S // bkv, bq, bkv, True,
                                      cfg.window, 0))
    pairs = cost_analysis.visible_pairs(S, S, True, cfg.window)
    return (cfg.n_layers * 4 * B * cfg.n_heads * cfg.d_head
            * (blocks * bq * bkv - pairs))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", list(COUNTED))
def test_counter_against_hlo_analysis_and_the_meta_run(arch, kind):
    cfg = reduce_config(get_config(arch), **COUNTED[arch])
    before = [getattr(m, n) for m, n in LAUNCH_COUNTERS]
    cpu = _count(cfg, kind, "cpu")
    meta = _count(cfg, kind, "meta")
    assert [getattr(m, n) for m, n in LAUNCH_COUNTERS] == before
    assert meta.totals.as_dict() == cpu.totals.as_dict()
    assert (meta.peak_bytes, meta.live_bytes, meta.argument_bytes) == \
        (cpu.peak_bytes, cpu.live_bytes, cpu.argument_bytes)
    kernels = cpu.totals.kernels
    want = {"prefill": {"qwen1.5-0.5b": {"flash_attn": 2},
                        "dbrx-132b": {"flash_attn": 2,
                                      "moe_gemm.grouped_swiglu": 2,
                                      "moe_gemm.grouped_gemm": 2},
                        "rwkv6-7b": {"rwkv6_scan": 2},
                        "recurrentgemma-2b": {"rglru_scan": 4}},
            "decode": {"qwen1.5-0.5b": {"decode_attn": 2},
                       "dbrx-132b": {"decode_attn": 2,
                                     "moe_gemm.grouped_swiglu": 2,
                                     "moe_gemm.grouped_gemm": 2},
                       "rwkv6-7b": {}, "recurrentgemma-2b": {"decode_attn": 1}},
            "train": {}}
    assert kernels == want[kind].get(arch, {}), kernels
    assert cpu.totals.unknown_customcalls == []
    if arch not in ("qwen1.5-0.5b", "dbrx-132b"):
        return
    ref = _reference_flops(arch, kind)
    if kind == "prefill":
        ref -= _attention_excess(cfg)
    assert abs(cpu.totals.flops - ref) <= 1e-9 * ref, (cpu.totals.flops, ref)


def test_a_kernel_is_counted_by_its_formula():
    """B2's work on a causal 4-query prompt: 10 pairs a head; B3's over
    every slot of the cache."""
    q = torch.empty((1, 2, 4, 16), device="meta")
    with cost_analysis.CostCounter() as counter:
        out = flash_ops.flash_attn(q, q[:, :1], q[:, :1])
    assert out.shape == q.shape and out.stride() == (128, 16, 32, 1)
    assert counter.totals.flops == 4 * 16 * 2 * 10
    assert counter.totals.transcendentals == 2 * 10
    assert counter.totals.memory_bytes == 2 * (q.numel() + q.numel() // 2) * 4
    lengths = torch.empty((1,), dtype=torch.int32, device="meta")
    with cost_analysis.CostCounter() as counter:
        decode_ops.decode_attn(torch.empty((1, 2, 16), device="meta"),
                               q[:, :1], q[:, :1], lengths)
    assert counter.totals.flops == 4 * 2 * 16 * 4
    assert counter.totals.kernels == {"decode_attn": 1}


# ---------------------------------------------------------------------------
# The dry run's command line
# ---------------------------------------------------------------------------

RECORD_KEYS = {"ok", "arch", "shape", "mesh", "n_devices", "overrides",
               "memory", "cost_analysis", "hlo_totals", "top_buffers",
               "collective_bytes_by_reader"}
REFUSED = """
import torch, sys
from repro_torch.launch import dryrun, mesh
mesh.init_world(device="cpu")
try:
    dryrun.run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=False, out_dir="")
except RuntimeError as e:
    print("refused:", e)
    sys.exit(0)
sys.exit(1)
"""


def _spec_bytes(arch, shape_name, mesh_name) -> int:
    args = steps.input_specs(get_config(arch), shape_name,
                             FakeMesh(MESHES[mesh_name]))
    return sum(t.numel() * t.element_size() for t in steps.arg_tensors(args))


def test_dryrun_cells_on_both_meshes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    runs = {
        ("decode_32k", "pod16x16"): [],
        ("decode_32k", "pod2x16x16"): ["--multi-pod"],
        ("train_4k", "pod16x16"): [],
    }
    procs = {key: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", key[0], *flags, "--out", str(tmp_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for key, flags in runs.items()}
    refused = subprocess.run([sys.executable, "-c", REFUSED], env=env,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
    assert refused.returncode == 0, refused.stderr[-2000:]
    for (shape_name, mesh_name), proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (out[-2000:], err[-3000:])
        with open(tmp_path / f"qwen1_5-0_5b__{shape_name}__{mesh_name}.json"
                  ) as f:
            rec = json.load(f)
        assert RECORD_KEYS <= set(rec) and rec["ok"], rec.get("error")
        assert rec["n_devices"] == (512 if mesh_name == "pod2x16x16" else 256)
        mem, tot = rec["memory"], rec["hlo_totals"]
        assert mem["argument_bytes"] == _spec_bytes("qwen1.5-0.5b",
                                                    shape_name, mesh_name)
        assert mem["temp_bytes"] >= mem["output_bytes"] > 0
        assert tot["flops"] > 0 and tot["memory_bytes"] > 0
        assert rec["cost_analysis"]["flops"] == \
            tot["flops"] + tot["elementwise_flops"]
        assert sum(rec["collective_bytes_by_reader"].values()) == \
            tot["collective_result_bytes"] > 0
        assert all(b["gb"] >= 0.1 for b in rec["top_buffers"])
        if shape_name == "train_4k":
            rb = torch_mesh_bytes.rank_bytes("qwen1.5-0.5b", 16, 16, True)
            shape = SHAPES[shape_name]
            batch = shape.global_batch // 16 * shape.seq_len * 4
            want = (rb["params_block_gb"] + rb["adamw_moments_gb"]) * 1e9 \
                + 4 + batch
            assert abs(mem["argument_bytes"] - want) <= 1e-6 * want
            assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
                set(tot["collective_counts"])
