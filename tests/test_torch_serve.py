"""The port's LM serving engine and launcher against the JAX reference on
the CPU: ``ExpertServer`` driven request for request beside the
reference's, ``calibrate`` on a fixed log, and ``launch/serve.py``'s CLI.

Both servers run the reduced configs in float32 on the same carried
weights, so their greedy tokens are the same up to float32 ties, which
these seeded prompts do not hit: iteration kinds, ``x`` values and
generated tokens must be identical.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.env import serve_engine as jserve
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.env import serve_engine
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import io, model as model_lib

# (prompt length, max_new): buckets 16, 32 and 64; the 40-token prompt
# under danube's window of 32 takes the ring placement, and with max_len 64
# it ends on the cache length, not on max_new
REQUESTS = [(12, 5), (30, 7), (40, 30), (9, 3), (20, 6)]


def _servers(arch, slots=2, max_len=64):
    jcfg = jax_reduce_config(jax_get_config(arch))
    cfg = reduce_config(get_config(arch))
    jparams = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    model = io.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                    cfg, device="cpu")
    return (jserve.ExpertServer("ref", jcfg, jparams, slots=slots,
                                max_len=max_len),
            serve_engine.ExpertServer("port", cfg, model, slots=slots,
                                      max_len=max_len))


def _drive(srv, request_cls, prompts):
    for rid, (toks, max_new) in enumerate(prompts):
        srv.submit(request_cls(rid=rid, tokens=toks, max_new=max_new,
                               submit_time=1.0))
    finished = []
    while srv.has_work():
        finished.extend(srv.step())
    return finished


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-3-4b",
                                  "starcoder2-15b"])
def test_expert_server_matches_reference_token_for_token(arch):
    ref_srv, srv = _servers(arch)
    rng = np.random.default_rng(12)
    prompts = [(rng.integers(2, srv.cfg.vocab, p), n) for p, n in REQUESTS]
    ref_done = _drive(ref_srv, jserve.Request, prompts)
    launches = fa_ops.LAUNCHES
    done = _drive(srv, serve_engine.Request, prompts)
    assert fa_ops.LAUNCHES == launches            # CPU: the plain version

    kinds = lambda s: [(e["kind"], e["x"]) for e in s.iteration_log]
    assert kinds(srv) == kinds(ref_srv)
    assert [r.rid for r in done] == [r.rid for r in ref_done]
    for got, ref in zip(done, ref_done):
        assert got.generated == [int(x) for x in ref.generated], got.rid
        assert got.slot == ref.slot
    assert any(len(r.generated) < r.max_new for r in done)   # ended on max_len
    np.testing.assert_array_equal(srv.pos, srv.cache["pos"].numpy())
    np.testing.assert_array_equal(srv.cache["pos"].numpy(),
                                  np.asarray(ref_srv.cache["pos"]))
    np.testing.assert_array_equal(srv.cache["kv_pos"].numpy(),
                                  np.asarray(ref_srv.cache["kv_pos"]))


def test_calibrate_matches_reference_on_a_fixed_log():
    rng = np.random.default_rng(13)
    log = [{"kind": kind, "x": int(x), "dt": float(dt), "expert": "e"}
           for kind, x, dt in zip(rng.choice(["prefill", "decode"], 40),
                                  rng.integers(1, 400, 40),
                                  rng.uniform(1e-3, 5e-2, 40))]
    srv = types.SimpleNamespace(iteration_log=log)
    assert serve_engine.calibrate(srv) == jserve.calibrate(srv)
    one = types.SimpleNamespace(iteration_log=log[:1])
    assert serve_engine.calibrate(one) == jserve.calibrate(one)


@pytest.mark.parametrize("n", [1, 16, 17, 64, 100, 128, 129, 256, 300])
def test_bucket_matches_reference(n):
    assert serve_engine._bucket(n) == jserve._bucket(n)


def test_serve_cli_completes_every_request_on_cpu(capsys):
    args = serve.build_parser().parse_args([])
    assert args.device == "cuda" and not args.full_width
    assert args.experts == serve.DEFAULT_EXPERTS
    m = serve.main(["--device", "cpu", "--requests", "6", "--rate", "200",
                    "--router", "rr"])
    assert m["completed"] == 6
    assert m["generated_tokens"] >= 6 and m["tokens_per_s"] > 0
    assert 0.0 <= m["avg_qos"] <= 1.0
    out = capsys.readouterr().out
    assert out.count("k1=") == len(serve.DEFAULT_EXPERTS)


def test_run_stream_routes_with_a_policy_and_profiles():
    servers = serve.build_cluster(["qwen1.5-0.5b", "starcoder2-15b"],
                                  device="cpu")
    assert [s.cfg.d_model for s in servers] == [64, 64]    # reduced
    fits = serve.profile_cluster(servers, n_warm=2)
    for f in fits:
        assert f["n_prefill"] >= 1 and f["n_decode"] >= 2
        assert all(np.isfinite(v) for v in f.values())
    assert all(s.iteration_log == [] for s in servers)
    m = serve.run_stream(servers, n_requests=5, rate=500.0,
                         policy_fn=lambda srvs, req: 1)
    assert m["completed"] == 5
    assert servers[0].iteration_log == []           # everything went to 1
    assert sum(e["kind"] == "prefill" for e in servers[1].iteration_log) == 5


def test_serving_defaults_to_cuda_and_serves_only_dense():
    """Serving defaults to CUDA; the engine serves the LM families the
    reference's engine serves (dense and MoE) and refuses the others, as
    the reference does (an SSM expert)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.build_cluster(["qwen1.5-0.5b"])
    moe = reduce_config(get_config("dbrx-132b"))
    srv = serve_engine.ExpertServer(
        "moe", moe, model_lib.init_params(moe, device="cpu"), slots=2,
        max_len=32)
    assert srv.cache["k"].shape == (moe.n_layers, 2, 32, moe.n_kv_heads,
                                    moe.d_head)
    cluster = serve.build_cluster(["qwen1.5-0.5b", "dbrx-132b"], device="cpu")
    assert [s.cfg.family for s in cluster] == ["dense", "moe"]
    ssm = reduce_config(get_config("rwkv6-7b"))
    model = model_lib.init_params(reduce_config(get_config("qwen1.5-0.5b")),
                                  device="cpu")
    with pytest.raises(ValueError, match="dense and MoE"):
        serve_engine.ExpertServer("ssm", ssm, model)
    with pytest.raises(AssertionError):
        jserve.ExpertServer("ssm", jax_reduce_config(jax_get_config("rwkv6-7b")),
                            None)
