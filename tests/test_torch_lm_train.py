"""The port's LM training (``models.model.lm_loss`` through the training
forward, AdamW and Adafactor, ``launch.steps.make_train_step``, the
synthetic data, checkpoints, the trainer and ``launch/train.py``'s LM
path) against the JAX reference on the CPU.

Weights come across with ``models.io``; both sides compute in float32 at
``reduce_config`` size, the reference under ``jax.jit`` (matmul precision
"highest", ``tests/conftest.py``).  Standards: the loss and its metrics
within 1e-5, every gradient within ``GRAD_TOL`` (float32 sums in another
order through two layers and the vocabulary); after one training step,
parameters within ``PARAM_TOL`` (an update is ``lr`` times a normalised
gradient, so a gradient element near zero can move its update by a share
of ``lr``) and optimizer state within ``GRAD_TOL``'s scale; the data walk,
the step counter and checkpointed values exact.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import model as jmodel, transformer as jtf
from repro.train import checkpoint as jckpt, optimizer as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib, steps, train as train_cli
from repro_torch.models import io, layers, model as model_lib
from repro_torch.train import checkpoint, optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib

ARCHS = ["qwen1.5-0.5b", "h2o-danube-3-4b", "dbrx-132b"]
LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
LR = 1e-3


def _pair(arch, **overrides):
    """(reference cfg, port cfg, reference params, port model), reduced."""
    jcfg = jax_reduce_config(jax_get_config(arch), **overrides)
    cfg = reduce_config(get_config(arch), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jtf.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, io.lm_params_from_numpy(tree, cfg, device="cpu")


def _flat(tree) -> dict:
    """A reference tree's leaves by their ``/``-joined paths."""
    return {"/".join(str(p.key) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(leaf) -> np.ndarray:
    x = leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))
    return x.detach().numpy()


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# The training forward, the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,sq,skv,offset", [
    (0, 40, 40, 0), (12, 40, 40, 0), (0, 24, 40, 16)])
def test_blockwise_attention_matches_reference(window, sq, skv, offset):
    """Values and gradients of the reference's ``blockwise_attention`` at
    GQA 4/2, ragged 16-blocks, a binding window and a kv offset."""
    from repro.models import layers as jlayers

    rng = np.random.default_rng(window + sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, block_q=16, block_kv=16,
              kv_offset=offset)

    def jloss(q, k, v):
        return jnp.sum(jlayers.blockwise_attention(q, k, v, **kw) * w)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = layers.blockwise_attention(tq, tk, tv, **kw)
    loss = (out * torch.as_tensor(w)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    """``lm_loss`` (with a masked target) and every parameter's gradient
    against ``jax.value_and_grad(model.lm_loss)``: qwen's tied embeddings
    and QKV bias, danube's window of 32 binding at 40 tokens, dbrx's MoE
    with its aux loss."""
    jcfg, cfg, jparams, model = _pair(arch)
    toks = _tokens(cfg, 2, 40)
    toks[1, 7] = -1                                 # a masked target
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(p, jcfg, b), has_aux=True))(
        jparams, {"tokens": toks})
    st = steps.train_state(cfg, model, opt_lib.make_optimizer("adamw"))
    total, m = model_lib.lm_loss(model, cfg, {"tokens": torch.as_tensor(toks)})
    grads = steps._grads(total, st["opt"].tensors())
    np.testing.assert_allclose(float(total.detach()), float(jl),
                               rtol=LOSS_TOL)
    for k in ("loss", "aux_loss", "perplexity"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    if cfg.family == "moe":
        assert float(m["aux_loss"]) > 0
    want, i = _flat(jg), 0
    assert set(want) == set(st["opt"].params)
    for name, leaf in st["opt"].params.items():
        n = 1 if isinstance(leaf, torch.Tensor) else len(leaf)
        g = grads[i] if isinstance(leaf, torch.Tensor) else torch.stack(
            grads[i:i + n])
        i += n
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_remat_recomputes_the_same_loss_and_gradients(arch):
    """``cfg.remat`` (every config's default; the reduced config turns it
    off) recomputes each layer in the backward, dense and MoE alike (the
    reference's ``jax.checkpoint``): the loss and every gradient
    bit-equal to the run without (which
    test_lm_loss_and_gradients_match_reference holds to the
    reference's)."""
    cfg = reduce_config(get_config(arch), remat=True)
    model = model_lib.init_params(cfg, seed=4, device="cpu")
    toks = _tokens(cfg, 2, 40, seed=4)
    st = steps.train_state(cfg, model, opt_lib.make_optimizer("adamw"))
    out = []
    for c in (dataclasses.replace(cfg, remat=False), cfg):
        total, _ = model_lib.lm_loss(model, c,
                                     {"tokens": torch.as_tensor(toks)})
        out.append((total.detach(), steps._grads(total, st["opt"].tensors())))
    assert torch.equal(out[1][0], out[0][0])
    for a, b in zip(out[1][1], out[0][1]):
        assert torch.equal(a, b)


def test_pallas_attention_refuses_gradients_and_other_families_raise():
    _, cfg, _, model = _pair("qwen1.5-0.5b", attn_impl="pallas")
    steps.train_state(cfg, model, opt_lib.make_optimizer("adamw"))
    toks = torch.as_tensor(_tokens(cfg, 1, 16))
    with pytest.raises(NotImplementedError, match="no backward|backward in"):
        model_lib.lm_loss(model, cfg, {"tokens": toks})
    with torch.no_grad():                       # no gradient asked: served
        logits, _ = model_lib.forward(model, cfg, toks, train=True)
    assert logits.shape == (1, 16, cfg.vocab_padded)
    # the recurrent families train through their plain scans
    # (tests/test_torch_recurrent_train.py)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        rcfg = reduce_config(get_config(arch))
        total, _ = model_lib.lm_loss(
            model_lib.init_params(rcfg, device="cpu"), rcfg,
            {"tokens": toks % rcfg.vocab})
        assert bool(torch.isfinite(total))
    # enc-dec trains (tests/test_torch_encdec.py), on frames and tokens
    cfg = reduce_config(get_config("whisper-medium"))
    frames = torch.zeros((1, 8, cfg.d_model))
    with torch.no_grad():
        total, _ = model_lib.lm_loss(
            model_lib.init_params(cfg, device="cpu"), cfg,
            {"frames": frames, "tokens": toks % cfg.vocab})
    assert bool(torch.isfinite(total))


# ---------------------------------------------------------------------------
# One training step
# ---------------------------------------------------------------------------

STEP_CASES = [("qwen1.5-0.5b", "adamw", 1), ("qwen1.5-0.5b", "adafactor", 2),
              ("h2o-danube-3-4b", "adamw", 2),
              ("h2o-danube-3-4b", "adafactor", 1),
              ("dbrx-132b", "adafactor", 1), ("dbrx-132b", "adamw", 2)]


@pytest.mark.parametrize("arch,opt,mb", STEP_CASES)
def test_train_step_matches_reference(arch, opt, mb):
    """One ``make_train_step`` step against the reference's, with AdamW,
    with Adafactor (per-layer norms factored across the stack, as the
    reference's stacked leaves are) and with ``microbatches=2`` (a (2,
    2, S) batch, gradients summed in float32): parameters, optimizer
    state, step and metrics."""
    jcfg, cfg, jparams, model = _pair(arch, microbatches=mb)
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=10)
    jo = jopt.make_optimizer(opt, **kw)
    toks = _tokens(cfg, 4, 24, seed=3)
    if mb > 1:
        toks = toks.reshape(mb, 4 // mb, 24)
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, jo))(
        jstate, {"tokens": toks})
    st = steps.train_state(cfg, model, opt_lib.make_optimizer(opt, **kw))
    st, m = steps.make_train_step(cfg)(st, {"tokens": torch.as_tensor(toks)})
    assert int(st["step"]) == 1 and st["step"] is st["opt"].step
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _flat(jnew["params"])
    for name, leaf in st["opt"].params.items():
        np.testing.assert_allclose(_stacked(leaf), want[name], err_msg=name,
                                   **PARAM_TOL)
    want_opt = _flat(jnew["opt"])
    got_opt = st["opt"].state()
    assert set(got_opt) == set(want_opt)
    scale = {k: max(float(np.abs(v).max()), 1e-30) for k, v in want_opt.items()}
    for k, x in got_opt.items():
        np.testing.assert_allclose(x.numpy(), want_opt[k], err_msg=k,
                                   atol=1e-4 * scale[k], rtol=1e-3)


# ---------------------------------------------------------------------------
# Data, checkpoints, the trainer and the CLI
# ---------------------------------------------------------------------------


def test_synthetic_walk_on_the_references_draws_is_exact():
    """The tables are the reference's; the walk on the reference's own
    draws gives its tokens; the port's stream depends on (seed, step)
    alone and keeps the (M, B/M, S) layout."""
    kw = dict(vocab=97, seq_len=12, global_batch=6, microbatches=2, seed=5)
    jdata = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    data = pipeline.SyntheticLM(pipeline.DataConfig(**kw), device="cpu")
    np.testing.assert_array_equal(data.tables.numpy(),
                                  pipeline._domain_tables(data.cfg))
    np.testing.assert_array_equal(np.asarray(jdata.tables),
                                  data.tables.numpy())
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    kd, k0, kb = jax.random.split(key, 3)
    draws = {"domain": jax.random.randint(kd, (6,), 0, 4),
             "tok0": jax.random.randint(k0, (6,), 0, 97),
             "branch": jax.random.randint(kb, (6, 12), 0, 8)}
    got = data.tokens({k: np.asarray(v) for k, v in draws.items()})
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdata.batch(3)["tokens"]))
    again = pipeline.SyntheticLM(pipeline.DataConfig(**kw), device="cpu")
    a, b = data.batch(7)["tokens"], again.batch(7)["tokens"]
    assert a.shape == (2, 3, 12) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, data.batch(8)["tokens"])
    it = iter(again)
    assert torch.equal(next(it)["tokens"], data.batch(0)["tokens"])


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A float32 checkpoint the reference writes (after one AdamW step, so
    the moments are live) restores into a port state drawn from other
    weights: every leaf exact, the step, and the reference's loss."""
    jcfg, cfg, jparams, _ = _pair("dbrx-132b")
    jo = jopt.make_optimizer("adamw", peak_lr=LR, warmup_steps=0,
                             total_steps=10)
    toks = _tokens(cfg, 2, 24)
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jo))(
        {"params": jparams, "opt": jo.init(jparams),
         "step": jnp.zeros((), jnp.int32)}, {"tokens": toks})
    jckpt.save(str(tmp_path), 1, jstate)
    port = model_lib.init_params(cfg, seed=11, device="cpu")
    st = steps.train_state(cfg, port, opt_lib.make_optimizer("adamw"))
    checkpoint.restore(str(tmp_path), trainer_lib.tree(st))
    assert int(st["step"]) == 1
    want = {**_flat({"params": jstate["params"]}),
            **_flat({"opt": jstate["opt"]})}
    got = checkpoint._flatten(trainer_lib.tree(st))
    assert set(got) == set(want) | {"step"}
    for k, w in want.items():
        np.testing.assert_array_equal(_stacked(got[k]), w, err_msg=k)
    jl, _ = jax.jit(lambda p, b: jmodel.lm_loss(p, jcfg, b))(
        jstate["params"], {"tokens": toks})
    with torch.no_grad():
        loss, _ = model_lib.lm_loss(port, cfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL)


def test_checkpoint_round_trip_bf16_prune_and_corruption(tmp_path):
    d = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    tree = lambda: {"params": {"w": torch.randn(3, 4, generator=g).to(
        torch.bfloat16), "layers": {"n": [torch.randn(5, generator=g)
                                          for _ in range(2)]}},
        "step": torch.zeros((), dtype=torch.int32)}
    saved = []
    for step in (1, 2, 3, 4):
        t = tree()
        t["step"].fill_(step)
        saved.append(t)
        checkpoint.save(d, step, t, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert checkpoint.latest_step(d) == 4
    meta = json.load(open(os.path.join(d, "step_00000004", "manifest.json")))
    assert meta["leaves"]["params/w"]["dtype"] == "bfloat16"
    assert meta["leaves"]["params/layers/n"]["shape"] == [2, 5]
    like = tree()
    checkpoint.restore(d, like)
    assert int(like["step"]) == 4 and like["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(like["params"]["w"], saved[-1]["params"]["w"])
    for a, b in zip(like["params"]["layers"]["n"],
                    saved[-1]["params"]["layers"]["n"]):
        assert torch.equal(a, b)
    checkpoint.restore(d, like, step=3)
    assert int(like["step"]) == 3
    with open(os.path.join(d, "step_00000004", "manifest.json"), "w") as f:
        f.write("{trunc")
    with pytest.raises(ValueError, match="corrupt"):
        checkpoint.restore(d, like)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), like)


def test_trainer_restart_reproduces_the_straight_run(tmp_path):
    """4 steps with checkpoints, then a new trainer restored from them for
    2 more, equal bit for bit to 6 straight steps (the data asked for
    each step by its number); logs; and the restored trainer on a 1 x 1
    mesh in a world of one (its policy, its blocks) bit for bit the same
    (meshes of more ranks: ``tests/test_torch_mesh.py``)."""
    cfg = reduce_config(get_config("qwen1.5-0.5b"))
    data = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4), device="cpu")
    logs = []

    def run(total, ckpt):
        tc = trainer_lib.TrainerConfig(total_steps=total, ckpt_dir=ckpt,
                                       ckpt_every=2, log_every=2)
        tr = trainer_lib.Trainer(cfg, tc, log_fn=logs.append, device="cpu")
        return tr.run(tr.init_or_restore(seed=0), data)

    run(4, str(tmp_path))
    assert checkpoint.latest_step(str(tmp_path)) == 4
    resumed = run(6, str(tmp_path))
    straight = run(6, "")
    assert any("restored step 4" in line for line in logs)
    assert int(resumed["step"]) == int(straight["step"]) == 6
    for (k, a), b in zip(resumed["params"].state_dict().items(),
                         straight["params"].state_dict().values()):
        assert torch.equal(a, b), k
    for k, x in resumed["opt"].state().items():
        assert torch.equal(x, straight["opt"].state()[k]), k
    # step 4's checkpoint alone, restored on the mesh, for steps 4 and 5
    shutil.copytree(tmp_path / "step_00000004",
                    tmp_path / "mesh" / "step_00000004")
    mesh_lib.init_world("cpu")
    try:
        tc = trainer_lib.TrainerConfig(total_steps=6,
                                       ckpt_dir=str(tmp_path / "mesh"))
        tr = trainer_lib.Trainer(cfg, tc, mesh=mesh_lib.make_host_mesh(1, 1),
                                 log_fn=logs.append, device="cpu")
        assert tr.policy is not None
        on_mesh = tr.init_or_restore(seed=0)
        assert int(on_mesh["step"]) == 4
        on_mesh = tr.run(on_mesh, data)
    finally:
        mesh_lib.close_world()
    for k, x in checkpoint._flatten(trainer_lib.tree(on_mesh)).items():
        y = checkpoint._flatten(trainer_lib.tree(straight))[k]
        for a, b in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y]):
            assert torch.equal(a, b), k


def test_train_cli_lm_path(capsys, tmp_path):
    state, trainer = train_cli.main([
        "--arch", "dbrx-132b", "--reduced", "--device", "cpu", "--steps",
        "2", "--global-batch", "4", "--seq-len", "16"])
    assert int(state["step"]) == 2 and len(trainer.step_s) == 2
    assert isinstance(state["opt"], opt_lib.Adafactor)
    assert "done at step 2" in capsys.readouterr().out
    # a mesh flag in one process: a world of one, which clips the host
    # mesh to 1 x 1 and so trains without a mesh, as the reference does;
    # the production mesh needs 256 ranks
    state, trainer = train_cli.main(["--model-parallel", "2", "--reduced",
                                     "--device", "cpu", "--steps", "1"])
    assert int(state["step"]) == 1 and trainer.mesh is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="mesh_shape \\(16, 16\\)"):
        train_cli.main(["--production-mesh", "--reduced", "--device", "cpu",
                        "--steps", "1"])
    # the recurrent families train one step, then a second from its
    # checkpoint; enc-dec's launcher refuses token batches
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        argv = ["--arch", arch, "--reduced", "--device", "cpu",
                "--global-batch", "2", "--seq-len", "16", "--ckpt-dir",
                str(tmp_path / arch), "--steps"]
        state, trainer = train_cli.main(argv + ["1"])
        assert int(state["step"]) == 1 and len(trainer.step_s) == 1
        assert isinstance(state["opt"], opt_lib.AdamW)
        state, trainer = train_cli.main(argv + ["2"])
        assert int(state["step"]) == 2 and trainer.restore_s is not None
        assert len(trainer.step_s) == 1
    with pytest.raises(NotImplementedError, match="token batches only"):
        train_cli.main(["--arch", "whisper-medium", "--reduced", "--device",
                        "cpu", "--steps", "1"])
