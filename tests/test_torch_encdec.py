"""The port's enc-dec family (whisper-medium's backbone) against the JAX
reference on the CPU: the encoder, the teacher-forced forward, prefill's
cache, decode steps, the training loss and its gradients, one AdamW step
of ``make_train_step``, ``reference_groups``, and the CPU steps of
``launch/steps.py``.

Weights come across with ``models.io.lm_params_from_numpy`` from the
reference's ``init_params`` at ``reduce_config`` size (2 + 2 layers, d 64,
4 heads of 16, vocab 256 padded to 2,048); frames and tokens are drawn
from numpy with a seed.  Both sides compute in float32, the reference
under ``jax.jit`` (matmul precision "highest", ``tests/conftest.py``).
Standards: ``ENC_TOL`` for the encoder's output and the cross cache (a
few float32 ulps of outputs of order 1 after two layers), ``LOGIT_TOL``
for logits and the self cache (after the decoder and the unembedding;
the sinusoidal positions reach both from float32 ``pow``, ``sin`` and
``cos``, one ulp apart between the libraries), and the training standards
of ``tests/test_torch_lm_train.py``; integer cache state exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec, model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import steps
from repro_torch.models import encdec, io, model as model_lib
from repro_torch.train import optimizer as opt_lib

ARCH = "whisper-medium"
ENC_TOL = dict(atol=2e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
LR = 1e-3
B, S_ENC, T, MAX_LEN = 2, 24, 16, 40


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the file runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**overrides):
    """(reference cfg, port cfg, reference params, port model), reduced."""
    jcfg = jax_reduce_config(jax_get_config(ARCH), **overrides)
    cfg = reduce_config(get_config(ARCH), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jencdec.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, io.lm_params_from_numpy(tree, cfg, device="cpu")


def _inputs(cfg, b=B, s=S_ENC, t=T, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return frames, tokens


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(leaf) -> np.ndarray:
    x = leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))
    return x.detach().numpy()


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               err_msg=err_msg, **tol)


# ---------------------------------------------------------------------------
# Serving: encoder, teacher-forced forward, prefill, decode
# ---------------------------------------------------------------------------


def test_encode_and_forward_match_reference():
    """The encoder's output and the teacher-forced logits (padded ids at
    -1e9) against the reference's, and the sinusoidal table itself."""
    jcfg, cfg, jparams, model = _pair()
    frames, tokens = _inputs(cfg)
    # the angles reach S - 1 radians, where two float32 ulps of the angle
    # (the libraries' pow and division) move sin and cos by as much
    np.testing.assert_allclose(
        encdec.sinusoidal_positions(S_ENC, cfg.d_model).numpy(),
        np.asarray(jax.jit(jencdec.sinusoidal_positions,
                           static_argnums=(0, 1))(S_ENC, cfg.d_model)),
        atol=2 * float(np.spacing(np.float32(S_ENC))), rtol=0)
    jenc = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jparams, frames)
    jlogits, _ = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b))(
        jparams, {"frames": frames, "tokens": tokens})
    with torch.no_grad():
        enc = encdec.encode(model, cfg, _t(frames))
        logits, aux = model_lib.forward(
            model, cfg, {"frames": _t(frames), "tokens": _t(tokens)})
    _close(enc, jenc, **ENC_TOL)
    assert logits.shape == (B, T, cfg.vocab_padded) and float(aux) == 0.0
    _close(logits, jlogits, **LOGIT_TOL)
    assert bool((logits[..., cfg.vocab:] == -1e9).all())


def test_prefill_cache_and_decode_steps_match_reference():
    """``prefill``'s cache (the cross K/V padded to ``max_len``, ``enc_len``,
    an empty self cache at position 0) and 16 greedy ``decode_step``s
    from it: every step's logits, the self cache, ``kv_pos`` and ``pos``
    against the reference's, and the port's decode against its own
    teacher-forced forward on the tokens it fed (the reference's
    ``test_encdec_decode_matches_forward``).  Each step updates the cache
    in place: every tensor keeps its storage."""
    jcfg, cfg, jparams, model = _pair()
    frames, _ = _inputs(cfg, seed=1)
    jcache = jax.jit(lambda p, f: jmodel.prefill(p, jcfg, {"frames": f},
                                                 MAX_LEN))(jparams, frames)
    with torch.no_grad():
        cache = model_lib.prefill(model, cfg, {"frames": _t(frames)}, MAX_LEN)
    assert set(cache) == set(jcache)
    for k in ("cross_k", "cross_v"):
        assert cache[k].shape == (cfg.n_layers, B, MAX_LEN, cfg.n_heads,
                                  cfg.d_head)
        _close(cache[k], jcache[k], err_msg=k, **ENC_TOL)
    for k in ("self_k", "self_v", "enc_len", "kv_pos", "pos"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]),
                                      err_msg=k)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, t))
    tok = np.zeros(B, np.int32)                 # BOS
    fed = []
    logits_seen = []
    storage = {k: x.data_ptr() for k, x in cache.items()}
    for _ in range(16):
        fed.append(tok)
        jl, jcache = jstep(jparams, jcache, tok)
        with torch.no_grad():
            lg, out = model_lib.decode_step(model, cfg, cache, _t(tok))
        # in place, as a CUDA graph of the step needs
        assert out is cache and storage == {k: x.data_ptr()
                                            for k, x in cache.items()}
        _close(lg, jl, **LOGIT_TOL)
        logits_seen.append(lg)
        tok = np.asarray(jnp.argmax(jl[:, :cfg.vocab], -1), np.int32)
    for k in ("self_k", "self_v"):
        _close(cache[k], jcache[k], err_msg=k, **LOGIT_TOL)
    for k in ("kv_pos", "pos", "enc_len"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]),
                                      err_msg=k)
    assert int(cache["pos"]) == 16
    with torch.no_grad():
        tf, _ = model_lib.forward(model, cfg, {
            "frames": _t(frames), "tokens": _t(np.stack(fed, 1))})
    _close(torch.stack(logits_seen, 1), tf.numpy(), **LOGIT_TOL)


def test_prefill_needs_max_len_to_hold_the_frames():
    _, cfg, _, model = _pair()
    frames, _ = _inputs(cfg)
    with pytest.raises(ValueError, match="max_len 16"):
        model_lib.prefill(model, cfg, {"frames": _t(frames)}, 16)


def test_cpu_steps_equal_the_model_functions():
    """On the CPU ``make_prefill_step`` (a ``{"frames"}`` batch, the cache
    alone back) and ``make_decode_step`` are the model's functions."""
    _, cfg, _, model = _pair()
    frames, tokens = _inputs(cfg, seed=2)
    prefill, decode = steps.make_prefill_step(cfg, MAX_LEN), \
        steps.make_decode_step(cfg)
    with torch.no_grad():
        got = prefill(model, {"frames": _t(frames)})
        want = model_lib.prefill(model, cfg, {"frames": _t(frames)}, MAX_LEN)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for i in range(3):
            a, got = decode(model, got, _t(tokens[:, i]))
            b, want = model_lib.decode_step(model, cfg, want, _t(tokens[:, i]))
            assert torch.equal(a, b)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert prefill.graphs == {} and decode.graphs == {}


# ---------------------------------------------------------------------------
# Training: loss, gradients, one step, the reference's leaves
# ---------------------------------------------------------------------------


def test_lm_loss_and_gradients_match_reference():
    """``lm_loss`` (with a masked target) and every parameter's gradient
    against ``jax.value_and_grad(model.lm_loss)`` on ``{"frames",
    "tokens"}``; the enc-dec aux loss is 0."""
    jcfg, cfg, jparams, model = _pair()
    frames, tokens = _inputs(cfg, seed=3)
    tokens[1, 5] = -1
    batch = {"frames": frames, "tokens": tokens}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(p, jcfg, b), has_aux=True))(jparams, batch)
    st = steps.train_state(cfg, model, opt_lib.make_optimizer("adamw"))
    total, m = model_lib.lm_loss(model, cfg, {k: _t(v)
                                              for k, v in batch.items()})
    grads = steps._grads(total, st["opt"].tensors())
    np.testing.assert_allclose(float(total.detach()), float(jl),
                               rtol=LOSS_TOL)
    for k in ("loss", "aux_loss", "perplexity"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    want, i = _flat(jg), 0
    assert set(want) == set(st["opt"].params)
    for name, leaf in st["opt"].params.items():
        n = 1 if isinstance(leaf, torch.Tensor) else len(leaf)
        g = grads[i] if isinstance(leaf, torch.Tensor) else torch.stack(
            grads[i:i + n])
        i += n
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)


def test_remat_recomputes_the_same_loss_and_gradients():
    """``cfg.remat`` (whisper's default; the reduced config turns it off)
    recomputes each layer in the backward: the same loss and gradients."""
    _, cfg, _, model = _pair()
    frames, tokens = _inputs(cfg, seed=4)
    batch = {"frames": _t(frames), "tokens": _t(tokens)}
    wrt = [p.requires_grad_(True) for p in model.parameters()]
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        total, _ = model_lib.lm_loss(model, c, batch)
        out.append((total.detach(), steps._grads(total, wrt)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def _port_step(cfg, model, frames, tokens, mb):
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=10)
    cfg = dataclasses.replace(cfg, microbatches=mb)
    if mb > 1:
        frames = frames.reshape(mb, -1, *frames.shape[1:])
        tokens = tokens.reshape(mb, -1, tokens.shape[-1])
    st = steps.train_state(cfg, model, opt_lib.make_optimizer("adamw", **kw))
    return steps.make_train_step(cfg)(
        st, {"frames": _t(frames), "tokens": _t(tokens)})


def _reference_step(jcfg, jparams, frames, tokens):
    """The reference's ``make_train_step`` (its scan over the leading dim
    when ``jcfg.microbatches > 1``) on the same batch, from the same
    parameters."""
    jo = jopt.make_optimizer("adamw", peak_lr=LR, warmup_steps=0,
                             total_steps=10)
    mb = jcfg.microbatches
    if mb > 1:
        frames = frames.reshape(mb, -1, *frames.shape[1:])
        tokens = tokens.reshape(mb, -1, tokens.shape[-1])
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    return jax.jit(jsteps.make_train_step(jcfg, jo))(
        jstate, {"frames": frames, "tokens": tokens})


def _assert_step_matches(st, m, jnew, jm):
    """Parameters, AdamW state, step and every metric at the one-step
    standards."""
    assert int(st["step"]) == 1 and set(m) == set(jm)
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
    for k, x in got_opt.items():
        scale = max(float(np.abs(want_opt[k]).max()), 1e-30)
        np.testing.assert_allclose(x.numpy(), want_opt[k], err_msg=k,
                                   atol=1e-4 * scale, rtol=1e-3)


def test_train_step_matches_reference():
    """One ``make_train_step`` AdamW step against the reference's:
    parameters, optimizer state, step and metrics."""
    jcfg, cfg, jparams, model = _pair()
    frames, tokens = _inputs(cfg, b=4, seed=5)
    jnew, jm = _reference_step(jcfg, jparams, frames, tokens)
    st, m = _port_step(cfg, model, frames, tokens, 1)
    _assert_step_matches(st, m, jnew, jm)


def test_microbatched_train_step_slices_frames_with_tokens():
    """``microbatches=2`` on a (2, 2, ...) batch, frames sliced with their
    tokens, against the reference's scan over the same slices: parameters,
    AdamW state and every metric (each the slices' mean, perplexity
    included).  Then against the port's own whole-batch step: with no
    masked target each slice's loss has the same normaliser, so the
    parameters and the loss agree too; the perplexity does not, since the
    slices' mean of exp(loss) is not exp of the whole batch's loss."""
    jcfg, cfg, jparams, model = _pair(microbatches=2)
    frames, tokens = _inputs(cfg, b=4, seed=6)
    jnew, jm = _reference_step(jcfg, jparams, frames, tokens)
    sliced, ms = _port_step(cfg, model, frames, tokens, 2)
    _assert_step_matches(sliced, ms, jnew, jm)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    whole, mw = _port_step(cfg, io.lm_params_from_numpy(tree, cfg,
                                                        device="cpu"),
                           frames, tokens, 1)
    assert set(ms) == set(mw)
    for k in set(mw) - {"perplexity"}:
        np.testing.assert_allclose(float(ms[k]), float(mw[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for name, leaf in whole["opt"].params.items():
        np.testing.assert_allclose(_stacked(sliced["opt"].params[name]),
                                   _stacked(leaf), err_msg=name, **PARAM_TOL)


def test_reference_groups_round_trip_the_reference_tree():
    """``reference_groups`` gives the reference's leaf paths with its
    stacked shapes and values (``enc_layers`` and ``dec_layers`` stacked
    from the port's per-layer modules), and the port's own ``init_params``
    draws every leaf at the reference's shape and scale."""
    _, cfg, jparams, model = _pair()
    want = _flat(jparams)
    groups = io.reference_groups(model, cfg)
    assert set(groups) == set(want)
    assert len(groups["enc_layers/attn/wq"]) == cfg.n_enc_layers
    assert len(groups["dec_layers/cross_attn/wq"]) == cfg.n_layers
    for name, leaf in groups.items():
        np.testing.assert_array_equal(_stacked(leaf), want[name],
                                      err_msg=name)
    drawn = io.reference_groups(
        model_lib.init_params(cfg, seed=3, device="cpu"), cfg)
    for name, leaf in drawn.items():
        x, w = _stacked(leaf), want[name]
        assert x.shape == w.shape, name
        assert abs(float(x.std()) - float(w.std())) <= 0.15 * float(w.std()) \
            + 1e-12, name
        assert abs(float(x.mean()) - float(w.mean())) <= 0.1 * float(
            np.abs(w).max()) + 1e-12, name


def test_encdec_on_a_mesh_of_more_than_one_rank_raises():
    """Enc-dec on a mesh of two ranks: ``ShardedLM`` keeps the rank's
    blocks (every leaf that training splits over ``data`` halved, gathered
    at its use) and the steps build under its policy (the Megatron split:
    ``tests/test_torch_mesh.py`` trains and serves whisper on 4 ranks);
    what raises is the ``Trainer``, whose stream is tokens only, as the
    reference's launcher's."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy
    from repro_torch.train import trainer as trainer_lib

    _, cfg, _, model = _pair()
    whole = {k: tuple(_stacked(v).shape)
             for k, v in io.reference_groups(model, cfg).items()}
    mesh = sharding.Coord({"data": 2, "model": 1}, {"data": 1, "model": 0})
    sp = io.ShardedLM(model, cfg, mesh, train=True)
    for k, leaf in sp.leaves.items():
        spec = sp.specs[k]
        halves = ["data" in sharding.spec_axes(e) for e in spec]
        assert tuple(_stacked(leaf).shape) == tuple(
            n // 2 if h else n for n, h in zip(whole[k], halves)), k
    assert sp.gathers and set(sp.model.parameters()) == set(
        sp.compute_tensors())
    policy = MeshPolicy(mesh, {})
    steps.make_train_step(cfg, policy)
    steps.make_prefill_step(cfg, MAX_LEN, policy)
    steps.make_decode_step(cfg, policy)
    with pytest.raises(NotImplementedError, match="frames"):
        trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(), mesh=mesh,
                            device="cpu")