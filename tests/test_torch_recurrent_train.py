"""The recurrent families' training (RWKV6, RecurrentGemma) against the JAX
reference on the CPU.

The reference trains both through plain algorithms, never its kernels:
RWKV6 through its jnp chunk algorithm ``wkv_chunked``, RecurrentGemma
through ``jax.lax.associative_scan``.  The port's training forwards do
the same in plain PyTorch under autograd (``models.rwkv6.wkv_chunked``,
``models.rglru.rg_lru_scan_train``).  Weights come across with
``models.io``; both sides compute in float32 at ``reduce_config`` size,
the reference under ``jax.jit`` (matmul precision "highest",
``tests/conftest.py``), the port on one torch thread.  Standards: the
loss within ``LOSS_TOL`` and every gradient within ``GRAD_TOL``
(``tests/test_torch_lm_train.py``'s); the scans' values and gradients
within 1e-5; the port's remat bit-equal to its run without.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import model as jmodel, rglru as jrglru, rwkv6 as jrwkv
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import steps
from repro_torch.models import io, model as model_lib, rglru, rwkv6
from repro_torch.train import optimizer as opt_lib
from test_torch_lm_train import GRAD_TOL, LOSS_TOL, _flat

# a tail layer and a window that 24 tokens pass, as the parity tests of
# tests/test_torch_rglru.py set them; rwkv6's 24 tokens are 3 chunks of 8
OVERRIDES = {"rwkv6-7b": {}, "recurrentgemma-2b": {"n_layers": 5,
                                                   "window": 16}}
T = 24
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(cfg):
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, T)).astype(
        np.int32)
    toks[0, 9] = -1                                 # a masked target
    return toks


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(port cfg, the reference's params as numpy, its loss, metrics and
    gradients by leaf path) of reduced ``arch`` on ``_tokens``: computed
    once for both remat cases (``jax.checkpoint`` changes no value)."""
    jcfg = jax_reduce_config(jax_get_config(arch), **OVERRIDES[arch])
    cfg = reduce_config(get_config(arch), **OVERRIDES[arch])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(p, jcfg, b), has_aux=True))(
        jparams, {"tokens": _tokens(cfg)})
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, tree, float(jl), {k: float(v) for k, v in jm.items()}, \
        _flat(jg)


def _port_loss(cfg, model, toks):
    """(loss, metrics, every reference leaf's gradient by its path)."""
    st = steps.train_state(cfg, model, opt_lib.make_optimizer("adamw"))
    total, m = model_lib.lm_loss(model, cfg, {"tokens": torch.as_tensor(toks)})
    grads, out, i = steps._grads(total, st["opt"].tensors()), {}, 0
    for name, leaf in st["opt"].params.items():
        n = 1 if isinstance(leaf, torch.Tensor) else len(leaf)
        out[name] = (grads[i] if isinstance(leaf, torch.Tensor)
                     else torch.stack(grads[i:i + n]))
        i += n
    return total.detach(), m, out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_lm_loss_and_gradients_match_reference(arch, remat):
    """``lm_loss`` (a masked target among 2 x 24 tokens) and every
    parameter's gradient, with ``cfg.remat`` on and off, against
    ``jax.value_and_grad(model.lm_loss)`` on the same weights: RWKV6
    through ``wkv_chunked`` in chunks of 8, RecurrentGemma's superblock
    and tail through the log-depth scan and the local attention past its
    window.  With remat the port's loss and gradients are also bit-equal
    to its own run without."""
    cfg, tree, jl, jm, want = _reference(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    model = io.lm_params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(cfg)
    total, m, grads = _port_loss(cfg, model, toks)
    np.testing.assert_allclose(float(total), jl, rtol=LOSS_TOL)
    for k in ("loss", "perplexity"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=LOSS_TOL,
                                   err_msg=k)
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
    if remat:
        plain = _port_loss(dataclasses.replace(cfg, remat=False), model, toks)
        assert torch.equal(plain[0], total)
        for name, g in grads.items():
            assert torch.equal(plain[2][name], g), name


@pytest.mark.parametrize("n", [1, 7, 64])
def test_rg_lru_scan_train_matches_associative_scan(n):
    """The log-depth scan against the reference's ``associative_scan``
    (``rg_lru_scan``, h0 folded into step 0) at T = 1, 7 and 64: the
    states, the last state, and the gradients of a weighted sum of them
    with respect to x, both gates, Λ and h0."""
    rng = np.random.default_rng(n)
    x, rg, ig = (rng.standard_normal((2, n, 8)).astype(np.float32)
                 for _ in range(3))
    rg, ig = 1 / (1 + np.exp(-rg)), 1 / (1 + np.exp(-ig))
    lam = rng.uniform(0.4, 0.9, 8).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((2, n, 8)).astype(np.float32)

    def jloss(*args):
        h, last = jrglru.rg_lru_scan(*args)
        return jnp.sum(h * w) + jnp.sum(last), (h, last)

    (_, (jh, jlast)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(x, rg, ig, lam, h0)
    args = [torch.tensor(a, requires_grad=True) for a in (x, rg, ig, lam, h0)]
    h, last = rglru.rg_lru_scan_train(*args)
    grads = torch.autograd.grad((h * torch.as_tensor(w)).sum() + last.sum(),
                                args)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast),
                               **SCAN_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **SCAN_TOL)


@pytest.mark.parametrize("n,chunk,d_dtype", [
    (24, 8, "compute"), (5, 8, "float32"), (32, 16, "compute")])
def test_wkv_chunked_matches_reference(n, chunk, d_dtype):
    """The port's model ``wkv_chunked`` against the reference's from a
    nonzero state: the output, the final state, and the gradients of a
    weighted sum of both with respect to r, k, v, the decay, u and the
    state; chunks of ``min(chunk, T)`` (T = 5 is one short chunk).  A T
    that the chunk does not divide raises, as the reference asserts."""
    rng = np.random.default_rng(n)
    b, h, kd = 2, 3, 8
    r, k, v = (rng.standard_normal((b, n, h, kd)).astype(np.float32)
               for _ in range(3))
    dlog = -np.exp(rng.uniform(-3, 1, (b, n, h, kd))).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    s0 = rng.standard_normal((b, h, kd, kd)).astype(np.float32)
    wy = rng.standard_normal((b, n, h, kd)).astype(np.float32)
    ws = rng.standard_normal((b, h, kd, kd)).astype(np.float32)

    def jloss(*args):
        y, s = jrwkv.wkv_chunked(*args, chunk, d_dtype_name=d_dtype)
        return jnp.sum(y * wy) + jnp.sum(s * ws), (y, s)

    (_, (jy, js)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(r, k, v, dlog, u, s0)
    args = [torch.tensor(a, requires_grad=True)
            for a in (r, k, v, dlog, u, s0)]
    y, s = rwkv6.wkv_chunked(*args, chunk, d_dtype)
    loss = (y * torch.as_tensor(wy)).sum() + (s * torch.as_tensor(ws)).sum()
    grads = torch.autograd.grad(loss, args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **SCAN_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **SCAN_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        z = torch.zeros((1, 6, 1, 2))
        rwkv6.wkv_chunked(z, z, z, z, torch.zeros((1, 2)),
                          torch.zeros((1, 1, 2, 2)), 4, d_dtype)
