"""B2's tile algorithm and its wrapper against the JAX reference on the CPU.

``attention_tiled_ref`` is the bf16 CUDA kernel's algorithm in plain
PyTorch: the G query heads of a KV head packed into rows of 64-row tiles
(row r <-> position r // G, head r % G), key tiles of 64 walked from the
first the tile's first row can see to the last its last row can, an online
softmax in float32, P rounded to bf16 before PV.  It is where the kernel's
index mapping is checked without a card; on the card ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernel to it.

Inputs come from numpy with a seed; the reference runs under ``jax.jit``
(``tests/conftest.py`` sets its matmul precision to "highest"), and the
Pallas kernel in interpret mode.  Tolerances:

- float32: 2e-5, a few ulps of outputs of order 1 (summation order; P is
  not rounded in float32).
- bf16: ``2^-8 max|v| + 2^-7 |ref|`` per element.  Each p rounds to bf16
  within 2^-9 of itself while l sums the float32 p, so the normalised
  output moves by at most 2^-9 max|v| before its own rounding; the two
  outputs then round to bf16 apart by at most one step, 2^-7 of their
  magnitude.  The first term is twice that bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention
from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn.ref import attention_ref, attention_tiled_ref

F32_TOL = 2e-5
SEQS = (1, 16, 40, 130)


def _inputs(g, dh, s, seed, b=2, kv=2, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, kv * g, s, dh)).astype(np.float32),
            rng.standard_normal((b, kv, skv, dh)).astype(np.float32),
            rng.standard_normal((b, kv, skv, dh)).astype(np.float32))


def _jax_ref(q, k, v, causal, window):
    return np.asarray(jax.jit(lambda q, k, v: jax_attention_ref(
        q, k, v, causal=causal, window=window))(q, k, v)).astype(np.float32)


def _assert_bf16_close(got, ref, v):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    tol = 2.0 ** -8 * np.abs(v).max() + 2.0 ** -7 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dh", [16, 24, 120])
@pytest.mark.parametrize("g", [1, 4, 6, 12])
def test_tiled_ref_matches_reference(g, dh, window):
    """Packed rows in 64-row tiles at every S of ``SEQS`` (G = 12 splits a
    position's heads across tiles; S = 130 leaves a ragged key tile),
    float32 and bf16, against the reference's ``attention_ref``."""
    for s in SEQS:
        q, k, v = _inputs(g, dh, s, 1000 * g + 10 * dh + s + window)
        ref = _jax_ref(q, k, v, True, window)
        got = attention_tiled_ref(*map(torch.as_tensor, (q, k, v)),
                                  window=window)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)

        qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        ref = _jax_ref(qb, kb, vb, True, window)
        got = attention_tiled_ref(*(torch.as_tensor(x).bfloat16()
                                    for x in (q, k, v)), window=window)
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got, ref, np.asarray(vb, np.float32))


@pytest.mark.parametrize("g,dh,s,window", [(1, 16, 40, 0), (4, 24, 40, 8),
                                           (6, 16, 130, 0), (12, 24, 16, 8),
                                           (12, 16, 130, 8)])
def test_tiled_ref_matches_pallas_interpret(g, dh, s, window):
    """Against the TPU kernel itself, in interpret mode, float32."""
    q, k, v = _inputs(g, dh, s, 7 * g + s, b=1, kv=1)
    pallas = np.asarray(jax.jit(lambda q, k, v: flash_attention(
        q, k, v, causal=True, window=window, block_q=32, block_kv=32,
        interpret=True))(q, k, v))
    got = attention_tiled_ref(*map(torch.as_tensor, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), pallas, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (False, 9),
                                           (False, 0)])
def test_tiled_ref_unequal_lengths_and_empty_rows(causal, window):
    """Sq != Skv and causal=False stay in the contract; with causal and a
    window of 1 the rows past the last key see none and give 0."""
    q, k, v = _inputs(4, 24, 50, 11, b=1, kv=2, skv=37)
    ref = _jax_ref(q, k, v, causal, window)
    got = attention_tiled_ref(*map(torch.as_tensor, (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)
    if causal and window == 1:
        assert torch.equal(got[:, :, 37:], torch.zeros_like(got[:, :, 37:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_wrapper_takes_strided_views(dtype):
    """(B, H, S, dh) views of (B, S, H, dh) tensors, as the model hands them
    over, give the same output as contiguous copies and pass the wrapper's
    operand check (which runs on any device)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 40, n, 24)),
                               dtype=torch.float32).to(dtype).transpose(1, 2)
               for n in (8, 2, 2))
    assert not v.is_contiguous()
    fa_ops._check(q, k, v)
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attn(q, k, v, window=8)
    want = fa_ops.flash_attn(q.contiguous(), k.contiguous(), v.contiguous(),
                             window=8)
    assert torch.equal(got, want)
    assert torch.equal(got, attention_ref(q, k, v, window=8))
    assert fa_ops.LAUNCHES == before                      # plain version


def test_flash_attn_wrapper_check_rejects_what_the_kernel_cannot_take():
    bf = dict(dtype=torch.bfloat16)
    q = torch.zeros((1, 4, 16, 64), **bf)
    k = torch.zeros((1, 2, 16, 64), **bf)
    fa_ops._check(q, k, k)
    with pytest.raises(ValueError):                       # bf16 dh % 8 != 0
        fa_ops._check(*(torch.zeros((1, n, 16, 20), **bf) for n in (4, 2, 2)))
    fa_ops._check(*(torch.zeros((1, n, 16, 20)) for n in (4, 2, 2)))  # f32
    wide = torch.zeros((1, 2, 16, 68), **bf)[..., :64]    # rows of 136 bytes
    with pytest.raises(ValueError):
        fa_ops._check(q, wide, wide)
    with pytest.raises(ValueError):                       # dh not contiguous
        fa_ops._check(q, torch.zeros((1, 2, 64, 16), **bf).transpose(2, 3), k)
    # a dim of extent 1 may have any stride: it is never stepped along
    odd = torch.zeros(2048, **bf).as_strided((1, 2, 16, 64), (5, 1024, 64, 1))
    fa_ops._check(q, odd, odd)
