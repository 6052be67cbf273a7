"""The port's memory probes (``repro_torch.core.introspect``) against the
reference's ``repro.core.introspect`` on the CPU, and the port's
``examples/serve_cluster_torch.py``.

The HAN memory guards of ``tests/test_han_segments.py`` on the port's
``core/han.py`` (a batch of one env): doubling the fleet from 128 to 256
experts grows the largest intermediate at most 2.5x (linear, not an N^2
tensor), and a ragged fleet of caps 2 gives at most half the uniform
width-5 fleet's; each measured value equals the reference's on the same
observation.
"""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import features as jfeat, han as jhan
from repro.core.introspect import max_intermediate_elems as jax_elems
from repro_torch.core import features, han
from repro_torch.core.introspect import max_intermediate_elems, peak_bytes
from test_han_segments import _mask_beyond_caps, _rand_padded_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _params():
    return (jhan.init_params(jax.random.PRNGKey(0)),
            han.HAN(han.HANConfig(), torch.Generator().manual_seed(0)))


def _batched(obs) -> dict:
    """A reference observation as the port's batch of one env."""
    return {k: torch.from_numpy(np.array(v))[None] for k, v in obs.items()}


def _padded(n):
    jp, tp = _params()
    obs = _rand_padded_obs(jax.random.PRNGKey(1), n)
    want = jax_elems(lambda p, o: jhan.forward(p, o), jp, obs)
    with torch.no_grad():
        got = max_intermediate_elems(tp, _batched(obs))
    return want, got


def _segments(n, run_caps=None, wait_caps=None):
    jp, tp = _params()
    obs = _rand_padded_obs(jax.random.PRNGKey(1), n)
    if run_caps is not None:
        obs = _mask_beyond_caps(obs, run_caps, wait_caps)
    n_run = sum(run_caps) if run_caps is not None else n * 5
    kw = dict(run_caps=run_caps, wait_caps=wait_caps)
    seg = jfeat.to_segments(obs, **kw)
    want = jax_elems(lambda p, o: jhan.forward_segments(p, o, n_run=n_run,
                                                        **kw), jp, seg)
    tseg = features.to_segments(_batched(obs), **kw)
    with torch.no_grad():
        got = max_intermediate_elems(
            lambda o: tp.forward_segments(o, n_run=n_run, **kw), tseg)
    return want, got


@pytest.mark.parametrize("fwd", ["padded", "segments"])
def test_han_memory_scales_linearly_in_n(fwd):
    measure = _padded if fwd == "padded" else _segments
    (w128, m128), (w256, m256) = measure(128), measure(256)
    assert (m128, m256) == (w128, w256)
    assert m256 <= 2.5 * m128, (m128, m256)


def test_segments_memory_scales_with_sum_caps():
    n, width = 128, 5
    w_uniform, uniform = _segments(n, (width,) * n, (width,) * n)
    w_ragged, ragged = _segments(n, (2,) * n, (2,) * n)
    assert (uniform, ragged) == (w_uniform, w_ragged)
    assert ragged <= 0.5 * uniform, (ragged, uniform)


def test_max_intermediate_elems_on_the_meta_device():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 128), device="meta")
    assert max_intermediate_elems(lambda x, y: (x @ y).sum(), a, b) == 64 * 128


def test_peak_bytes_refuses_a_host_device():
    for dev in ("cpu", "meta"):
        with pytest.raises(RuntimeError, match="CUDA"):
            peak_bytes(lambda: None, device=dev)


def test_serve_cluster_example_on_the_cpu():
    """The example serves both streams through the port's ``launch/serve.py``
    on reduced experts."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "serve_cluster_torch.py"),
         "--device", "cpu", "--requests", "3", "--rate", "50"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum("k1=" in ln for ln in lines) == 3
    for router in ("rr", "sqf"):
        row = next(ln for ln in lines if f"router={router}" in ln)
        assert "done=3" in row and "QoS=" in row, row
