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
