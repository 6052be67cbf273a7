"""The plain reference against the port at a tiny size on the CPU: one
forward over a segment, and the served tokens of whole windows (prefill
into the slot cache, decode of every slot, idle slots decoding past the
cache's end, MoE capacity drops across slots) judged through the same
check as the card's cells."""
import numpy as np
import pytest
import torch

from perfbench import run, tiny, weights
from perfbench.references import transformer as reference


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_forward_matches_the_port(family):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as model_lib

    conf = tiny.config(family)
    cfg = ModelConfig(**conf["model"])
    net, w = weights.build(cfg, 77, "cpu")
    tokens = np.random.default_rng(0).integers(0, 256, 24)
    logits, _ = model_lib.forward(net, cfg, torch.as_tensor(tokens)[None])
    groups = [(np.arange(24), 24)]
    ref, unsettled = reference.forward(
        reference.Weights(w), conf["model"], 64, [tokens], np.arange(24),
        groups)
    assert not unsettled.any()
    assert torch.allclose(ref, logits[0, :, :256].float(), atol=2e-4,
                          rtol=1e-4)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_served_tokens_match(family):
    cell = tiny.cell(family)
    with tiny.one_thread():
        sess = run.Session(cell, 2 ** 33 + 1, "cpu")
        sess.warm_up()
        win = sess.window(cell.cell["rate"], 1.0, cell.cell["grace_s"],
                          2 ** 33 + 1)
        sess.close_server()
        r = sess.judge(win)
    assert r["short"] == 0 and r["judged"] >= 100
    assert r["max_gap"] == 0.0        # float32 on both sides: same argmax


def test_fp8_rounding_keeps_a_scale_per_output_channel():
    w = torch.randn(64, 4, 16) * torch.linspace(0.1, 10, 64)[None, None, :16].repeat(1, 4, 1)
    q = reference.fp8_round(w, 1)
    rel = ((q - w).abs() / w.abs().amax(0, keepdim=True)).max()
    assert 0 < rel <= 2 ** -4
