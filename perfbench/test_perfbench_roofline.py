"""The roofline's operation and byte counts against hand counts at both
configurations' published widths."""
import json
import pathlib

import pytest

from perfbench import roofline

HERE = pathlib.Path(__file__).resolve().parent


def model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


DANUBE, DBRX = model("h2o-danube3-4b"), model("dbrx-132b-4l")


def test_weight_bytes_by_hand():
    # danube: per layer wq, wo 3840 x 32 x 120 each, wk, wv 3840 x 8 x 120
    # each, the MLP 3 x 3840 x 10240, two norms of 3840; the final norm
    # and the head 3840 x 32000; bf16
    layer = 2 * 14_745_600 + 2 * 3_686_400 + 117_964_800 + 7_680
    assert roofline.weight_bytes(DANUBE) == 2 * (24 * layer + 3_840
                                                 + 122_880_000)
    # dbrx: wq, wo 6144 x 48 x 128, wk, wv 6144 x 8 x 128, 16 experts of
    # 3 x 6144 x 10752, two norms (bf16); the router 6144 x 16 in float32
    layer = 2 * (2 * 37_748_736 + 2 * 6_291_456 + 16 * 198_180_864
                 + 12_288) + 4 * 98_304
    assert roofline.weight_bytes(DBRX) == 4 * layer + 2 * (6_144
                                                           + 616_562_688)


def test_token_flops_by_hand():
    # 2 per multiply-add of the projections one token needs
    assert roofline.token_flops(DANUBE) == 2 * 24 * (
        2 * 14_745_600 + 2 * 3_686_400 + 117_964_800)
    # an MoE token: 4 of the 16 experts and the router
    assert roofline.token_flops(DBRX) == 2 * 4 * (
        2 * 37_748_736 + 2 * 6_291_456 + 4 * 198_180_864 + 98_304)


def test_decode_step_counts_rows_and_cache():
    keys = [100, 300, 556]
    flops, nbytes = roofline.decode_step(DANUBE, keys)
    attn = 4 * 24 * 32 * 120 * sum(keys)              # QK and PV
    head = 2 * 3 * 3840 * 32000
    assert flops == 3 * roofline.token_flops(DANUBE) + attn + head
    kv = sum(keys) * 24 * 2 * 8 * 120 * 2
    assert nbytes == (roofline.weight_bytes(DANUBE) + 3 * 3840 * 2 + kv
                      + 3 * 32000 * 2)


def test_prefill_counts_the_prompt_not_the_bucket():
    f100, b100 = roofline.prefill_step(DANUBE, 100)
    f101, _ = roofline.prefill_step(DANUBE, 101)
    assert f101 - f100 == (roofline.token_flops(DANUBE)
                           + 4 * 24 * 32 * 120 * 101)
    assert b100 == (roofline.weight_bytes(DANUBE) + 100 * 3840 * 2
                    + 100 * 24 * 2 * 8 * 120 * 2 + 32000 * 2)


def test_b2_launch_by_hand():
    # 16 queries, causal: 136 (query, key) pairs; the window of 4096
    # masks nothing at 16
    flops, nbytes = roofline.b2_launch(DANUBE, 16)
    assert flops == 4 * 32 * 120 * 136
    assert nbytes == 16 * (2 * 32 + 2 * 8) * 120 * 2


def test_b3_launch_reads_each_slots_valid_prefix():
    flops, nbytes = roofline.b3_launch(DBRX, [10, 576])
    assert flops == 4 * 48 * 128 * 586
    assert nbytes == 586 * 2 * 8 * 128 * 2 + 2 * 2 * 48 * 128 * 2


def test_b4_layer_by_hand():
    # 16 tokens x top-4 into capacity 5: 80 rows, at most 64 kept
    flops, nbytes = roofline.b4_layer(DBRX, 16)
    assert roofline.capacity(DBRX, 16) == 5
    assert flops == 2 * 64 * 6144 * 10752 * 3
    assert nbytes == 2 * (16 * 198_180_864 + 80 * 6144 * 2 + 80 * 10752 * 2)
    # weight-bound: the least time is the bytes' (about 1.90 ms a layer)
    assert roofline.least(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert roofline.capacity(DBRX, 256) == 80
    assert roofline.capacity(DBRX, 1024) == 384
