"""The traffic generator: the same seed gives the same requests, every
seed the same work in a cyclic order, within the mix's laws."""
import json
import pathlib

import numpy as np
import pytest

from perfbench import traffic

HERE = pathlib.Path(__file__).resolve().parent
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
BIG_SEED = 2 ** 31 + 12345


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.plan(mix(name), 6.0, 20.0, BIG_SEED, 32000)
    b = traffic.plan(mix(name), 6.0, 20.0, BIG_SEED, 32000)
    assert [(r.due, r.max_new, r.rtype) for r in a] == \
        [(r.due, r.max_new, r.rtype) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_shift_one_cyclic_schedule(name):
    t = mix(name)
    a = traffic.plan(t, 6.0, 20.0, 1, 32000)
    b = traffic.plan(t, 6.0, 20.0, BIG_SEED, 32000)
    sizes = lambda rs: [(len(r.prompt), r.max_new, r.rtype) for r in rs]
    sa, sb = sizes(a), sizes(b)
    assert sa != sb
    shift = next(k for k in range(len(sa)) if sa[k:] + sa[:k] == sb)
    assert 0 < shift < len(sa)
    gap = lambda rs: np.diff([0.0] + [r.due for r in rs])
    # the same gap before each request, up to the one scale of the window
    ga, gb = gap(a), gap(b)
    ratio = (np.roll(ga, -shift)[1:] / gb[1:])
    i = len(sa) - shift
    assert np.allclose(np.delete(ratio, i - 1), ratio[0])


@pytest.mark.parametrize("name", MIXES)
def test_window_holds_rate_times_seconds(name):
    reqs = traffic.plan(mix(name), 7.3, 30.0, 5, 100352)
    assert len(reqs) == round(7.3 * 30.0)
    due = np.array([r.due for r in reqs])
    assert np.all(np.diff(due) >= 0) and 0 < due[0] and due[-1] < 30.0
    t = mix(name)
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.max_new for r in reqs])
    assert p.min() >= t["prompt"]["min"] and p.max() <= t["prompt"]["max"]
    assert o.min() >= t["output"]["min"] and o.max() <= t["output"]["max"]
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 100352


def test_chat_lengths_follow_the_pool():
    reqs = traffic.plan(mix("chat"), 100.0, 40.0, 3, 32000)
    out = np.array([r.max_new for r in reqs])
    prompt = np.array([len(r.prompt) for r in reqs])
    assert 160 < out.mean() < 205          # exp(N(4.7-5.4, 0.16-0.27))
    assert 95 < prompt.mean() < 120        # exp(N(4.5, 0.7)) in 16-256


def test_burst_arrivals_are_burstier_than_poisson():
    cv = lambda t: (lambda g: g.std() / g.mean())(np.diff(
        [r.due for r in traffic.plan(t, 40.0, 60.0, 9, 32000)]))
    # runs of ~4 arrivals at 4x the rate: mild, but above Poisson's 1
    assert cv(mix("burst")) > 1.03 * cv(mix("chat"))


def test_seed_bits_takes_large_and_negative_seeds():
    assert traffic.seed_bits(2 ** 40) == 2 ** 40
    assert 0 <= traffic.seed_bits(-3) < 2 ** 64
