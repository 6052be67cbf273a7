"""The end-to-end metrics' arithmetic on synthetic timestamps: every
request due in the window counts, a failed one misses every limit, and
tokens per second count only the window's iterations."""
import math
import types

import pytest

from perfbench import client, e2e


def request(due, first, finish, n):
    return types.SimpleNamespace(first_token_time=first, finish_time=finish,
                                 generated=[0] * n)


def window():
    t_open, seconds, grace = 100.0, 10.0, 5.0
    plans = [types.SimpleNamespace(rtype=i % 2, due=0.0) for i in range(20)]
    sent = []
    for i, p in enumerate(plans):
        due = t_open + 0.5 * i
        if i == 19:                    # never finished by the deadline
            r = request(due, None, None, 0)
        else:                          # 10 ms a token, 20 + i tokens
            n = 20 + i
            r = request(due, due + 0.05, due + 0.01 * n * (1 + i / 100), n)
        sent.append(client.Sent(p, due, due, r))
    its = [client.Iteration("decode", t, t, 0.01, 4, rows=4)
           for t in (99.0, 100.5, 105.0, 109.9, 110.2, 114.0)]
    return client.Window(t_open, t_open + seconds, t_open + seconds + grace,
                         sent, its)


def test_failed_request_misses_every_limit():
    w = window()
    rows = e2e.per_request(w)
    assert len(rows) == 20
    assert not rows[19]["done"] and math.isinf(rows[19]["tpot"])
    assert math.isinf(rows[19]["ttft"])
    m = e2e.metrics(w, [0.5, 0.8], limit_s=0.01055)
    # tpot_i = 0.01 (1 + i/100): i = 0..5 meet 10.55 ms; the failed one
    # scores 0 and the 20 due requests are the base
    want = sum([0.5, 0.8][i % 2] for i in range(6)) / 20
    assert m["qos"] == pytest.approx(want)


def test_tails_are_over_all_requests_due():
    w = window()
    m = e2e.metrics(w, [1.0, 1.0], limit_s=1.0)
    tpots = sorted(0.01 * (1 + i / 100) for i in range(19)) + [math.inf]
    # numpy's linear rule: rank 0.95 * 19 = 18.05 lies between the last
    # finished request and the failed one, so the tail is unbounded
    assert m["tpot_p95_ms"] == e2e.UNFINISHED_MS
    assert e2e.percentile(tpots[:-1], 95) == pytest.approx(
        0.01 * (1 + 17.1 / 100))
    assert m["ttft_p95_ms"] == e2e.UNFINISHED_MS


def test_tokens_per_s_counts_the_window_only():
    w = window()
    m = e2e.metrics(w, [1.0, 1.0], limit_s=1.0)
    # iterations ending at 100.5, 105.0 and 109.9 lie in [100, 110]
    assert m["tokens_per_s"] == pytest.approx(3 * 4 / 10.0)


def test_percentile_matches_numpy_on_finite_values():
    import numpy as np
    x = [3.0, 1.0, 7.0, 2.5, 9.0, 4.0]
    assert e2e.percentile(x, 95) == pytest.approx(np.percentile(x, 95))

