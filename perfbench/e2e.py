"""The end-to-end metrics, each over the whole window: every request due in
it, and every token generated in it.  A request not finished by the end of
the drain has failed: it misses the latency limit, scores 0 and counts as
+inf in the tails; a tail that falls on a failed request is reported as
``UNFINISHED_MS`` (JSON has no infinity).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

UNFINISHED_MS = 1e9


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile with linear interpolation between order
    statistics (numpy's default), where +inf values sort last: a rank that
    falls on or next to one reads +inf."""
    x = np.sort(np.asarray(values, np.float64))
    pos = (len(x) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(x[hi]):
        return math.inf
    return float(x[lo] + (x[hi] - x[lo]) * (pos - lo))


def per_request(window) -> List[dict]:
    """Each request due in the window: its type, tokens, and latencies
    from its due time (+inf where it failed)."""
    rows = []
    for s in window.sent:
        r, ok = s.req, window.done(s)
        n = len(r.generated) if r is not None else 0
        rows.append({
            "rtype": s.plan.rtype, "tokens": n, "done": ok,
            "tpot": (r.finish_time - s.due) / n if ok else math.inf,
            "ttft": (r.first_token_time - s.due)
            if r is not None and r.first_token_time is not None
            and r.first_token_time <= window.deadline else math.inf})
    return rows


def metrics(window, quality: Sequence[float], limit_s: float
            ) -> Dict[str, float]:
    rows = per_request(window)
    qos = [quality[r["rtype"]] * (r["tpot"] <= limit_s) for r in rows]
    tokens = sum(it.tokens for it in window.in_window())
    tail = lambda key: min(percentile([r[key] for r in rows], 95) * 1e3,
                           UNFINISHED_MS)
    return {"qos": float(np.mean(qos)),
            "tpot_p95_ms": tail("tpot"),
            "ttft_p95_ms": tail("ttft"),
            "tokens_per_s": tokens / window.seconds}

