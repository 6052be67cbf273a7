"""The one traffic generator: a mix's data file in, the window's requests
out.

A mix (``perfbench/traffic/<name>.json``) gives the arrival law, the prompt
and output length laws, the request types with their quality, and a
``population_seed``.  A run of ``seconds`` at ``rate`` offers exactly
``n = round(rate * seconds)`` requests.  Their sizes and types, and the gap
before each, are drawn once from the population seed as one cyclic
sequence; the run's ``--seed`` picks where in it the window starts, and
draws the token ids.  So every seed offers the same requests, each after
the same gap, in the same cyclic order: the same bursts and lulls, at
other times of the window.  Runs with different seeds then differ by
where the work falls, not by the work.

Laws (frozen copies of the paper's, from the JAX package's
``env/workload.py`` and ``env/profiles.py``):

- ``poisson``: exponential gaps.  Scaled to fill the window, n + 1 of them
  are the Poisson process given n arrivals in it.
- ``realworld``: BurstGPT-like: a diurnal modulation times a two-state
  (calm, burst) Markov intensity flipped at each arrival, normalised so its
  long-run rate is the base rate (``workload.current_rate``).
- prompt ``lognormal``: ``exp(N(mu, sigma))`` clamped to [min, max], then
  truncated to a whole number (``profiles.sample_request``).
- output ``pool``: ``exp(N(log_len_mean[type], log_len_std[type]))`` clamped
  to [min, max] and truncated: the output law of expert 0 of the paper's
  seed-0 pool (``profiles.make_pool``); ``uniform``: whole numbers in
  [min, max].
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Planned:
    rid: int
    due: float            # seconds after the window opens
    prompt: np.ndarray    # token ids, int32
    max_new: int
    rtype: int


def seed_bits(seed: int) -> int:
    """A whole-number seed as the non-negative 64-bit value both numpy and
    torch generators take."""
    return int(seed) & (2 ** 64 - 1)


def gaps(law: dict, n: int, rate: float, rng: np.random.Generator
         ) -> np.ndarray:
    """n + 1 gaps (seconds) of the arrival law at the long-run ``rate``."""
    kind = law["law"]
    if kind == "poisson":
        return rng.exponential(1.0 / rate, n + 1)
    if kind != "realworld":
        raise ValueError(f"unknown arrival law {kind!r}")
    mult, p_on, p_off = (law["burst_rate_mult"], law["burst_on_prob"],
                         law["burst_off_prob"])
    stationary = p_on / (p_on + p_off)
    t_burst = stationary / mult
    time_frac = t_burst / (t_burst + (1.0 - stationary))
    norm = 1.0 + time_frac * (mult - 1.0)
    period = law["diurnal_period"]
    t, burst, out = 0.0, False, np.empty(n + 1)
    for i in range(n + 1):
        diurnal = 1.0 + law["diurnal_amp"] * math.sin(2.0 * math.pi * t / period)
        now = max(rate * diurnal * (mult if burst else 1.0) / norm, 1e-3)
        out[i] = rng.exponential(1.0) / now
        t += out[i]
        u = rng.uniform()
        burst = (u >= p_off) if burst else (u < p_on)
    return out


def lengths(law: dict, rtypes: np.ndarray, rng: np.random.Generator
            ) -> np.ndarray:
    n = len(rtypes)
    kind = law["law"]
    if kind == "lognormal":
        x = np.exp(rng.normal(law["mu"], law["sigma"], n))
    elif kind == "pool":
        mean = np.asarray(law["log_len_mean"])[rtypes]
        std = np.asarray(law["log_len_std"])[rtypes]
        x = np.exp(mean + std * rng.normal(0.0, 1.0, n))
    elif kind == "uniform":
        return rng.integers(law["min"], law["max"] + 1, n)
    else:
        raise ValueError(f"unknown length law {kind!r}")
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


def plan(traffic: dict, rate: float, seconds: float, seed: int, vocab: int
         ) -> List[Planned]:
    """The requests due in a window of ``seconds`` at ``rate`` requests/s,
    in order of due time."""
    n = max(1, int(round(rate * seconds)))
    pop = np.random.default_rng(int(traffic["population_seed"]))
    g = gaps(traffic["arrivals"], n, rate, pop)
    rtypes = pop.integers(0, len(traffic["quality"]), n)
    p_len = lengths(traffic["prompt"], rtypes, pop)
    out_len = lengths(traffic["output"], rtypes, pop)
    run = np.random.default_rng(seed_bits(seed))
    order = np.roll(np.arange(n), -int(run.integers(0, n)))
    g = np.concatenate([g[:n][order], g[n:]])
    due = np.cumsum(g * (seconds / g.sum()))[:n]
    reqs = []
    for i, j in enumerate(order):
        prompt = run.integers(0, vocab, int(p_len[j])).astype(np.int32)
        reqs.append(Planned(rid=i, due=float(due[i]), prompt=prompt,
                            max_new=int(out_len[j]), rtype=int(rtypes[j])))
    return reqs
