"""Scenario compiler (port of ``repro/scenarios/compile.py``): lower a
``ScenarioSpec`` to dense per-bucket tables, built with numpy on the host
once and copied to the device once.

``compile_spec`` discretizes the horizon into ``T = ceil(horizon / dt)``
buckets and evaluates every event at each bucket's start:

    rate_mult  (T,)    f32   product of all workload-event multipliers
    up         (T, N)  bool  expert availability
    run_cap    (T, N)  i32   live run slots   (<= the baseline caps)
    wait_cap   (T, N)  i32   live wait slots  (<= the baseline caps)
    k_scale    (T, N)  f32   k1/k2 straggler multiplier

The lookup (``runtime.at_time``) is ``idx = clip(floor(t / dt), 0,
T-1)``: past the horizon the last bucket holds.  Capacity events are
clipped to the baseline caps, so every static shape downstream stays the
one the capacity-free system allocates.  Expert indices in fleet events
are taken modulo ``n_experts``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.scenarios import spec as spec_lib


class ScenarioTensors(NamedTuple):
    """Compiled per-bucket condition tables on one device.  ``dt`` is a
    (1,) float32 tensor, as in the reference; ``float(st.dt[0])`` is the
    Python value."""
    dt: torch.Tensor         # (1,)  bucket width, seconds
    rate_mult: torch.Tensor  # (T,)
    up: torch.Tensor         # (T, N)
    run_cap: torch.Tensor    # (T, N)
    wait_cap: torch.Tensor   # (T, N)
    k_scale: torch.Tensor    # (T, N)


def _bucket_mask(times: np.ndarray, t0: float, t1: float) -> np.ndarray:
    return (times >= t0) & (times < t1)


def compile_spec(spec: spec_lib.ScenarioSpec, n_experts: int,
                 run_width: int, wait_width: int,
                 base_run_caps: Optional[Tuple[int, ...]] = None,
                 base_wait_caps: Optional[Tuple[int, ...]] = None,
                 device=None) -> ScenarioTensors:
    """Lower ``spec`` to tables on ``device`` (the CUDA device by default)
    for an N-expert fleet with packed widths ``run_width``/``wait_width``
    and baseline caps ``base_run_caps``/``base_wait_caps`` (None: the
    packed widths)."""
    T = int(np.ceil(spec.horizon / spec.dt))
    times = np.arange(T, dtype=np.float64) * spec.dt  # bucket starts

    base_rc = np.asarray(base_run_caps if base_run_caps is not None
                         else (run_width,) * n_experts, np.int32)
    base_wc = np.asarray(base_wait_caps if base_wait_caps is not None
                         else (wait_width,) * n_experts, np.int32)
    if base_rc.shape != (n_experts,) or base_wc.shape != (n_experts,):
        raise ValueError(
            f"baseline caps must be length-{n_experts}; got "
            f"run={base_rc.shape}, wait={base_wc.shape}")

    rate_mult = np.ones(T, np.float64)
    up = np.ones((T, n_experts), bool)
    run_cap = np.tile(base_rc, (T, 1))
    wait_cap = np.tile(base_wc, (T, 1))
    k_scale = np.ones((T, n_experts), np.float64)

    for ev in spec.events:
        if isinstance(ev, spec_lib.FlashCrowd):
            rate_mult[_bucket_mask(times, ev.t0, ev.t1)] *= ev.mult
        elif isinstance(ev, spec_lib.DiurnalRate):
            rate_mult *= 1.0 + ev.amp * np.sin(
                2.0 * np.pi * times / ev.period)
        elif isinstance(ev, spec_lib.TraceReplay):
            for i, m in enumerate(ev.mults):
                rate_mult[_bucket_mask(times, ev.t0 + i * ev.dt,
                                       ev.t0 + (i + 1) * ev.dt)] *= m
        elif isinstance(ev, spec_lib.ExpertDown):
            up[_bucket_mask(times, ev.t0, ev.t1), ev.expert % n_experts] = \
                False
        elif isinstance(ev, spec_lib.Slowdown):
            k_scale[_bucket_mask(times, ev.t0, ev.t1),
                    ev.expert % n_experts] *= ev.factor
        elif isinstance(ev, spec_lib.CapClaim):
            n = ev.expert % n_experts
            m = _bucket_mask(times, ev.t0, ev.t1)
            run_cap[m, n] = np.clip(ev.run_cap, 1, base_rc[n])
            wait_cap[m, n] = np.clip(ev.wait_cap, 1, base_wc[n])
        else:  # ScenarioSpec.__post_init__ rejects these
            raise TypeError(f"unknown event {ev!r}")

    if np.any(rate_mult <= 0.0):
        raise ValueError(
            f"scenario {spec.name!r}: compiled rate multiplier must stay "
            f"positive (min {rate_mult.min():.3f}); cap DiurnalRate.amp "
            f"below 1 and TraceReplay mults above 0")
    tables = {"dt": np.asarray([spec.dt], np.float32),
              "rate_mult": rate_mult.astype(np.float32),
              "up": up,
              "run_cap": run_cap.astype(np.int32),
              "wait_cap": wait_cap.astype(np.int32),
              "k_scale": k_scale.astype(np.float32)}
    dev = resolve(device)
    return ScenarioTensors(**{k: torch.as_tensor(v).to(dev)
                              for k, v in tables.items()})
