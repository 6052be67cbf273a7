"""Declarative scenario DSL and registry (port of ``repro/scenarios/
spec.py``; pure Python, a copy of the reference's, so the port imports
nothing of it).

A *scenario* scripts time-varying conditions: **workload events**
modulate the arrival rate over wall-clock time, and **fleet events**
change the experts themselves (failure and recovery, stragglers, memory
claim and release that shrinks and restores per-expert queue caps).

Event semantics (all intervals are half-open ``[t0, t1)`` seconds):

  * ``FlashCrowd(t0, t1, mult)``      — arrival rate x ``mult`` in the window;
  * ``DiurnalRate(period, amp)``      — rate x ``1 + amp*sin(2*pi*t/period)``;
  * ``TraceReplay(t0, dt, mults)``    — ``mults[i]`` during
    ``[t0 + i*dt, t0 + (i+1)*dt)``;
  * ``ExpertDown(expert, t0, t1)``    — the expert admits and decodes
    nothing while down; routing to it is an impact-penalised violation;
  * ``Slowdown(expert, t0, t1, factor)`` — k1/k2 scaled by ``factor``;
  * ``CapClaim(expert, t0, t1, run_cap, wait_cap)`` — live run/wait slots
    shrink to the given caps (clipped to the baseline); beyond-cap
    occupants are evicted.

Named scenarios live in the registry (``register`` / ``get`` / ``names``);
``EnvConfig.scenario`` and ``launch/train.py --scenario`` select them by
name.  ``scenarios.compile`` lowers a spec to tables on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Workload events (rate multipliers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    t0: float
    t1: float
    mult: float = 4.0


@dataclasses.dataclass(frozen=True)
class DiurnalRate:
    period: float = 600.0
    amp: float = 0.5


@dataclasses.dataclass(frozen=True)
class TraceReplay:
    t0: float
    dt: float
    mults: Tuple[float, ...]


# ---------------------------------------------------------------------------
# Fleet events (availability / speed / capacity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExpertDown:
    expert: int
    t0: float
    t1: float


@dataclasses.dataclass(frozen=True)
class Slowdown:
    expert: int
    t0: float
    t1: float
    factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class CapClaim:
    expert: int
    t0: float
    t1: float
    run_cap: int = 1
    wait_cap: int = 1


WORKLOAD_EVENTS = (FlashCrowd, DiurnalRate, TraceReplay)
FLEET_EVENTS = (ExpertDown, Slowdown, CapClaim)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A named script of workload + fleet events over ``[0, horizon)``.

    ``dt`` is the compiled table's bucket width: conditions are sampled at
    bucket starts and held constant within a bucket (``compile`` docstring
    has the lookup rule).  Past the horizon the final bucket's conditions
    hold forever."""
    name: str
    horizon: float
    dt: float = 0.5
    events: Tuple = ()

    def __post_init__(self):
        if self.horizon <= 0 or self.dt <= 0:
            raise ValueError(
                f"scenario {self.name!r}: horizon and dt must be positive")
        for ev in self.events:
            if not isinstance(ev, WORKLOAD_EVENTS + FLEET_EVENTS):
                raise TypeError(
                    f"scenario {self.name!r}: unknown event {ev!r}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ScenarioSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Named scenarios.  Expert indices are taken modulo the fleet size at
# compile time, so the same spec runs at any N.  Time scales are sized for
# the benchmark/eval episodes (hundreds of arrivals at λ≈5 span ~100 s).
# ---------------------------------------------------------------------------

# Control scenario: no events at all.  Compiles to all-ones tables, which
# the engine treats byte-identically to running with no scenario — the
# regression anchor for the whole subsystem.
register(ScenarioSpec(name="always_up", horizon=10.0, events=()))

# A quiet start, then a 4x flash crowd for 30 s, then recovery.
register(ScenarioSpec(
    name="flash_crowd", horizon=120.0,
    events=(FlashCrowd(t0=30.0, t1=60.0, mult=4.0),)))

# Rolling outage: expert 0 fails and recovers, then expert 1 does, with a
# straggler phase on expert 2 in between — availability-aware routing has
# to steer around a moving hole in the fleet.
register(ScenarioSpec(
    name="rolling_outage", horizon=120.0,
    events=(ExpertDown(expert=0, t0=20.0, t1=50.0),
            Slowdown(expert=2, t0=35.0, t1=75.0, factor=3.0),
            ExpertDown(expert=1, t0=55.0, t1=90.0))))

# Memory pressure: co-resident jobs claim KV memory on two experts
# mid-episode (caps shrink to 1 run / 1 wait slot), then release it.
register(ScenarioSpec(
    name="memory_pressure", horizon=120.0,
    events=(CapClaim(expert=0, t0=25.0, t1=70.0, run_cap=1, wait_cap=1),
            CapClaim(expert=3, t0=45.0, t1=95.0, run_cap=2, wait_cap=1),
            DiurnalRate(period=120.0, amp=0.3))))

# Everything at once — the acceptance-test scenario: a flash crowd, one
# expert failure+recovery, a mid-episode cap shrink and a straggler.
register(ScenarioSpec(
    name="stress", horizon=120.0,
    events=(FlashCrowd(t0=20.0, t1=45.0, mult=3.0),
            ExpertDown(expert=1, t0=30.0, t1=70.0),
            CapClaim(expert=0, t0=40.0, t1=100.0, run_cap=1, wait_cap=2),
            Slowdown(expert=4, t0=10.0, t1=110.0, factor=2.5),
            TraceReplay(t0=60.0, dt=5.0,
                        mults=(1.5, 2.5, 0.5, 2.0, 0.75, 1.25)))))
