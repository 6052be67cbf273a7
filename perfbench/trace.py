"""One ``torch.profiler`` window inside the measured window, and what is
read from it: each device operation (kernel, copy, set) with its
interval, and the client's spans (``client.*``, recorded by
``torch.profiler.record_function`` around each call into the program).

A ``Tracer`` starts the profiler between two of the server's steps once
``start`` seconds of the window have passed and stops it ``seconds``
later, so busy and wall time come from the same session and the trace
stays small enough to read inside a run.  A run traces the window's last
seconds: stopping the profiler holds the host for a while, and after the
window closes that delays no request's sending.  The profiler's clock is aligned
with the host clock through the client's step spans, which open where
the client reads the host clock for the same iteration.  Busy time is the
union of device intervals inside the traced window; the idle gaps between
them are put down to the client span open at their middle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np

STEP_SPANS = ("client.prefill", "client.decode")
NAME_CHARS = 160          # of a kernel's name in the breakdown


@dataclasses.dataclass
class Event:
    name: str
    start: float        # seconds, on the host clock after alignment
    end: float


@dataclasses.dataclass
class Trace:
    ops: List[Event]            # device operations, by start
    spans: List[Event]          # the client's spans, by start
    t0: float                   # the traced window, host clock
    t1: float

    def __post_init__(self):
        self.starts = np.array([e.start for e in self.ops])

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Tracer:
    """Profiles ``[start, start + seconds]`` of a window (seconds after it
    opens), starting and stopping between the server's steps; ``t0`` and
    ``t1`` are the host clock at the start and the stop."""

    def __init__(self, start: float, seconds: float):
        self.start, self.stop = start, start + seconds
        self.prof = None
        self.t0 = self.t1 = None

    def tick(self, elapsed: float) -> None:
        if self.t0 is None and elapsed >= self.start:
            self.prof = profiler()
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.t0 is not None and self.t1 is None and elapsed >= self.stop:
            self.close()

    def close(self) -> None:
        if self.t0 is not None and self.t1 is None:
            self.t1 = time.perf_counter()
            self.prof.stop()

    def read(self, iterations) -> Trace:
        """The trace, aligned by the iterations run inside it (the client's
        log; each has a step span there, in the same order)."""
        if self.t1 is None:
            raise RuntimeError("the traced window never opened")
        inside = [it for it in iterations
                  if it.t0 >= self.t0 and it.t1 <= self.t1]
        return read(self.prof, inside, self.t0, self.t1)


def read(prof, iterations, t0: float, t1: float) -> Trace:
    """The device operations and client spans of a finished session,
    aligned on the host clock by ``iterations``, those the session ran."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("client."):
            # the spans, and their copies on the device's timeline
            if not str(e.device_type()).endswith("CUDA"):
                spans.append((name, e.start_ns(), e.end_ns()))
        elif str(e.device_type()).endswith("CUDA"):
            ops.append((name, e.start_ns(), e.end_ns()))
    spans.sort(key=lambda s: s[1])
    steps = [s for s in spans if s[0] in STEP_SPANS]
    if len(steps) != len(iterations) or not iterations:
        raise RuntimeError(f"the trace holds {len(steps)} step spans for "
                           f"{len(iterations)} iterations")
    offset = float(np.median([s[1] * 1e-9 - it.t0
                              for s, it in zip(steps, iterations)]))
    conv = lambda rows: sorted((Event(n, a * 1e-9 - offset, b * 1e-9 - offset)
                                for n, a, b in rows), key=lambda e: e.start)
    return Trace(conv(ops), conv(spans), t0, t1)


def union(ops: List[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for e in ops:
        a, b = max(e.start, lo), min(e.end, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(trace: Trace) -> float:
    """Seconds of the traced window in which an operation ran."""
    return sum(b - a for a, b in union(trace.ops, trace.t0, trace.t1))


def idle_by_span(trace: Trace) -> Dict[str, float]:
    """Seconds of device idle time in the traced window by the client span
    open at each gap's middle (``host`` where none was)."""
    edges = np.array([trace.t0] + [x for iv in union(trace.ops, trace.t0,
                                                      trace.t1)
                                   for x in iv] + [trace.t1])
    a, b = edges[0::2], edges[1::2]
    keep = b > a
    a, b = a[keep], b[keep]
    mid = 0.5 * (a + b)
    starts = np.array([s.start for s in trace.spans])
    ends = np.array([s.end for s in trace.spans])
    names = np.array([s.name for s in trace.spans] + ["host"])
    # the client's spans follow one another: the last one started before
    # the middle is open there, or none is
    j = np.searchsorted(starts, mid, side="right") - 1
    open_ = (j >= 0) & (ends[np.maximum(j, 0)] >= mid)
    who = names[np.where(open_, j, len(names) - 1)]
    out: Dict[str, float] = {}
    for name in np.unique(who):
        out[str(name)] = float((b - a)[who == name].sum())
    return out


def ops_by_name(trace: Trace) -> Dict[str, float]:
    """Device seconds by operation name over the traced window."""
    out: Dict[str, float] = {}
    for e in trace.ops:
        if trace.t0 <= e.start < trace.t1:
            out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
    return out


def within(trace: Trace, t0: float, t1: float) -> List[Event]:
    """The device operations that started inside [t0, t1]."""
    i = int(np.searchsorted(trace.starts, t0, side="left"))
    j = int(np.searchsorted(trace.starts, t1, side="right"))
    return trace.ops[i:j]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each at most ``top`` entries, largest
    first."""
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops_by_name(trace)),
            "idle_gaps": rank(idle_by_span(trace))}
