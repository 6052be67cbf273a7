"""The open-loop client: it sends each request when it is due, whatever the
server is doing, and steps the server whenever it has work.

One host thread.  The server (``repro_torch.env.serve_engine.ExpertServer``)
takes a request by ``submit`` and runs one iteration per ``step``: one
prefill into a free slot, or one decode of every slot, synchronised with
the host at its end.  The client can only send between steps, so a request
may be sent late; its ``submit_time`` is set to its due time, so every
latency counts that lateness, and ``sent`` records it.

Every iteration from the server's creation is logged (``Iteration``): the
warm-up's too, since an MoE decode routes the stale tokens of empty slots
with the live ones, and the check replays the whole history.  A prefill is
due exactly when requests wait and a slot is free (the engine admits one
prefill or decodes all); the log holds the admitted request and its slot,
and raises where the engine did otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np

from perfbench.traffic import Planned


@dataclasses.dataclass
class Iteration:
    kind: str                       # "prefill" | "decode"
    t0: float                       # host clock around the client's call
    t1: float
    dt: float                       # the engine's own span (iteration_log)
    tokens: int                     # tokens this iteration generated
    rid: Optional[int] = None       # prefill: the admitted request
    slot: Optional[int] = None      # prefill: its slot
    prompt_len: int = 0             # prefill: its prompt
    bucket: int = 0                 # prefill: the prompt's padded length
    max_new: int = 0                # prefill: the tokens it asks for
    rows: int = 0                   # decode: requests running in it


@dataclasses.dataclass
class Sent:
    plan: Planned
    due: float                      # host clock
    sent: float = float("nan")
    req: object = None              # the server's Request


class Client:
    """Drives one server; ``log`` holds every iteration since its
    creation.  ``spans`` (a context-manager factory, e.g.
    ``torch.profiler.record_function``) wraps each call into the program
    when tracing."""

    def __init__(self, server, buckets, spans=None):
        self.server = server
        self.buckets = tuple(buckets)
        self.log: List[Iteration] = []
        self.spans = spans

    def _span(self, name: str):
        return self.spans(name) if self.spans else contextlib.nullcontext()

    def bucket(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.buckets[-1])

    def submit(self, req) -> None:
        with self._span("client.submit"):
            self.server.submit(req)

    def step(self) -> list:
        srv = self.server
        prefill = bool(srv.waiting) and srv.n_running < srv.slots
        head = srv.waiting[0] if prefill else None
        rows = srv.n_running
        n_log = len(srv.iteration_log)
        with self._span("client.prefill" if prefill else "client.decode"):
            t0 = time.perf_counter()
            finished = srv.step()
            t1 = time.perf_counter()
        entry = srv.iteration_log[n_log]
        if entry["kind"] != ("prefill" if prefill else "decode"):
            raise RuntimeError(f"the engine ran a {entry['kind']} where the "
                               "client expected the other")
        if prefill:
            p = len(head.tokens)
            self.log.append(Iteration("prefill", t0, t1, entry["dt"], 1,
                                      rid=head.rid, slot=head.slot,
                                      prompt_len=p, bucket=self.bucket(p),
                                      max_new=head.max_new))
        else:
            self.log.append(Iteration("decode", t0, t1, entry["dt"], rows,
                                      rows=rows))
        return finished

    def drain(self) -> None:
        while self.server.has_work():
            self.step()

    def window(self, planned: List[Planned], seconds: float, grace: float,
               make_request, tracer=None) -> "Window":
        """Offer ``planned`` open loop over ``seconds``, then drain for at
        most ``grace`` seconds.  ``make_request(plan, due)`` builds the
        server's request; ``tracer.tick(elapsed)`` (``trace.Tracer``), when
        given, runs between the server's steps."""
        n = len(planned)
        t_open = time.perf_counter() + 0.01
        sent = [Sent(p, t_open + p.due) for p in planned]
        t_close = t_open + seconds
        deadline = t_close + grace
        first_log = len(self.log)
        i = 0
        while True:
            now = time.perf_counter()
            if tracer is not None:
                tracer.tick(now - t_open)
            while i < n and sent[i].due <= now:
                s = sent[i]
                s.req = make_request(s.plan, s.due)
                s.sent = time.perf_counter()
                self.submit(s.req)
                i += 1
            if now > deadline:
                break
            if self.server.has_work():
                self.step()
                continue
            if i >= n:
                break
            with self._span("client.wait"):
                wait = sent[i].due - time.perf_counter()
                if wait > 0.002:
                    time.sleep(wait - 0.001)
                while time.perf_counter() < sent[i].due:
                    pass
        if tracer is not None:
            tracer.close()
        return Window(t_open, t_close, deadline, sent, self.log[first_log:])


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    deadline: float
    sent: List[Sent]
    iterations: List[Iteration]

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def done(self, s: Sent) -> bool:
        r = s.req
        return (r is not None and r.finish_time is not None
                and r.finish_time <= self.deadline)

    def in_window(self) -> List[Iteration]:
        return [it for it in self.iterations
                if self.t_open <= it.t1 <= self.t_close]

    def lateness(self) -> np.ndarray:
        return np.array([s.sent - s.due for s in self.sent])
