"""One run of one cell of the benchmark:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds the program's kernels (into
``build/`` in the checkout, where later runs find them), draws the
configuration's weights on the card from the seed (``weights.py``),
builds one ``ExpertServer`` and warms up every prompt bucket and the
decode through the client.  The window then offers the cell's traffic
open loop for ``--seconds`` (``client.py``) and drains for at most the
cell's grace.  With ``--trace 0`` the line reports the end-to-end metrics
(``e2e.py``); with ``--trace 1`` a ``torch.profiler`` window inside it
gives the per-layer metrics (``metrics/<name>.py``).  Once the window has
closed and the program's server and model are freed, the served tokens
are judged against the plain reference (``check.py``), which takes its
weights from a second draw from the seed.

The last line of standard output is the result; the last lines of
standard error are the numbers compared with their limits.  Exit codes:
0 a result was printed, 1 the run found JAX or the JAX package loaded,
2 a bad argument or cell, 3 no card (or too few).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import gc
import json
import math
import os
import pathlib
import sys
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment(root: pathlib.Path) -> None:
    """Caches inside the checkout, and the program on the path."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


class Session:
    """The program set up for one cell and seed: weights, server, client,
    warmed up.  ``requests`` holds every request the server was given."""

    def __init__(self, cell, seed: int, device: str, spans: bool = False):
        import torch
        from repro_torch.configs.base import ModelConfig
        from repro_torch.env.serve_engine import ExpertServer

        from perfbench import client, weights

        self.cell, self.seed, self.device = cell, seed, device
        self.model = cell.config["model"]
        self.serve = cell.config["serve"]
        self.cfg = ModelConfig(**self.model)
        if torch.device(device).type == "cuda":
            self._build_kernels()
            self._init_blas(device)
        net, _ = weights.build(self.cfg, seed, device)
        self.leaves = weights.leaves(net)
        self.server = ExpertServer(self.cfg.name, self.cfg, net,
                                   slots=self.serve["slots"],
                                   max_len=self.serve["max_len"],
                                   eos_token=-1)
        record = torch.profiler.record_function if spans else None
        self.client = client.Client(self.server, self.serve["buckets"], record)
        self.requests = {}

    def _build_kernels(self) -> None:
        import concurrent.futures

        from repro_torch.kernels import build
        names = self.serve.get("kernels", [])
        with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
            list(pool.map(build.build, names))

    @staticmethod
    def _init_blas(device) -> None:
        """One small product in each type the steps multiply in: the
        server captures each step at its first call, and a cuBLAS handle
        cannot be created inside a capture."""
        import torch
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.ones((16, 16), dtype=dtype, device=device)
            (a @ a).sum().item()

    def request(self, rid, prompt, max_new, due=0.0):
        from repro_torch.env.serve_engine import Request
        req = Request(rid=rid, tokens=prompt, max_new=max_new,
                      submit_time=due)
        self.requests[rid] = req
        return req

    def warm_up(self, profiled: bool = False) -> None:
        """One request a prompt bucket, each long enough to decode, served
        to the end: every graph the window replays is captured here.  With
        ``profiled`` one more request is then served under the profiler,
        so that the traced window's start finds it initialised."""
        import numpy as np

        from perfbench import trace
        from perfbench.traffic import seed_bits

        rng = np.random.default_rng([seed_bits(self.seed), 3])
        buckets = self.serve["buckets"]
        for i, b in enumerate(buckets):
            prompt = rng.integers(0, self.model["vocab"], b).astype(np.int32)
            self.client.submit(self.request(-1 - i, prompt, 4))
        self.client.drain()
        if profiled:
            prompt = rng.integers(0, self.model["vocab"],
                                  buckets[0]).astype(np.int32)
            prof = trace.profiler()
            prof.start()
            self.client.submit(self.request(-1 - len(buckets), prompt, 4))
            self.client.drain()
            prof.stop()
        self.sync()

    def sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def window(self, rate: float, seconds: float, grace: float, seed: int,
               tracer=None):
        from perfbench import traffic
        planned = traffic.plan(self.cell.traffic, rate, seconds, seed,
                               self.model["vocab"])
        gc.collect()
        gc.freeze()
        try:
            return self.client.window(
                planned, seconds, grace,
                lambda p, due: self.request(p.rid, p.prompt, p.max_new, due),
                tracer)
        finally:
            gc.unfreeze()

    def close_server(self) -> None:
        """Free the program's server: its graphs, cache, buffers and the
        model with its weights."""
        import torch
        self.server._graphs.clear()
        self.server = self.client.server = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def served(self, win):
        """Every request the server was given, as ``check.Served``."""
        from perfbench.check import Served
        done = {id(s.req) for s in win.sent if win.done(s)}
        out = {}
        for rid, r in self.requests.items():
            ok = (id(r) in done) if rid >= 0 else r.finish_time is not None
            out[rid] = Served(rid, r.tokens, r.max_new, list(r.generated), ok)
        return out

    def judge(self, win, control: bool = False) -> dict:
        """The check's readings of this window's served tokens (``control``:
        as ``check.judge``), against weights drawn anew from the seed; call
        it after ``close_server``."""
        import torch

        from perfbench import check, spec, weights
        served = self.served(win)
        finished = [r for rid, r in served.items() if rid >= 0 and r.done]
        conf = self.cell.cell["check"]
        rids = check.sample(finished, self.seed, conf["sample_tokens"])
        out = {"short": sum(len(r.tokens) != r.max_new for r in finished),
               "sampled": len(rids)}
        if not rids:
            out.update(max_gap=float("nan"), mean_gap=float("nan"), judged=0,
                       unsettled=0)
            return out
        inp = check.inputs(self.model, self.serve["slots"], self.client.log,
                           served, rids)
        ref = spec.reference(self.cell.config)
        drawn = weights.draw(self.leaves, self.model["n_layers"], self.seed,
                             torch.device(self.device))
        out.update(check.judge(ref, self.model, self.serve, drawn, inp,
                               conf.get("route_margin", 0.0), self.device,
                               control))
        return out


def checks(readings: dict, limits: dict) -> dict:
    """Each number compared, with its limit and the sense of the test:
    the gaps the cell's file names (``check.limits``), no request
    answered short, and at least one token judged."""
    out = {name: {"value": readings[name], "limit": limit, "pass_if": "<="}
           for name, limit in limits.items()}
    out["short_answers"] = {"value": readings["short"], "limit": 0,
                            "pass_if": "<="}
    out["judged_tokens"] = {"value": readings["judged"], "limit": 1,
                            "pass_if": ">="}
    return out


def passes(c: dict) -> bool:
    v, lim = c["value"], c["limit"]
    if isinstance(v, float) and math.isnan(v):
        return False
    return v <= lim if c["pass_if"] == "<=" else v >= lim


def execute(cell, seed: int, seconds: float, traced: bool, device: str,
            t_start: Optional[float] = None) -> dict:
    """One run of ``cell``; returns the result's fields (``checks``
    last)."""
    import torch

    from perfbench import e2e, record, spec, trace

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    sess = Session(cell, seed, device, spans=traced)
    sess.warm_up(profiled=traced and on_card)
    setup_s = time.perf_counter() - t_start

    c = cell.cell
    tracer = None
    if traced:
        span = min(c["trace"]["seconds"], seconds)
        tracer = trace.Tracer(seconds - span, span)
    win = sess.window(c["rate"], seconds, c["grace_s"], seed, tracer)
    sess.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = len(win.sent)
    failed = sum(not win.done(s) for s in win.sent)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    extra = {}
    if traced:
        tr = tracer.read(win.iterations) if tracer.t1 is not None else None
        rec = record.Record(sess.model, sess.serve, win, sess.client.log, tr)
        metrics = spec.read_per_layer(cell.per_layer, rec)
        if tr is not None:
            device_info.update(busy_s=trace.busy(tr), window_s=tr.seconds)
            extra["breakdown"] = trace.breakdown(tr)
    else:
        values = e2e.metrics(win, cell.traffic["quality"],
                             cell.traffic["latency_limit_s"])
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    sess.close_server()
    readings = sess.judge(win)
    compared = checks(readings, c["check"]["limits"])
    out = {"correct": all(passes(v) for v in compared.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info, **extra,
           "readings": {k: readings[k] for k in ("max_gap", "mean_gap",
                                                  "judged", "unsettled",
                                                  "sampled")},
           "checks": compared}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(ROOT)
    from perfbench import spec
    try:
        cell = spec.load_cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (pass if {c['pass_if']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
