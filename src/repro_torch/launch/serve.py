"""Serving launcher: a cluster of LM experts, each an ``ExpertServer``,
with a router in front (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        [--full-width] [--requests 30] [--rate 20] [--router sqf]

Builds one server per architecture (reduced configs unless
``--full-width``; random weights from a seed), profiles them to calibrate
(k1, k2), routes a Poisson request stream with the chosen policy and
reports the paper's metrics (avg QoS, latency per token) measured on the
engines' wall clock.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch import device as device_lib
from repro_torch.configs import get_config, reduce_config
from repro_torch.env import profiles
from repro_torch.env.serve_engine import ExpertServer, Request, calibrate
from repro_torch.models import model as model_lib

DEFAULT_EXPERTS = ["qwen1.5-0.5b", "h2o-danube-3-4b", "starcoder2-15b"]


def build_cluster(arch_names: List[str], seed: int = 0, slots: int = 4,
                  max_len: int = 192, reduce: bool = True,
                  device=None) -> List[ExpertServer]:
    """One server per architecture: ``reduce_config`` of it (the
    reference's only setting) or, with ``reduce=False``, its published
    widths in its own dtypes (bf16).  On ``device``, CUDA by default."""
    dev = device_lib.resolve(device)
    servers = []
    for i, name in enumerate(arch_names):
        cfg = get_config(name)
        if reduce:
            cfg = reduce_config(cfg)
        params = model_lib.init_params(cfg, seed=seed + i, device=dev)
        servers.append(ExpertServer(f"expert{i}:{name}", cfg, params,
                                    slots=slots, max_len=max_len))
    return servers


def profile_cluster(servers: List[ExpertServer], n_warm: int = 8) -> List[dict]:
    """Warm up (one request per prefill bucket; on CUDA this captures each
    bucket's prefill graph and the decode graph) and calibrate each
    expert's latency gradients (Eq. 13/14)."""
    rng = np.random.default_rng(0)
    fits = []
    for srv in servers:
        # one request per bucket first (warm-up), then randoms (measure)
        lens = [12, 30, 60, 120] + \
            [int(rng.integers(8, 120)) for _ in range(n_warm)]
        for j, p in enumerate(lens):
            srv.submit(Request(rid=1000 + j, max_new=6,
                               tokens=rng.integers(2, srv.cfg.vocab, p)))
            while srv.n_waiting:
                srv.step()
        while srv.has_work():
            srv.step()
        # drop the warm-up iterations, as the reference drops its compiles
        srv.iteration_log = srv.iteration_log[8:]
        fits.append(calibrate(srv))
        srv.iteration_log.clear()
    return fits


def run_stream(servers: List[ExpertServer], *, n_requests: int = 40,
               rate: float = 20.0, router: str = "sqf",
               latency_L: float = 1.0, seed: int = 0,
               policy_fn=None, finished: Optional[list] = None) -> dict:
    """Route a Poisson stream over the engines; iteration-level scheduling
    is driven by stepping every busy engine between arrivals.  ``latency_L``
    (s/token) defaults to the reference's 1 s, meant for CPU-hosted
    engines; the paper's is 0.030.  Adds the run's wall time and generated
    tokens per second to the reference's metrics.  ``finished``, when
    given, receives the finished requests."""
    rng = np.random.default_rng(seed)
    # quality profiles only, read on the host
    pool = profiles.make_pool(len(servers), seed=seed, device="cpu")
    quality = pool.quality_mean.numpy()
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    t0 = time.perf_counter()
    done: List[Request] = []
    i = 0
    rr_i = 0
    while i < n_requests or any(s.has_work() for s in servers):
        now = time.perf_counter() - t0
        if i < n_requests and now >= arrivals[i]:
            p = int(rng.integers(8, 120))
            ttype = int(rng.integers(0, pool.n_types))
            req = Request(rid=i, tokens=rng.integers(2, 250, p),
                          max_new=int(rng.integers(4, 24)))
            if policy_fn is not None:
                n = policy_fn(servers, req)
            elif router == "rr":
                n = rr_i % len(servers)
                rr_i += 1
            elif router == "sqf":
                n = int(np.argmin([s.n_running + s.n_waiting for s in servers]))
            else:
                n = int(rng.integers(0, len(servers)))
            req.ttype = ttype  # type: ignore[attr-defined]
            servers[n].submit(req)
            req.expert = n  # type: ignore[attr-defined]
            i += 1
            continue
        stepped = False
        for srv in servers:
            if srv.has_work():
                done.extend(srv.step())
                stepped = True
        if not stepped:
            time.sleep(0.001)
    seconds = time.perf_counter() - t0
    if finished is not None:
        finished.extend(done)

    qos, lats = [], []
    for r in done:
        lat = r.latency_per_token or 0.0
        score = float(quality[r.expert, r.ttype])  # type: ignore[attr-defined]
        qos.append(score * (lat <= latency_L))
        lats.append(lat)
    generated = sum(len(r.generated) for r in done)
    return {
        "completed": len(done),
        "avg_qos": float(np.mean(qos)) if qos else 0.0,
        "avg_latency_per_token_ms": float(np.mean(lats)) * 1e3 if lats else 0.0,
        "p95_latency_per_token_ms": float(np.percentile(lats, 95)) * 1e3 if lats else 0.0,
        "seconds": seconds,
        "generated_tokens": generated,
        "tokens_per_s": generated / seconds,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--experts", nargs="*", default=DEFAULT_EXPERTS)
    p.add_argument("--requests", type=int, default=30)
    p.add_argument("--rate", type=float, default=20.0)
    p.add_argument("--router", default="sqf", choices=["rr", "sqf", "random"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--full-width", action="store_true",
                   help="the architectures' published widths, not reduce_config")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    print(f"[serve] building cluster: {args.experts}")
    servers = build_cluster(args.experts, reduce=not args.full_width,
                            device=args.device)
    fits = profile_cluster(servers)
    for srv, fit in zip(servers, fits):
        print(f"[serve] {srv.name}: k1={fit['k1']*1e3:.3f} ms/tok "
              f"k2={fit['k2']*1e6:.1f} us/tok (n={fit['n_prefill']}/{fit['n_decode']})")
    m = run_stream(servers, n_requests=args.requests, rate=args.rate,
                   router=args.router)
    print(f"[serve] router={args.router} -> {m}")
    return m


if __name__ == "__main__":
    main()
