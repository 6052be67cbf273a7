"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. env     — the card (name and power limit, from nvidia-smi), the torch,
               CUDA and nvcc versions, and the time to build the kernels
               from ``src/repro_torch/csrc``.
  2. kernel  — every kernel against its plain PyTorch version on the card:
               the lockstep-advance kernel at 16 envs x 1,024 experts
               (16,384 rows, R=W=5) over 100 consecutive advances per
               admission order, with arrivals pushed between advances,
               ragged caps, about 1/8 of experts down, admission floors on
               some rows and a t_next per env.  Queues, clocks and
               wait-valid bits must be bit-exact, done/viol exact, the
               other accumulators within rtol 1e-6.  Times both.
  3. serve   — the main path, ``launch/route.py``'s policies through
               ``engine_backend="cuda"``: N=6 with 4 envs (padded obs) and
               N=1,024 with 16 envs (segments obs, ragged caps); RR, SQF, BR,
               QLL and a seeded SAC router, greedy.  Each run must launch
               the kernel once per env step; a shorter QLL run on the plain
               engine must end in the same state as on the kernel.
  4. profile — for QLL and SAC in each setting: host time per layer of a
               step, and the device's busy share under torch.profiler.
  5. kernels — the kernel table line.

The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without
a result when CUDA is unavailable or the package is missing.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def lockstep_ops(rows, r, w, turns, done) -> int:
    """Scalar operations the lockstep-advance kernel does on these inputs,
    counted from its body (``csrc/lockstep_advance.cu``): per row, the wait
    side's keys and masks (~6 per wait slot) and the first work test (~1 per
    run slot); per row turn, the run-slot scan (~3 per slot), the waiter
    pick (~2 per slot), the memory check and the choice (~10), the decode's
    slot updates (~3 per slot) or the admit's clock (2), and the closing
    work test (~1 per slot, +2); per finished request, its latency, QoS test
    and six accumulator adds (~10).  ``turns`` and ``done`` are this input's
    own (``engine.advance_shard(counts=...)`` and the ``done`` sums)."""
    per_turn = 3 * r + 2 * w + 10 + 3 * r + r + 2
    return rows * (6 * w + r) + turns * per_turn + 10 * done


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 2: the lockstep-advance kernel against its plain version
# ---------------------------------------------------------------------------


def bulk_arrivals(layout, q, rng, t, wait_caps, p_arrive, dev):
    """Push one request into each (env, expert) picked with probability
    ``p_arrive``, in its first free in-cap wait slot (full queues drop)."""
    b, n, w, _ = q["wait_i"].shape
    pick = torch.as_tensor(rng.uniform(size=(b, n)) < p_arrive, device=dev)
    free = (q["wait_i"][..., 0] == 0) & layout.slot_valid(wait_caps, w)
    slot = torch.argmax(free.to(torch.uint8), dim=-1)
    do = pick & free.any(-1)
    shape = (b, n)
    new_i = torch.stack([
        torch.ones(shape, dtype=torch.int32, device=dev),
        torch.as_tensor(rng.integers(16, 512, shape), dtype=torch.int32,
                        device=dev),
        torch.as_tensor(rng.integers(8, 300, shape), dtype=torch.int32,
                        device=dev),
        torch.zeros(shape, dtype=torch.int32, device=dev)], -1)
    new_f = torch.stack([
        torch.as_tensor(rng.uniform(0.2, 0.95, shape), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(rng.uniform(0.2, 0.95, shape), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(rng.uniform(8, 300, shape), dtype=torch.float32,
                        device=dev),
        t[:, None].expand(shape)], -1)
    onehot = do[..., None] & (torch.arange(w, device=dev) == slot[..., None])
    q = dict(q)
    q["wait_i"] = torch.where(onehot[..., None], new_i[:, :, None, :],
                              q["wait_i"])
    q["wait_f"] = torch.where(onehot[..., None], new_f[:, :, None, :],
                              q["wait_f"])
    return q


def kernel_phase(dev, n_envs=16, n=1024, steps=100):
    from repro_torch.env import engine, engine_layout as layout, profiles
    from repro_torch.kernels.lockstep_advance import ops

    r, w, lat_l = 5, 5, 0.030
    pool = profiles.make_pool(n, device=dev)
    run_caps, wait_caps = profiles.memory_caps(pool, r, w)
    wait_caps_t = torch.as_tensor(wait_caps, device=dev)
    rng = np.random.default_rng(0)
    up = torch.as_tensor(rng.uniform(size=(n_envs, n)) >= 0.125, device=dev)
    floor = rng.uniform(0.3, 0.8, (n_envs, n)).astype(np.float32)
    floor[rng.uniform(size=(n_envs, n)) >= 0.1] = -1e30
    admit_min = torch.as_tensor(floor, device=dev)
    par = engine.pool_params(pool, run_caps, wait_caps, up, None,
                             admit_min).reshape(-1, layout.PAR_CH)
    rows = n_envs * n
    max_err, final, timing = 0.0, {}, None
    launches0 = ops.LAUNCHES
    for order in engine.ADMIT_ORDERS:
        rng = np.random.default_rng(1)
        q = layout.empty_queues(n, r, w, batch=n_envs, device=dev)
        clocks = torch.zeros((n_envs, n), device=dev)
        t = torch.zeros(n_envs, device=dev)
        for k in range(steps):
            # ~0.8 arrivals/s per expert (the paper's λ=5 over 6 experts)
            q = bulk_arrivals(layout, q, rng, t, wait_caps_t, 0.16, dev)
            t = t + torch.as_tensor(rng.exponential(0.2, n_envs),
                                    dtype=torch.float32, device=dev)
            args = (q["run_i"].reshape(rows, r, 5), q["run_f"].reshape(rows, r, 5),
                    q["wait_i"].reshape(rows, w, 4), q["wait_f"].reshape(rows, w, 4),
                    par, clocks.reshape(rows),
                    t[:, None].expand(n_envs, n).reshape(rows).contiguous())
            args = tuple(a.contiguous() for a in args)
            got = ops.lockstep_advance(*args, latency_L=lat_l,
                                       admit_order=order)
            counts = {}
            ref = engine.advance_shard(*args, latency_L=lat_l,
                                       admit_order=order, counts=counts)
            torch.cuda.synchronize()
            for name, a, b in zip(("run_i", "run_f", "wait_valid", "clocks"),
                                  got[:4], ref[:4]):
                if not torch.equal(a, b):
                    bad = int((a != b).sum())
                    raise AssertionError(f"{order} step {k}: {name} differs "
                                         f"from the plain version in {bad} "
                                         f"elements")
            for i, key in enumerate(engine.ACC_KEYS):
                a, b = got[4][:, i], ref[4][:, i]
                if key in ("done", "viol"):
                    assert torch.equal(a, b), (order, k, key)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
                max_err = max(max_err, float((a - b).abs().max()))
            if k == steps // 2 and order == "fifo":
                done = int(ref[4][:, engine.ACC_KEYS.index("done")].sum())
                timing = (args, counts["turns"], done)
            run_i, run_f, wvalid, clocks, _ = got
            wait_i = q["wait_i"].clone()
            wait_i[..., 0] = wvalid.reshape(n_envs, n, w)
            q = {"run_i": run_i.reshape(n_envs, n, r, 5),
                 "run_f": run_f.reshape(n_envs, n, r, 5),
                 "wait_i": wait_i, "wait_f": q["wait_f"]}
            clocks = clocks.reshape(n_envs, n)
        final[order] = {"min_clock": float(clocks.min()),
                        "running": int(q["run_i"][..., 0].sum()),
                        "waiting": int(q["wait_i"][..., 0].sum())}
        assert final[order]["running"] > 0, order

    args, turns, done = timing
    compared = ops.LAUNCHES - launches0
    ms = cuda_ms(lambda: ops.lockstep_advance(*args, latency_L=lat_l,
                                              admit_order="fifo"), 50)
    plain_ms = cuda_ms(lambda: engine.advance_shard(
        *args, latency_L=lat_l, admit_order="fifo"), 5)
    out_bytes = sum(x.numel() * x.element_size() for x in args)
    out_bytes += rows * (r * 5 * 4 * 2 + w * 4 + 4 + 6 * 4)
    bytes_ms = out_bytes / HBM_BYTES_PER_S * 1e3
    n_ops = lockstep_ops(rows, r, w, turns, done)
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    row = {"phase": "kernel", "name": "lockstep_advance", "rows": rows,
           "R": r, "W": w, "advances_per_order": steps,
           "orders": list(engine.ADMIT_ORDERS), "bit_exact": True,
           "launches_compared": compared, "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms,
           "bytes": out_bytes, "turns": turns, "finished": done,
           "ops": n_ops, "bytes_ms": bytes_ms,
           "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "final_state": final}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Phase 3: serve requests through the main path
# ---------------------------------------------------------------------------


def serve_phase(dev, n_experts, n_envs, n_steps, n_check, obs_fmt, ragged,
                seed):
    from repro_torch.core import sac
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(n_experts, ragged_caps=ragged,
                                   backend="cuda", device=dev)
    model = sac.init_params(route.sac_config(env_cfg), seed=seed, device=dev)
    rows, launches = [], 0
    for pol in route.make_policies(env_cfg, model, obs_fmt=obs_fmt):
        ops.LAUNCHES = 0
        m, state = route.serve(env_cfg, pool, pol, n_steps=n_steps,
                               n_envs=n_envs)
        got = ops.LAUNCHES
        assert got == n_steps, (pol.name, got, n_steps)
        launches += got
        for k in ("avg_qos", "avg_latency_per_token", "violation_rate",
                  "mean_reward"):
            assert np.isfinite(m[k]), (pol.name, k, m[k])
        assert 0.0 <= m["avg_qos"] <= 1.0, m
        # a SAC router with random weights may drop everything
        assert m["completed"] > 0 or pol.name == "SAC", m
        assert tuple(state["expert_clock"].shape) == (n_envs, n_experts)
        assert bool((state["expert_clock"] >= state["clock"][:, None]).all())
        row = {"phase": "serve", "n_experts": n_experts, "n_envs": n_envs,
               "obs_fmt": obs_fmt, "ragged_caps": ragged, "backend": "cuda",
               "launches": got,
               **{k: m[k] for k in ("policy", "requests", "seconds",
                                    "requests_per_s", "avg_qos",
                                    "avg_latency_per_token",
                                    "violation_rate", "completed",
                                    "dropped")}}
        emit(row)
        rows.append((row, state))

    # the same heuristic on the plain engine must end in the same state
    qll = lambda cfg: next(p for p in route.make_policies(cfg)
                           if p.name == "QLL")
    plain_cfg = dataclasses.replace(env_cfg, engine_backend="torch")
    m_cuda, s_cuda = route.serve(env_cfg, pool, qll(env_cfg), n_steps=n_check,
                                 n_envs=n_envs)
    ops.LAUNCHES = 0
    m, state = route.serve(plain_cfg, pool, qll(plain_cfg), n_steps=n_check,
                           n_envs=n_envs)
    assert ops.LAUNCHES == 0
    assert m["completed"] == m_cuda["completed"], (m, m_cuda)
    assert m["dropped"] == m_cuda["dropped"], (m, m_cuda)
    assert torch.equal(state["expert_clock"], s_cuda["expert_clock"])
    for k in state["queues"]:
        assert torch.equal(state["queues"][k], s_cuda["queues"][k]), k
    emit({"phase": "serve", "n_experts": n_experts, "n_envs": n_envs,
          "obs_fmt": obs_fmt, "ragged_caps": ragged, "policy": "QLL",
          "requests": m["requests"], "same_final_state": True,
          "requests_per_s": {"cuda": m_cuda["requests_per_s"],
                             "torch": m["requests_per_s"]}})

    for pol in route.make_policies(env_cfg, model, obs_fmt=obs_fmt):
        if pol.name not in ("QLL", "SAC"):
            continue
        emit({"phase": "profile", "n_experts": n_experts, "n_envs": n_envs,
              "obs_fmt": obs_fmt, "policy": pol.name,
              **profile_window(env_cfg, pool, pol, n_envs)})
    return launches


def profile_window(env_cfg, pool, policy, n_envs, steps=30):
    """Where a serving step's time goes: host wall time per layer (each
    synchronised), then one unsynchronised window under ``torch.profiler``
    for the device's busy time, its kernel launches and the lockstep
    kernel's share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import features
    from repro_torch.device import generator
    from repro_torch.env import env as env_lib

    dev = pool.k1.device
    state = env_lib.reset(env_cfg, pool, generator(dev, 7), n_envs)
    pstate = policy.init_state(n_envs, dev)
    act_gen = generator(dev, 8)

    def one_step(state, pstate, layer_s=None):
        marks = [time.perf_counter()]
        obs = (None if policy.obs_fmt is None else features.build_obs(
            env_cfg, pool, state, fmt=policy.obs_fmt))
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        a, pstate = policy.act(pstate, state, obs, act_gen)
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        state, _, _ = env_lib.step(env_cfg, pool, state, a)
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for i, k in enumerate(("obs", "policy", "env_step")):
                layer_s[k] += marks[i + 1] - marks[i]
        return state, pstate

    for _ in range(3):                                   # warm up
        state, pstate = one_step(state, pstate)
    layer_s = {"obs": 0.0, "policy": 0.0, "env_step": 0.0}
    for _ in range(steps):
        state, pstate = one_step(state, pstate, layer_s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, pstate = one_step(state, pstate)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    lock_us = sum(e.time_range.elapsed_us() for e in kernels
                  if "lockstep_advance" in e.name)
    per = lambda x: x / steps * 1e3
    return {"steps": steps,
            "ms_per_step_synced": {k: per(v) for k, v in layer_s.items()},
            "ms_per_step_profiled": per(wall_s),
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": (1.0 - busy_us / 1e6 / wall_s
                                  if kernels else None),
            "kernels_per_step": len(kernels) / steps,
            "lockstep_ms_per_step": lock_us / steps / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    t0 = time.perf_counter()
    build.build("lockstep_advance")
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit({"phase": "env", "gpu": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc": nvcc.strip().splitlines()[-1], "build_s": build_s,
          "device_count": torch.cuda.device_count()})

    kernel = kernel_phase(dev)
    launches = serve_phase(dev, 6, 4, 750, 150, "padded", False, seed=0)
    launches += serve_phase(dev, 1024, 16, 200, 100, "segments", True,
                            seed=0)

    emit({"kernels": [{
        "name": "lockstep_advance", "route": "cuda",
        "source": "src/repro_torch/csrc/lockstep_advance.cu",
        "replaces": "src/repro/kernels/lockstep_advance/kernel.py:223",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
