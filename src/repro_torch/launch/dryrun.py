"""Dry run of every (architecture x input-shape) cell on the production
meshes (the port's counterpart of ``repro/launch/dryrun.py``): one rank's
step, built from the spec functions of ``launch/steps.py`` and run on the
meta device, which computes nothing, under ``launch.cost_analysis``'s
counter; the record holds the memory, cost and collective figures.

Run it as a fresh process, on the CPU (it needs no card and touches
none)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch <id>] [--shape <s>] [--multi-pod] [--out <dir>]

The reference forces 512 host devices (``--xla_force_host_platform_
device_count=512``); here the process starts a world of 512 ranks whose
process group is ``torch.distributed``'s fake backend (from
``torch.testing._internal``): this process is rank 0, and every
collective returns at once on meta tensors.  The 16 x 16 mesh takes the
first 256 ranks, as the reference's takes the first 256 devices.  That
world must be the process's only default group: a process already in
another world is refused.

``run_cell`` writes the reference's record: ``ok``, ``arch``, ``shape``,
``mesh``, ``n_devices``, ``overrides``; ``memory`` (``argument_bytes``:
the rank's parameter blocks, optimizer state and batch, or blocks,
cache and tokens; ``output_bytes``: what the step made that outlives it;
``temp_bytes``: the most the step holds above its arguments, outputs
included, so that ``argument_bytes + temp_bytes`` is the rank's peak);
``cost_analysis`` (``flops``, contractions and elementwise alike, as
XLA's counts them, ``bytes_accessed``, ``transcendentals``) and
``hlo_totals`` (``CostTotals.as_dict``) from the counter;
``collective_bytes_by_reader`` (``distributed.collectives.BYTES`` over
the step); ``top_buffers`` (the largest tensors, 0.1 GB or more); and on
a failure ``error`` and ``traceback``, which it records and does not
raise.  The main function sweeps ``list_archs()`` x ``supported_shapes``,
writes one JSON per cell under ``--out`` and exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, supported_shapes
from repro_torch.distributed import collectives
from repro_torch.launch import cost_analysis, steps
from repro_torch.launch.mesh import make_production_mesh

WORLD = 512          # the larger production mesh's ranks


def init_fake_world() -> None:
    """Start the fake world of ``WORLD`` ranks, this process rank 0; a
    no-op when it runs already.  Raises in a process that runs another
    default group."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != WORLD:
            raise RuntimeError(
                "the dry run starts a fake world of its own and must be the "
                f"process's only default group; this one runs "
                f"{dist.get_backend()} over {dist.get_world_size()} ranks: "
                "run the dry run as a fresh process")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


def _file(out_dir: str, arch: str, shape_name: str, mesh_name: str) -> str:
    return os.path.join(out_dir, f"{arch.replace('.', '_')}__{shape_name}__"
                                 f"{mesh_name}.json")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, overrides: dict | None = None) -> dict:
    """One cell's record (module docstring), written to ``out_dir`` when
    given."""
    init_fake_world()
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": mesh.size(), "ok": False,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    t0 = time.time()
    try:
        fn, args = steps.make_step(cfg, shape_name, mesh)
        t1 = time.time()
        before = dict(collectives.BYTES)
        with cost_analysis.CostCounter(steps.arg_tensors(args)) as counter:
            out = fn(*args)
        t2 = time.time()
        tot = counter.totals
        by_reader = {k: v - before.get(k, 0)
                     for k, v in collectives.BYTES.items()
                     if v != before.get(k, 0)}
        record.update({
            "ok": True,
            "build_s": round(t1 - t0, 2),
            "run_s": round(t2 - t1, 2),
            "memory": {
                "argument_bytes": counter.argument_bytes,
                "output_bytes": counter.live_bytes,
                "temp_bytes": counter.peak_bytes,
            },
            "cost_analysis": {
                "flops": tot.flops + tot.elementwise_flops,
                "bytes_accessed": tot.memory_bytes,
                "transcendentals": tot.transcendentals,
            },
            "hlo_totals": tot.as_dict(),
            "collective_bytes_by_reader": by_reader,
            "top_buffers": counter.top(),
        })
        del out
        mem = record["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"run={t2 - t1:.1f}s flops/dev={tot.flops:.3e} "
              f"coll_wire/dev={tot.collective_wire_bytes:.3e}B")
        print(f"  memory: args={mem['argument_bytes']} "
              f"temp={mem['temp_bytes']} out={mem['output_bytes']}")
    except Exception as e:  # noqa: BLE001 - record the failure, go on sweeping
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL "
              f"{record['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_file(out_dir, arch, shape_name, mesh_name), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="architecture id (default: all)")
    p.add_argument("--shape", default=None,
                   help="shape cell (default: all supported)")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else list(list_archs())
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else list(supported_shapes(cfg))
        for shape in shapes:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           out_dir=args.out)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
