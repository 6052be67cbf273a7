"""The readings the check's limit is set from, for one cell, in one
process on the card: for each seed, a short window at the cell's own rate
(long enough to finish the mix's longest requests and to sample as many
tokens as a run does), then the check's readings of what the program
served (the lower reading is the largest over the seeds) and, for the
seeds named in ``--control``, of the control: the reference computed in
fp8 in the program's place (the upper reading is the smallest).  Each
line also carries the verdict of the cell's own check (``run.checks``
under the cell's limits) on the program (``correct``) and on the
control (``control_correct``), which has to come out false.  The
benchmark's own runs do not run this.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 --control 1,2 --seconds 10
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from perfbench import run


def verdict(readings: dict, limits: dict) -> bool:
    """Whether ``readings`` pass the check under ``limits``."""
    return all(run.passes(c) for c in run.checks(readings, limits).values())


def readings(cell, seed: int, seconds: float, device: str, control: bool
             ) -> dict:
    """The check's readings of one seed's short window, with the verdicts
    on the program and (with ``control``) on the control."""
    sess = run.Session(cell, seed, device)
    sess.warm_up()
    c = cell.cell
    win = sess.window(c["rate"], seconds, c["grace_s"], seed)
    sess.close_server()
    out = {"workload": cell.name, "seed": seed,
           "attempted": len(win.sent),
           "failed": sum(not win.done(s) for s in win.sent),
           **sess.judge(win, control)}
    limits = c["check"]["limits"]
    out["correct"] = verdict(out, limits)
    if control:
        out["control_correct"] = verdict(
            dict(out, max_gap=out["control_max_gap"],
                 mean_gap=out["control_mean_gap"], short=0), limits)
    del sess
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run._environment(run.ROOT)
    import torch

    from perfbench import spec
    cell = spec.load_cell(args.workload, run.ROOT)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    controls = set(ints(args.control))
    for seed in ints(args.seeds):
        line = readings(cell, seed, args.seconds, "cuda", seed in controls)
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
