"""The knee sweep of a cell: one set-up, then the cell's traffic offered
open loop at each of a list of rates, a window each, and one line of
figures per rate.  The knee is the highest rate the server sustains
without a growing backlog: there the first-token wait of the window's
last third of requests stays near that of its first third, and the
server drains what is in flight soon after the window closes.  The cell's
rate (``cells/<name>.json``) is set once from it.

    python3 -m perfbench.sweep --workload <cell> --seed <n> --seconds <s> --rates 6,7,8
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from perfbench import run


def figures(win, quality, limit_s) -> dict:
    from perfbench import e2e
    rows = e2e.per_request(win)
    ttft = np.array([r["ttft"] for r in rows])
    third = max(1, len(rows) // 3)
    last = max((s.req.finish_time for s in win.sent
                if s.req is not None and s.req.finish_time is not None),
               default=win.t_close)
    out = e2e.metrics(win, quality, limit_s)
    out.update(offered=len(rows), failed=int(sum(not r["done"] for r in rows)),
               ttft_first_third_ms=float(np.mean(ttft[:third])) * 1e3,
               ttft_last_third_ms=float(np.mean(ttft[-third:])) * 1e3,
               drain_s=last - win.t_close,
               decode_rows=float(np.mean([it.rows for it in win.in_window()
                                          if it.kind == "decode"] or [0])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run._environment(run.ROOT)
    from perfbench import spec
    cell = spec.load_cell(args.workload, run.ROOT)
    sess = run.Session(cell, args.seed, "cuda")
    sess.warm_up()
    for rate in (float(r) for r in args.rates.split(",")):
        win = sess.window(rate, args.seconds, cell.cell["grace_s"], args.seed)
        line = {"workload": args.workload, "rate": rate,
                **figures(win, cell.traffic["quality"],
                          cell.traffic["latency_limit_s"])}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
