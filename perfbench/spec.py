"""Everything a run reads from data: ``BENCHMARK.json`` and the files that
its names lead to.  A configuration, a traffic mix, a cell and a per-layer
metric are each found by name, so adding one is adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # perfbench/configs/<config>.json
    traffic: dict         # perfbench/traffic/<traffic>.json
    cell: dict            # perfbench/cells/<name>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path, bench_dir: pathlib.Path = HERE
              ) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files; raises
    ``KeyError`` for a name the benchmark does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    return Cell(
        name=name, config=config,
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        cell=load_json(bench_dir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        chips=int(w["chips"]))


def reference(config: dict):
    """The plain reference the configuration names
    (``perfbench/references/<name>.py``)."""
    return importlib.import_module(f"perfbench.references.{config['reference']}")


def metric_reader(name: str, bench_dir: pathlib.Path = HERE
                  ) -> Callable[[object], Optional[float]]:
    """``read`` of ``perfbench/metrics/<name>.py``: a function of the run's
    record that returns the metric's value, or None where the run holds
    nothing for it to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(metrics: List[dict], record, bench_dir: pathlib.Path = HERE
                   ) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
