"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix, cell and per-layer metric are added as files
and entries only, and a run of the new cell picks them up by name."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

from perfbench import tiny

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

METRIC = '''"""Tokens generated in the window (a metric added by a later change)."""


def read(rec):
    return float(sum(it.tokens for it in rec.window.in_window()))
'''

RUN = '''
import json, sys
import perfbench
from perfbench import run, spec
cell = spec.load_cell("tiny-dense.tiny_mix", run.ROOT)
out = run.execute(cell, 7, 1.0, True, "cpu")
print(json.dumps({"package": perfbench.__file__, "traffic": cell.traffic,
                  "model": cell.config["model"]["name"],
                  "metrics": out["metrics"], "correct": out["correct"]}))
'''


def test_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path).as_posix(): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    b = tmp_path / "perfbench"
    (b / "configs" / "tiny-dense.json").write_text(
        json.dumps(tiny.config("dense")))
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(tiny.TRAFFIC))
    (b / "cells" / "tiny-dense.tiny_mix.json").write_text(
        json.dumps(tiny.cell_file()))
    (b / "metrics" / "window_tokens.py").write_text(METRIC)
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "perfbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.tiny_mix",
                               "config": "tiny-dense", "traffic": "tiny_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "window_tokens", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine batching",
                               "moves": "tokens_per_s",
                               "workloads": ["tiny-dense.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["package"].startswith(str(tmp_path))
    assert got["model"] == "tiny-dense" and got["traffic"] == tiny.TRAFFIC
    assert got["metrics"]["window_tokens"]["value"] > 0
    # the metrics already there name the cells they read
    assert set(got["metrics"]) == {"window_tokens"}
    assert got["correct"]
    # every file the benchmark had is unchanged
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
