"""On the card: one short run of each cell through the command the
benchmark names, which must print a correct result line with the cell's
end-to-end metrics.  Skips without a card (decided in the fixture)."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_is_correct(card, cell):
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", cell,
           "--seed", "424242", "--seconds", "4", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
