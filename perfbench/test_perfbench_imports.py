"""Nothing the benchmark runs imports JAX, flax or the JAX package
(``repro``), compared by whole top-level name (``repro_torch`` is the
program, not ``repro``); the plain reference imports nothing of the
program either."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

from perfbench import run

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if not p.name.startswith("test_"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py")) + [HERE / "history.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "dataclasses", "math", "typing",
                              "numpy", "torch"}


def test_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "reproduce", "numpy"]) == []
    assert run.forbidden_modules(["repro", "repro.env.engine", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.env.engine"]


def test_loaded_modules_of_a_run_and_of_the_reference():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import perfbench.references.transformer, perfbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "from perfbench import run, control, sweep, spec, weights; "
            "import repro_torch.env.serve_engine; "
            "print(run.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.strip().splitlines()
    loaded = set(eval(first))
    assert not loaded & (JAX | {"repro_torch"})
    assert second == "[]"
