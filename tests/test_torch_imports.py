"""The port stands alone: every ``repro_torch`` module, ``chip_smoke.py``
and ``examples/serve_cluster_torch.py`` import with ``jax`` and the
reference package ``repro`` blocked, and importing builds nothing and
starts no process group."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.distributed.api" in names, names
    for name in names:
        importlib.import_module(name)
    import importlib.util
    for path in sys.argv[1:]:            # files beside the package
        spec = importlib.util.spec_from_file_location("standalone", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from repro_torch.kernels import build
    assert build._LOADED == {}, build._LOADED
    import torch.distributed as dist
    assert not dist.is_initialized()          # no process group started
    print(len(names))
""")


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    files = [os.path.abspath(os.path.join(ROOT, f)) for f in
             ("chip_smoke.py", "examples/serve_cluster_torch.py")]
    out = subprocess.run([sys.executable, "-c", SCRIPT, *files], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was walked
