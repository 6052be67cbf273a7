"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  At first
use it is compiled by ``nvcc`` into a shared library under
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source and the flags, and loaded with ``ctypes``.  Nothing is built when
this module is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         [kernel flags] -shared -Xcompiler -fPIC -o <lib> <source>

Flags differ per kernel (``KERNEL_FLAGS``).  The lockstep-advance kernel
takes ``--fmad=false``, which keeps nvcc from contracting multiply-adds on
its own: it writes ``__fmaf_rn`` exactly where the reference contracts, and
must be bit-exact.  Flash attention, decode attention, the grouped
expert GEMMs and the two recurrent scans are held to a tolerance and keep
nvcc's default contraction (without it every multiply-add is two
instructions).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNEL_FLAGS = {"lockstep_advance": ("--fmad=false",), "flash_attn": (),
                "decode_attn": (), "moe_gemm": (), "rwkv6_scan": (),
                "rglru_scan": ()}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and under "
                           "$CUDA_HOME/bin); the CUDA kernels cannot be built")
    return path


def flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile kernel ``name`` unless it is built already; returns the
    library's path.  Raises with nvcc's output on failure."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.stem}.{os.getpid()}.so")
    proc = subprocess.run(
        [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: a reader never sees a partial library
    return path


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel at the same time, one nvcc each; returns their
    libraries' paths.  Raises as ``build`` does."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_FLAGS)) as pool:
        return dict(zip(KERNEL_FLAGS, pool.map(build, KERNEL_FLAGS)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
