"""Wrapper of the lockstep-advance CUDA kernel (``csrc/lockstep_advance.cu``).

``lockstep_advance`` has ``engine.advance_shard``'s contract.  For CPU
tensors it runs that plain version (``ref.py``); for CUDA tensors it
launches the kernel on the current stream or raises: there is no fallback.
The library is built at the first CUDA call, never at import.

``LAUNCHES`` counts kernel launches (plain-version calls do not count), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env.engine import ADMIT_ORDERS, ACC_KEYS
from repro_torch.env.engine_layout import (
    PAR_CH, RUN_F_CH, RUN_I_CH, WAIT_F_CH, WAIT_I_CH,
)
from repro_torch.kernels import build
from repro_torch.kernels.lockstep_advance.ref import lockstep_advance_ref

NAME = "lockstep_advance"
MAX_SLOTS = 32
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.lockstep_advance_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lockstep_advance(run_i, run_f, wait_i, wait_f, par, clocks, t_next, *,
                     latency_L: float, admit_order: str = "fifo"):
    """(run_i (M,R,5) i32, run_f (M,R,5) f32, wait_i (M,W,4) i32,
    wait_f (M,W,4) f32, par (M,8) f32, clocks (M,) f32, t_next (M,) f32)
    -> (run_i, run_f, wait_valid (M,W) i32, clocks (M,), acc (M,6))."""
    global LAUNCHES
    if admit_order not in ADMIT_ORDERS:
        raise ValueError(f"unknown admit_order {admit_order!r}")
    if clocks.device.type == "cpu":
        return lockstep_advance_ref(run_i, run_f, wait_i, wait_f, par, clocks,
                                    t_next, latency_L=latency_L,
                                    admit_order=admit_order)
    if clocks.device.type != "cuda":
        raise ValueError(f"unsupported device {clocks.device}")
    m, r, _ = run_i.shape
    w = wait_i.shape[1]
    if not (1 <= r <= MAX_SLOTS and 1 <= w <= MAX_SLOTS):
        raise ValueError(f"run/wait widths ({r}, {w}) must lie in "
                         f"[1, {MAX_SLOTS}]")
    dev = clocks.device
    _check("run_i", run_i, torch.int32, (m, r, RUN_I_CH), dev)
    _check("run_f", run_f, torch.float32, (m, r, RUN_F_CH), dev)
    _check("wait_i", wait_i, torch.int32, (m, w, WAIT_I_CH), dev)
    _check("wait_f", wait_f, torch.float32, (m, w, WAIT_F_CH), dev)
    _check("par", par, torch.float32, (m, PAR_CH), dev)
    _check("clocks", clocks, torch.float32, (m,), dev)
    _check("t_next", t_next, torch.float32, (m,), dev)

    run_i_out = torch.empty_like(run_i)
    run_f_out = torch.empty_like(run_f)
    wvalid = torch.empty((m, w), dtype=torch.int32, device=dev)
    clocks_out = torch.empty_like(clocks)
    acc = torch.empty((m, len(ACC_KEYS)), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in (run_i, run_f, wait_i, wait_f, par,
                                        clocks, t_next, run_i_out, run_f_out,
                                        wvalid, clocks_out, acc)]
        rc = lib.lockstep_advance_launch(
            *ptrs, m, r, w, float(latency_L),
            ADMIT_ORDERS.index(admit_order), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return run_i_out, run_f_out, wvalid, clocks_out, acc
