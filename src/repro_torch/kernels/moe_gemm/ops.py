"""Wrappers of the grouped expert GEMM CUDA kernels (``csrc/moe_gemm.cu``).

``expert_gemm`` (B4a) and ``expert_swiglu`` (B4b) have the contracts of
``ref.grouped_gemm_ref`` and ``ref.grouped_swiglu_ref``.  For CPU tensors
they run those plain versions; for CUDA tensors they launch the kernel on
the current stream or raise: there is no fallback.  The library is built
at the first CUDA call, never at import.

The reference's ``block_c``/``block_f``/``block_d`` are the TPU kernel's
VMEM tiling and its ``use_pallas`` picks the plain version; neither changes
the function, so the port takes neither.  The CUDA kernels take any C, F
and D (the serving capacities are 4, 5, 10, 20 and 40).  In bfloat16 with
D and F multiples of 8, B4a runs its persistent kernel over the split
``ref.gemm_plan`` gives for the card's SM count (the wrapper passes the
plan's CTA count and whether it cuts a tile; the kernel derives nothing of
it), with a float32 workspace for the tiles the split cuts (merged by a
second launch, in a fixed order).

``GEMM_LAUNCHES`` and ``SWIGLU_LAUNCHES`` count each wrapper's kernel
launches (plain-version calls do not count; B4a's merge launch is part of
its call), so a run can show that its main path went through them.

On the meta device (``launch/dryrun.py``) each wrapper checks its operands
as for the card and returns the kernel's empty output, computing and
launching nothing.  Under a ``launch.cost_analysis.CostCounter`` a call
on any device counts ``gemm_work`` or ``swiglu_work``: the products, the
gate's sigmoid and product, x and the weights read and the output written
once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm.ref import (TILE_N, gemm_plan, gemm_tiled,
                                              grouped_gemm_ref,
                                              grouped_swiglu_ref)
from repro_torch.launch.cost_analysis import counted

NAME = "moe_gemm"
GEMM_LAUNCHES = 0
SWIGLU_LAUNCHES = 0

# moe_gemm_launch: four pointers, six ints, the stream; grouped_gemm_launch
# takes seven ints
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_GEMM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    for fn, types in ((lib.moe_gemm_launch, _ARGTYPES),
                      (lib.grouped_gemm_launch, _GEMM_ARGTYPES)):
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _split(e: int, c: int, k: int, n: int, n_sm: int):
    """What the kernel takes of ``gemm_plan``: (CTAs, workspace slot rows,
    whether a tile is cut and merged)."""
    plan = gemm_plan(e, c, k, n, n_sm)
    return plan.ctas, plan.rows, bool(plan.merges())


def _check(x, *ws):
    if x.dim() != 3:
        raise ValueError(f"expected x (E,C,D), got {tuple(x.shape)}")
    e, _, d = x.shape
    for w in ws:
        if w.dim() != 3 or w.shape[0] != e or w.shape[1] != d:
            raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)}")
        if w.shape != ws[0].shape:
            raise ValueError(f"w_gate {tuple(ws[0].shape)} and w_up "
                             f"{tuple(w.shape)} differ")
    for name, t in (("x", x),) + tuple((f"w{i}", w) for i, w in enumerate(ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; x and the weights "
                            f"must share one of {_DTYPES}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def gemm_work(x, w) -> dict:
    """B4a's work on these operands (module docstring)."""
    e, c, d = x.shape
    f = w.shape[2]
    return {"flops": 2 * e * c * d * f,
            "bytes": (e * c * d + e * d * f + e * c * f) * x.element_size()}


def swiglu_work(x, w_gate, w_up) -> dict:
    """B4b's work on these operands (module docstring)."""
    e, c, d = x.shape
    f = w_gate.shape[2]
    return {"flops": 4 * e * c * d * f, "elementwise_flops": 3 * e * c * f,
            "transcendentals": e * c * f,
            "bytes": (e * c * d + 2 * e * d * f + e * c * f)
            * x.element_size()}


def _launch_swiglu(x, w, w_up):
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.moe_gemm_launch(
            x.data_ptr(), w.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            e, c, d, f, 1, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    return out


@counted("moe_gemm.grouped_gemm", gemm_work)
def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w (E, D, F) -> (E, C, F) in x's dtype, float32 or
    bfloat16, float32 accumulation (B4a)."""
    global GEMM_LAUNCHES
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        return out
    ws, ctas, merge = None, 0, False
    if gemm_tiled(x.dtype, d, f):
        ctas, rows, merge = _split(e, c, d, f, sm_count(x.device))
        ws = torch.empty(2 * ctas * rows * TILE_N, dtype=torch.float32,
                         device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.grouped_gemm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), e, c, d, f,
            int(x.dtype == torch.bfloat16), ctas, int(merge), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    GEMM_LAUNCHES += 1
    return out


@counted("moe_gemm.grouped_swiglu", swiglu_work)
def expert_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w_gate, w_up (E, D, F) -> silu(x@wg) * (x@wu), (E, C, F)
    in x's dtype; both products stay in float32 until the one rounding
    (B4b)."""
    global SWIGLU_LAUNCHES
    if x.device.type == "cpu":
        return grouped_swiglu_ref(x, w_gate, w_up)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w_gate, w_up)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], x.shape[1], w_gate.shape[2]),
                           dtype=x.dtype, device=x.device)
    out = _launch_swiglu(x, w_gate, w_up)
    SWIGLU_LAUNCHES += 1
    return out
