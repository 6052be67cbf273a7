"""Wrappers of the grouped expert GEMM CUDA kernels (``csrc/moe_gemm.cu``).

``expert_gemm`` (B4a) and ``expert_swiglu`` (B4b) have the contracts of
``ref.grouped_gemm_ref`` and ``ref.grouped_swiglu_ref``.  For CPU tensors
they run those plain versions; for CUDA tensors they launch the kernel on
the current stream or raise: there is no fallback.  The library is built
at the first CUDA call, never at import.

The reference's ``block_c``/``block_f``/``block_d`` are the TPU kernel's
VMEM tiling and its ``use_pallas`` picks the plain version; neither changes
the function, so the port takes neither.  The CUDA kernel takes any C, F
and D (the serving capacities are 4, 5, 10, 20 and 40).

``GEMM_LAUNCHES`` and ``SWIGLU_LAUNCHES`` count each wrapper's kernel
launches (plain-version calls do not count), so a run can show that its
main path went through them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref, grouped_swiglu_ref

NAME = "moe_gemm"
GEMM_LAUNCHES = 0
SWIGLU_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.moe_gemm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


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


def _launch(x, w, w_up):
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.moe_gemm_launch(
            x.data_ptr(), w.data_ptr(),
            None if w_up is None else w_up.data_ptr(), out.data_ptr(),
            e, c, d, f, int(w_up is not None), int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    return out


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w (E, D, F) -> (E, C, F) in x's dtype, float32 or
    bfloat16, float32 accumulation (B4a)."""
    global GEMM_LAUNCHES
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w)
    out = _launch(x, w, None)
    GEMM_LAUNCHES += 1
    return out


def expert_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w_gate, w_up (E, D, F) -> silu(x@wg) * (x@wu), (E, C, F)
    in x's dtype; both products stay in float32 until the one rounding
    (B4b)."""
    global SWIGLU_LAUNCHES
    if x.device.type == "cpu":
        return grouped_swiglu_ref(x, w_gate, w_up)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w_gate, w_up)
    out = _launch(x, w_gate, w_up)
    SWIGLU_LAUNCHES += 1
    return out
