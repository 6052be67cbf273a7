"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attn.cu``).

``flash_attn`` has ``ref.attention_ref``'s contract.  For CPU tensors it
runs that plain version; for CUDA tensors it launches the kernel on the
current stream or raises: there is no fallback.  The library is built at
the first CUDA call, never at import.

q, k and v may be strided views with the head dimension contiguous: the
model holds v as (B, S, KV, dh) and hands over ``v.transpose(1, 2)`` with
no copy.  Every other stride must be a multiple of 16 bytes (8 elements in
bfloat16, 4 in float32), which the bf16 path's TMA copies need.  The
output is allocated as (B, Sq, H, dh) and returned as its (B, H, Sq, dh)
view, so the model's transpose back is free.

bfloat16 runs on the tensor cores (wgmma, K/V tiles by TMA, the query heads
of a KV head packed into 64-row tiles) and needs dh % 8 == 0; float32 runs
on the CUDA cores and needs dh % 4 == 0.  The reference's
``block_q``/``block_kv`` arguments are the TPU kernel's VMEM tiling and do
not change the function, so the port does not take them.

``LAUNCHES`` counts kernel launches (plain-version calls do not count), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import attention_ref

NAME = "flash_attn"
MAX_HEAD_DIM = 128
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_attn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    """Raise on operands the kernel does not take; runs on any device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Sq,dh) and k, v (B,KV,Skv,dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {x.dtype}; q, k and v must share "
                            f"one of {_DTYPES}")
    unit = 16 // q.element_size()             # elements in 16 bytes
    if dh % unit or dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of {unit} in "
                         f"{q.dtype} and at most {MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16 or x.stride(-1) != 1 or any(
                st % unit for st, n in zip(x.stride()[:-1], x.shape[:-1])
                if n > 1):
            raise ValueError(f"{name} must be 16-byte aligned, contiguous in "
                             f"the head dim, with strides multiples of {unit}")


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, dh); k, v (B, KV, Skv, dh), any strides with dh
    contiguous -> (B, H, Sq, dh) in q's dtype, float32 or bfloat16."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    b, h, sq, dh = q.shape
    kv, skv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kv,
            sq, skv, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1.0 / math.sqrt(dh), int(causal), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return o
