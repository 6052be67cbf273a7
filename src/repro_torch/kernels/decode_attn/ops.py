"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attn.cu``).

``decode_attn`` has ``ref.decode_attention_ref``'s contract.  For CPU
tensors it runs that plain version; for CUDA tensors it launches the
kernel on the current stream or raises: there is no fallback.  The library
is built at the first CUDA call, never at import.

``k`` and ``v`` may be strided views: the serving cache holds a layer as
(B, S, KV, dh), and ``k_cache.transpose(1, 2)`` hands it over as (B, KV, S,
dh) with no copy; only the head dimension must be contiguous.  The
reference's ``block_kv`` is the TPU kernel's VMEM tiling and does not
change the function, so the port does not take it.

``LAUNCHES`` counts kernel launches (plain-version calls do not count), so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

NAME = "decode_attn"
MAX_HEAD_DIM = 128
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,dh) and k, v (B,KV,S,dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dh % 4 != 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of 4 and at most "
                         f"{MAX_HEAD_DIM}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {x.dtype}; q, k and v must share "
                            f"one of {_DTYPES}")
        if x.data_ptr() % 16 or x.stride(-1) != 1 \
                or any(st % 4 for st in x.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned, contiguous in "
                             f"the head dim, with strides multiples of 4")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, dh); k, v (B, KV, S, dh), any strides with dh contiguous;
    lengths (B,) int32 -> (B, H, dh) in q's dtype, float32 or bfloat16."""
    global LAUNCHES
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, lengths)
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), b, h, kv, s, dh, *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return o
