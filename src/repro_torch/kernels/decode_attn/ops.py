"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attn.cu``).

``decode_attn`` has the contract of ``ref.decode_attn_plain``: one query
token per sequence against a cache, under the ``lengths`` mask (the
reference's kernel) or the ``kv_pos`` mask of a ring cache.  For CPU
tensors it runs that plain version; for CUDA tensors it launches the kernel
on the current stream or raises: there is no fallback.  The library is
built at the first CUDA call, never at import.

``k`` and ``v`` may be strided views: the serving cache holds a layer as
(B, S, KV, dh), and ``k_cache.transpose(1, 2)`` hands it over as (B, KV, S,
dh) with no copy; only the head dimension must be contiguous.  The keys
are cut across blocks as ``ref.split_plan`` says (from the shapes and the
SM count, never from the lengths), and with more than one split the merge
is a second launch inside the same call; its scratch comes from
``torch.empty``.  The reference's ``block_kv`` is the TPU kernel's VMEM
tiling and does not change the function, so the port does not take it.

With ``return_lse=True`` the call also returns each row's log-sum-exp
of its scaled scores over its valid keys, float32 (B, H), -inf for a row
with no valid key (its output is 0): the one-split kernel writes it, or
the merge launch.  Two caches' partial outputs merge by it
(``distributed.collectives.softmax_merge``).  Without it the kernel
writes nothing more, and its output is the same.

``LAUNCHES`` counts calls that launched the kernel (plain-version calls do
not count), so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import (BLOCK_ROWS, decode_attn_plain,
                                                 split_plan)

NAME = "decode_attn"
MAX_HEAD_DIM = 256
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 7
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, which ``split_plan`` takes."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, lengths, kv_pos, pos):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,dh) and k, v (B,KV,S,dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, dh = q.shape
    s = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dh % 8 != 0 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of 8 and at most "
                         f"{MAX_HEAD_DIM}")
    if lengths is not None:
        if lengths.shape != (b,) or lengths.dtype != torch.int32 \
                or not lengths.is_contiguous():
            raise ValueError(f"lengths must be a contiguous int32 ({b},), got "
                             f"{lengths.dtype} {tuple(lengths.shape)}")
        ints = (("lengths", lengths),)
    else:
        if kv_pos.shape != (b, s) or kv_pos.dtype != torch.int32 \
                or kv_pos.stride(1) != 1:
            raise ValueError(f"kv_pos must be int32 ({b}, {s}) with contiguous "
                             f"rows, got {kv_pos.dtype} {tuple(kv_pos.shape)}")
        if not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32 \
                or pos.shape not in ((), (b,)):
            raise ValueError(f"pos must be an int32 tensor of shape () or "
                             f"({b},), got {pos!r}")
        ints = (("kv_pos", kv_pos), ("pos", pos))
    for name, x in (("q", q), ("k", k), ("v", v)) + ints:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {x.dtype}; q, k and v must share "
                            f"one of {_DTYPES}")
        per16 = 16 // x.element_size()
        if x.data_ptr() % 16 or x.stride(-1) != 1 \
                or any(st % per16 for st in x.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned, contiguous in "
                             f"the head dim, with strides multiples of 16 bytes")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                kv_pos: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, return_lse: bool = False):
    """q (B, H, dh); k, v (B, KV, S, dh), any strides with dh contiguous;
    one mask: ``lengths`` (B,) int32, or ``kv_pos`` (B, S) int32 with
    ``pos`` (B,) or () int32 -> (B, H, dh) in q's dtype, float32 or
    bfloat16; with ``return_lse``, (that, the rows' log-sum-exp (B, H)
    float32)."""
    global LAUNCHES
    if (lengths is None) == (kv_pos is None) or (kv_pos is None) != (pos is None):
        raise ValueError("give either lengths, or kv_pos and pos")
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, lengths, kv_pos=kv_pos, pos=pos,
                                 return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, lengths, kv_pos, pos)
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    n, per = split_plan(s, b * kv * -(-(h // kv) // BLOCK_ROWS),
                        sm_count(q.device.index or 0))
    o = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ml = acc = None
    if n > 1:
        ml = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device)
        acc = torch.empty((b, h, n, dh), dtype=torch.float32, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ptr(lengths), ptr(kv_pos), ptr(pos), ptr(ml), ptr(acc), ptr(lse),
            b, h, kv, s, dh, n, per, *k.stride()[:3], *v.stride()[:3],
            0 if kv_pos is None else kv_pos.stride(0),
            0 if pos is None or pos.dim() == 0 else pos.stride(0),
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return (o, lse) if return_lse else o
