"""Wrapper of the chunked RWKV6 WKV scan CUDA kernel (``csrc/rwkv6_scan.cu``).

``wkv`` computes the chunked scan from a zero state and returns ``(y,
state)``.  For CPU tensors it runs the plain version ``ref.wkv_chunked_ref``
(rounding ``D`` to ``d_dtype``, as the reference model does); for CUDA
tensors it launches the kernel on the current stream or raises: there is no
fallback.  The library is built at the first CUDA call, never at import.
The kernel has no backward: on the card a call with gradients enabled and
an input that requires one raises, rather than return an output with no
gradient (the model trains through ``models.rwkv6.wkv_chunked``).

Either way T need not be a multiple of the chunk: the plain path pads the
tail with ``k = v = 0`` and ``dlog = 0``, which leaves the state unchanged,
as the reference's ``ops.wkv`` pads; the kernel masks its last chunk
instead.  The kernel keeps ``D`` in float32 whatever ``d_dtype`` says, as
the TPU kernel does.

``r``, ``k``, ``v`` and ``dlog`` may be strided views: the model holds them
as (B, T, H, K) and hands them over as ``x.transpose(1, 2)`` with no copy;
only the last dimension must be contiguous.  ``y`` comes back in the same
layout as ``r``.

``chunk`` (1..64 on either device) sets the plain version's chunks
only.  On the card the kernel runs its own blocking (the function does not
depend on it): chunks of 16 rows with the decay factored in sub-blocks of
8, and groups of ``GROUP`` tokens, read when the call is made.  A prompt of
one group is one kernel that walks its chunks per (b, h); a longer one is
three, in parallel across groups (``ref.wkv_groups_ref`` is the algorithm
in plain PyTorch; ``kernels_per_call`` says how many a call launches).  The
group passes' workspace comes from PyTorch's caching allocator, so a call
can be captured in a CUDA graph.

``LAUNCHES`` counts calls that launch the kernels (plain-version calls do
not count), so a run can show that its main path went through them; a call
launches ``kernels_per_call(T)`` kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_scan.ref import wkv_chunked_ref

NAME = "rwkv6_scan"
MAX_CHUNK = 64
MAX_HEAD = 64
GROUP = 256         # tokens per group of the card's passes, a multiple of 16
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.rwkv6_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, dlog, u):
    if r.dim() != 4 or k.shape != r.shape or dlog.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"expected r, k, dlog (B,H,T,K) and v (B,H,T,V), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(dlog.shape)}, {tuple(v.shape)}")
    h, kd, vd = r.shape[1], r.shape[3], v.shape[3]
    if u.shape != (h, kd):
        raise ValueError(f"u {tuple(u.shape)} does not fit r {tuple(r.shape)}")
    if kd > MAX_HEAD or vd > MAX_HEAD:
        raise ValueError(f"K={kd} and V={vd} must be at most {MAX_HEAD}")
    for name, x in (("r", r), ("k", k), ("v", v), ("dlog", dlog), ("u", u)):
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, expected {r.device}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        if x.dtype != r.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {x.dtype}; r, k and v must share "
                            f"one of {_DTYPES}")
    if dlog.dtype != torch.float32:
        raise TypeError(f"dlog must be float32, got {dlog.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v), ("dlog", dlog)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def kernels_per_call(n_t: int) -> int:
    """Kernels one call of ``wkv`` launches on the card for T = ``n_t``: the
    walk alone for one group, else the sums, the carry and the walk."""
    return 1 if n_t <= GROUP else 3


def _aligned(x: torch.Tensor) -> bool:
    """16-byte copies can read x: base and (b, h, t) strides 16-byte
    aligned, the rows a multiple of 16 bytes."""
    size = x.element_size()
    return (x.data_ptr() % 16 == 0 and x.shape[-1] * size % 16 == 0
            and all(st * size % 16 == 0 for st in x.stride()[:3]))


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dlog: torch.Tensor,
        u: torch.Tensor, chunk: int = 32, d_dtype: Optional[torch.dtype] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, dlog (B, H, T, K); v (B, H, T, V); u (H, K) -> (y (B, H, T, V)
    in r's dtype, state (B, H, K, V) float32), from a zero state (B5); on
    the CPU in chunks of ``min(chunk, T)``.  On the card r, k, v are float32
    or bfloat16 alike, dlog float32, K and V at most 64."""
    global LAUNCHES
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK}")
    n = r.shape[2]
    if r.device.type == "cpu":
        n_l = min(chunk, n)
        pad = (-n) % n_l
        if pad:
            r, k, v, dlog = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, dlog))
        y, state = wkv_chunked_ref(r, k, v, dlog, u, n_l, d_dtype)
        return y[:, :, :n], state
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, dlog, u)):
        raise NotImplementedError(
            f"{NAME} (B5) has a backward in neither package, so its output "
            "would carry no gradient; train through the training forward "
            "(models.rwkv6.forward(..., train=True), the chunk algorithm "
            "wkv_chunked under autograd)")
    _check(r, k, v, dlog, u)
    group = GROUP
    b, h, _, kd = r.shape
    vd = v.shape[3]
    y = torch.empty_like(v, dtype=r.dtype)
    state = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    u32 = u.float().contiguous()
    n_g = -(-n // group)
    ws = pws = None
    if n_g > 1:
        ws = torch.empty((b * h, n_g, MAX_HEAD, MAX_HEAD), dtype=torch.float32,
                         device=r.device)
        pws = torch.empty((b * h, n_g, MAX_HEAD), dtype=torch.float32,
                          device=r.device)
    vec = all(_aligned(x) for x in (r, k, v, dlog))
    strides = [s for x in (r, k, v, dlog, y) for s in x.stride()[:3]]
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), dlog.data_ptr(),
            u32.data_ptr(), y.data_ptr(), state.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if pws is None else pws.data_ptr(), b, h, n, kd, vd, group,
            *strides, int(vec), int(r.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return y, state
