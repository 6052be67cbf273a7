"""Wrapper of the RG-LRU scan CUDA kernel (``csrc/rglru_scan.cu``).

``lru`` clamps ``log_a <= 0`` as the reference's ``ops.lru`` does, then
runs the recurrence of ``ref.rglru_scan_ref``.  For CPU tensors it runs
that plain version; for CUDA tensors it launches the kernel on the current
stream or raises: there is no fallback.  The kernel clamps as it loads, so
the clamp costs no pass of its own there.  The library is built at the
first CUDA call, never at import.  The kernel has no backward: on the card
a call with gradients enabled and an input that requires one raises,
rather than return an output with no gradient (the model trains through
``models.rglru.rg_lru_scan_train``).

On the card the scan is chunked in time (``ref.rglru_chunked_ref``): a
pass over chunks (``plan``) for each chunk's decay and end value,
then a pass that carries h0 through the chunks before each one and walks
it.  A prompt of at most ``SINGLE_T`` steps is walked in one pass, one
thread per column, as the card is full enough without chunks there
(``plan``; ``kernels_per_call`` says how many kernels a call launches).
The two-pass workspace comes from PyTorch's caching allocator, so a call
can be captured in a CUDA graph.

The reference's ``block_t``/``block_w`` are the TPU kernel's VMEM tiling
and its padding of T to ``block_t``; neither changes the function, so the
port takes neither (the kernel takes any T and W).

``LAUNCHES`` counts calls that launch the kernels (plain-version calls do
not count), so a run can show that its main path went through them; a call
launches ``kernels_per_call(T)`` kernels.  ``plan`` reads ``SINGLE_T``,
``CHUNKS`` and ``CHUNK_RANGE`` when the call is made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

NAME = "rglru_scan"
LAUNCHES = 0
CHUNKS = 16         # chunks the two-pass scan aims for ...
CHUNK_RANGE = (64, 256)   # ... of this many steps at least and at most
SINGLE_T = 128      # prompts up to this long are walked in one pass

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.rglru_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _check(log_a, b, h0):
    if log_a.dim() != 3 or b.shape != log_a.shape \
            or h0.shape != (log_a.shape[0], log_a.shape[2]):
        raise ValueError(f"expected log_a, b (B,T,W) and h0 (B,W), got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    for name, x in (("log_a", log_a), ("b", b), ("h0", h0)):
        if x.device != log_a.device:
            raise ValueError(f"{name} is on {x.device}, expected {log_a.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.dtype != log_a.dtype or b.dtype not in _DTYPES:
        raise TypeError(f"log_a and b must share one of {_DTYPES}, got "
                        f"{log_a.dtype}, {b.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")


def plan(n_t: int) -> int:
    """The chunk the card's scan takes for a prompt of ``n_t`` steps: one
    chunk of all of them (the single walk) up to ``SINGLE_T``, else about
    ``n_t / CHUNKS`` steps, a multiple of 16 within ``CHUNK_RANGE``."""
    if n_t <= SINGLE_T:
        return max(n_t, 1)
    lo, hi = CHUNK_RANGE
    return min(hi, max(lo, n_t // CHUNKS // 16 * 16))


def kernels_per_call(n_t: int) -> int:
    """Kernels one call of ``lru`` launches on the card for T = ``n_t``."""
    return 1 if n_t <= plan(n_t) else 2


def lru(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """log_a, b (B, T, W), float32 or bfloat16 alike; h0 (B, W) float32 ->
    h (B, T, W) in b's dtype, ``h_t = exp(min(log_a_t, 0)) * h_{t-1} + b_t``
    from ``h0`` (B6), in ``plan``'s chunks on the card."""
    global LAUNCHES
    if log_a.device.type == "cpu":
        return rglru_scan_ref(log_a.clamp(max=0.0), b, h0)
    if log_a.device.type != "cuda":
        raise ValueError(f"unsupported device {log_a.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (log_a, b, h0)):
        raise NotImplementedError(
            f"{NAME} (B6) has a backward in neither package, so its output "
            "would carry no gradient; train through the training forward "
            "(models.rglru.forward(..., train=True), the log-depth scan "
            "rg_lru_scan_train under autograd)")
    _check(log_a, b, h0)
    n_b, n_t, n_w = log_a.shape
    chunk = plan(n_t)
    out = torch.empty_like(b)
    sums = None
    if n_t > chunk:
        sums = torch.empty((n_b, -(-n_t // chunk), n_w, 2), dtype=torch.float32,
                           device=b.device)
    lib = _library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.rglru_scan_launch(
            log_a.data_ptr(), b.data_ptr(), h0.data_ptr(),
            None if sums is None else sums.data_ptr(), out.data_ptr(),
            n_b, n_t, n_w, chunk, int(b.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
