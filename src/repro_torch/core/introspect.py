"""Memory probes shared by tests and the card check (the port's
counterpart of ``repro/core/introspect.py``).

``max_intermediate_elems(fn, *args)`` is the reference's obs-memory
metric: the largest intermediate array, in elements.  The reference walks
``fn``'s jaxpr; here a dispatch mode sees every op ``fn`` runs, on any
device (the meta device included), and keeps the largest output.

``peak_bytes(fn, *args)`` is what the card allocates at most while ``fn``
runs: ``torch.cuda.max_memory_allocated`` after
``torch.cuda.reset_peak_memory_stats``, so it counts what was allocated
before the call and stays allocated too.  It raises for any other
device: a peak measured on the host is not the card's.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _LargestOutput(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def max_intermediate_elems(fn, *args) -> int:
    """The largest tensor, in elements, that any op of ``fn(*args)``
    returns (module docstring)."""
    with _LargestOutput() as probe:
        fn(*args)
    return probe.largest


def peak_bytes(fn, *args, device=None) -> int:
    """The most the CUDA ``device`` (the current one by default) holds
    allocated while ``fn(*args)`` runs, in bytes (module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"peak_bytes measures a CUDA device's allocator; "
                           f"{dev} is not one here")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)
