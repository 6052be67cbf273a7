"""Device selection for the port's entry points.

Entry points default to the CUDA device; tests and CPU runs pass
``device="cpu"`` explicitly.  Asking for CUDA where there is none raises:
nothing here falls back to the CPU on its own.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises ``RuntimeError`` for a CUDA
    device when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=256)
def _constant(key: tuple, dtype: torch.dtype, device: str,
              make: Optional[Callable]) -> torch.Tensor:
    values = key if make is None else make(*key)
    return torch.as_tensor(np.asarray(values)).to(device, dtype)


def constant(key, dtype: torch.dtype, device, make: Optional[Callable] = None
             ) -> torch.Tensor:
    """A tensor of small static data (capacities, row indices) on
    ``device``, built and copied there once and then reused: a copy from
    the host inside a step would make the host wait for the card.

    The tensor holds ``key`` itself (a tuple, or an array, turned into one),
    or ``make(*key)`` when ``make`` is given; the cache is keyed on ``key``,
    ``make``, ``dtype`` and ``device``.  Callers must not write to the
    result."""
    if not isinstance(key, tuple):
        key = tuple(np.asarray(key).tolist())
    return _constant(key, dtype, str(torch.device(device)), make)


def generator(device: torch.device, seed: Optional[int]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (draws on a CUDA tensor
    need a CUDA generator)."""
    gen = torch.Generator(device=device)
    if seed is not None:
        gen.manual_seed(int(seed))
    return gen
