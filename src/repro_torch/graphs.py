"""CUDA graphs of the serving steps: the port's counterpart of the
reference's ``jax.jit`` around its steps (``env/serve_engine.py``'s
``prefill_one`` and ``decode_all``, ``launch/steps.py``'s prefill and
decode steps, ``core/training.py``'s routing step).

A ``StepGraph`` captures one call of a step on the current device with
``torch.cuda.CUDAGraph``.  The step reads only tensors that keep their
storage (static input buffers, the cache, the weights), so ``replay()``
runs the same launches on whatever those hold now and returns the step's
static output, which the next replay overwrites.  A host synchronisation
inside the step makes the capture raise; nothing falls back to eager.

A step that draws random numbers from ``torch.Generator``s names them at
capture: each is registered with the graph, so every replay draws from the
generator's state at that moment and advances it by what the captured draws
took, exactly as the same step run eagerly would.

The kernels' launch counters (``LAUNCHES`` and the like in
``kernels/*/ops.py``) count Python calls, which happen at capture and not
at replay.  So a capture records each counter's increase and restores the
counters, and each replay adds the recorded increase: the counts say what
ran on the card.
"""
from __future__ import annotations

import importlib
from typing import Callable, Iterable, Tuple

import torch

# (kernel package, counter): every launch counter of the port's kernels
COUNTERS = (("lockstep_advance", "LAUNCHES"), ("flash_attn", "LAUNCHES"),
            ("decode_attn", "LAUNCHES"), ("moe_gemm", "SWIGLU_LAUNCHES"),
            ("moe_gemm", "GEMM_LAUNCHES"), ("rwkv6_scan", "LAUNCHES"),
            ("rglru_scan", "LAUNCHES"))


def _ops(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def launch_counts() -> Tuple[int, ...]:
    """Every counter of ``COUNTERS``, in order."""
    return tuple(getattr(_ops(mod), attr) for mod, attr in COUNTERS)


def add_launch_counts(delta) -> None:
    for (mod, attr), d in zip(COUNTERS, delta):
        ops = _ops(mod)
        setattr(ops, attr, getattr(ops, attr) + d)


class StepGraph:
    """``fn()`` captured once as a CUDA graph, in the memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``; graphs that never run at the same
    time and whose outputs are read before the next replay may share
    one), with the ``generators`` it draws from registered.  Its output
    may be any tree of tensors (or None).  ``launches`` is each counter's
    increase per replay."""

    def __init__(self, fn: Callable[[], object], pool=None,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()
        finally:
            after = launch_counts()
            add_launch_counts(tuple(b - a for a, b in zip(after, before)))
        self.launches = tuple(a - b for a, b in zip(after, before))

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.out
