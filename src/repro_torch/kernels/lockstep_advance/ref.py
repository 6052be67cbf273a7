"""Plain version of the lockstep-advance kernel: the engine's PyTorch loop.

The semantics live in ``repro_torch.env.engine.advance_shard``; it is
re-exposed here so the kernel package carries its own oracle, as the
reference's ``repro/kernels/lockstep_advance/ref.py`` does.
"""
from __future__ import annotations

from repro_torch.env.engine import advance_shard


def lockstep_advance_ref(run_i, run_f, wait_i, wait_f, par, clocks, t_next,
                         *, latency_L: float, admit_order: str = "fifo"):
    return advance_shard(run_i, run_f, wait_i, wait_f, par, clocks, t_next,
                         latency_L=latency_L, admit_order=admit_order)
