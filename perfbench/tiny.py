"""A tiny configuration, mix and cell for the CPU tests: the dense and MoE
decoders at a few dozen widths, served eagerly on the CPU through the same
``run.Session`` and check as the card's cells."""
from __future__ import annotations

import contextlib

import torch

from perfbench import spec

END_TO_END = ("qos", "tpot_p95_ms", "ttft_p95_ms", "tokens_per_s", "setup_s")


def config(family: str, dtype: str = "float32") -> dict:
    m = {"name": f"tiny-{family}", "family": family, "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
         "d_ff": 128, "vocab": 256, "rope_theta": 10000.0, "norm_eps": 1e-5,
         "param_dtype": dtype, "compute_dtype": dtype,
         "tie_embeddings": False}
    if family == "moe":
        m.update(n_experts=4, top_k=2, capacity_factor=1.25, attention="full")
    else:
        m.update(attention="swa", window=4096)
    # 4 slots of 64 positions: idle slots decode past the end of the cache
    return {"reference": "transformer",
            "model": m, "serve": {"slots": 4, "max_len": 64,
                                  "buckets": [16, 32], "kernels": []}}


TRAFFIC = {"population_seed": 0, "arrivals": {"law": "poisson"},
           "prompt": {"law": "lognormal", "mu": 2.8, "sigma": 0.5,
                      "min": 8, "max": 32},
           "output": {"law": "uniform", "min": 2, "max": 12},
           "quality": [0.5, 0.7], "latency_limit_s": 0.03}


def cell_file(max_gap: float = 1e-3, margin: float = 0.0,
              rate: float = 20.0) -> dict:
    # a grace long enough for a CPU shared with other test workers
    return {"rate": rate, "grace_s": 60.0, "trace": {"seconds": 0.2},
            "check": {"sample_tokens": 200, "route_margin": margin,
                      "limits": {"max_gap": max_gap}}}


def cell(family: str, dtype: str = "float32", max_gap: float = 1e-3,
         margin: float = 0.0, rate: float = 20.0) -> spec.Cell:
    return spec.Cell(name=f"tiny-{family}.tiny", config=config(family, dtype),
                     traffic=dict(TRAFFIC),
                     cell=cell_file(max_gap, margin, rate),
                     end_to_end=[{"name": n, "unit": "u"} for n in END_TO_END],
                     per_layer=[], chips=1)


@contextlib.contextmanager
def one_thread():
    """Torch on one thread, as the benchmark runs it, restored after: the
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
