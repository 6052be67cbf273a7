"""Plain versions of the grouped expert GEMM kernels: float32 einsums with
one rounding to the input dtype (port of ``repro/kernels/moe_gemm/ref.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w (E, D, F) -> x[e] @ w[e], (E, C, F) in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor) -> torch.Tensor:
    """x (E, C, D); w_gate, w_up (E, D, F) -> silu(x@wg) * (x@wu), (E, C, F)
    in x's dtype; both products and the SiLU stay in float32."""
    g = torch.einsum("ecd,edf->ecf", x.float(), w_gate.float())
    u = torch.einsum("ecd,edf->ecf", x.float(), w_up.float())
    return (F.silu(g) * u).to(x.dtype)
