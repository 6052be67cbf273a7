"""Plain versions of the grouped expert GEMM kernels: float32 einsums with
one rounding to the input dtype (port of ``repro/kernels/moe_gemm/ref.py``),
and B4a's split of the work on the card (``gemm_plan``) with that split's
algorithm in plain PyTorch (``grouped_gemm_split_ref``)."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

# B4a's tiles on the card (``csrc/moe_gemm.cu``): output columns, contraction
# rows and rows of C per tile
TILE_N, TILE_K, TILE_C = 256, 64, 64


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


def gemm_tiled(dtype: torch.dtype, k: int, n: int) -> bool:
    """Whether B4a takes its split path on the card: bfloat16, and K and N
    multiples of 8 (16-byte rows for TMA), K > 0.  Otherwise the card runs
    the kernel B4b shares (one block per output tile)."""
    return dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """B4a's static split of x (E, C, K) @ w (E, K, N) over ``ctas`` CTAs.

    A unit is (expert, row tile of ``TILE_C``, column tile of ``TILE_N``,
    contraction chunk of ``TILE_K``), numbered with the chunk fastest; CTA
    g takes units ``[starts[g], starts[g + 1])``.  ``rows`` is the rows of
    a tile's workspace slot, min(TILE_C, C rounded up to 8)."""

    e: int
    c: int
    k: int
    n: int
    ct: int
    nt: int
    kc: int
    ctas: int
    rows: int

    @property
    def units(self) -> int:
        return self.e * self.ct * self.nt * self.kc

    @property
    def starts(self) -> List[int]:
        return [g * self.units // self.ctas for g in range(self.ctas + 1)]

    def tile(self, t: int) -> Tuple[int, int, int]:
        """Tile t's (expert, row tile, column tile)."""
        return t // self.nt // self.ct, t // self.nt % self.ct, t % self.nt

    def segments(self):
        """Each CTA's work in order: (cta, tile, first chunk, end chunk,
        slot), the slot None where the CTA covers the whole tile and
        writes the output, else its workspace slot (2 per CTA: its first
        tile's, then its last's)."""
        out = []
        starts = self.starts
        for g in range(self.ctas):
            u, end = starts[g], starts[g + 1]
            first = u // self.kc
            while u < end:
                t = u // self.kc
                hi = min(end, (t + 1) * self.kc)
                whole = u == t * self.kc and hi == (t + 1) * self.kc
                slot = None if whole else 2 * g + (0 if t == first else 1)
                out.append((g, t, u - t * self.kc, hi - t * self.kc, slot))
                u = hi
        return out

    def merges(self):
        """The tiles that range boundaries cut, each with the workspace
        slots to add, in CTA order (the merge launch's work)."""
        out = []
        starts = self.starts
        for g in range(1, self.ctas):
            s = starts[g]
            t = s // self.kc
            if s % self.kc == 0 or starts[g - 1] > t * self.kc:
                continue
            last = g
            while last + 1 < self.ctas and starts[last + 1] < (t + 1) * self.kc:
                last += 1
            out.append((t, [2 * gg + (0 if starts[gg] // self.kc == t else 1)
                            for gg in range(g - 1, last + 1)]))
        return out


def gemm_plan(e: int, c: int, k: int, n: int, n_sm: int) -> GemmPlan:
    """The split for these shapes and ``n_sm`` SMs: the most CTAs, within a
    tenth of ``n_sm``, that take the tiles whole and alike (every CTA then
    walks the contraction in step with the others, and nothing is merged);
    else one CTA per SM, at most one per unit, over equal ranges of
    units."""
    ct = -(-c // TILE_C)
    nt = -(-n // TILE_N)
    kc = -(-k // TILE_K)
    units = e * ct * nt * kc
    ctas = max(1, min(n_sm, units))
    for d in range(n_sm, 0, -1):
        if 10 * d < 9 * n_sm:
            break
        if (e * ct * nt) % d == 0:
            ctas = d
            break
    return GemmPlan(e=e, c=c, k=k, n=n, ct=ct, nt=nt, kc=kc, ctas=ctas,
                    rows=min(TILE_C, -(-c // 8) * 8))


def grouped_gemm_split_ref(x: torch.Tensor, w: torch.Tensor,
                           n_sm: int) -> torch.Tensor:
    """B4a's algorithm on the card in plain PyTorch: each CTA of
    ``gemm_plan`` sums its tiles' chunk products in float32 in contraction
    order; a whole tile rounds once to x's dtype, a cut tile's partial sums
    go to workspace slots that the merge adds in CTA order, then rounds."""
    e, c, k = x.shape
    n = w.shape[2]
    plan = gemm_plan(e, c, k, n, n_sm)
    xf, wf = x.float(), w.float()
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    ws = {}
    for _, t, lo, hi, slot in plan.segments():
        ei, ci, ni = plan.tile(t)
        rs = slice(ci * TILE_C, min(c, (ci + 1) * TILE_C))
        cs = slice(ni * TILE_N, min(n, (ni + 1) * TILE_N))
        acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start),
                          dtype=torch.float32, device=x.device)
        for kc in range(lo, hi):
            ks = slice(kc * TILE_K, min(k, (kc + 1) * TILE_K))
            acc = acc + xf[ei, rs, ks] @ wf[ei, ks, cs]
        if slot is None:
            out[ei, rs, cs] = acc.to(x.dtype)
        else:
            ws[slot] = acc
    for t, slots in plan.merges():
        ei, ci, ni = plan.tile(t)
        rs = slice(ci * TILE_C, min(c, (ci + 1) * TILE_C))
        cs = slice(ni * TILE_N, min(n, (ni + 1) * TILE_N))
        acc = ws[slots[0]]
        for slot in slots[1:]:
            acc = acc + ws[slot]
        out[ei, rs, cs] = acc.to(x.dtype)
    return out
