"""What one rank's step costs, counted as the step runs (the port's
counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses compiled HLO text, because XLA's
``cost_analysis()`` counts a while loop's body once and so drops the
layers of a scanned model.  The port's steps run their loops in Python,
so every op that runs passes the dispatcher once per run: ``CostCounter``
is a ``TorchDispatchMode`` that sees each executed op, and there is no
trip count to find (``while_trips`` has no meaning here and is left
out).  Everything is per rank, as the reference's SPMD module is the
per-device program.

    with CostCounter(steps.arg_tensors(args)) as counter:
        out = step(*args)
    counter.totals.as_dict()      # the reference's keys
    counter.peak_bytes            # live bytes above the arguments, at most

What ``CostTotals`` counts, with the reference's ``as_dict`` keys:

* ``flops``: the tensor-core contractions, ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``addmv`` and ``dot`` (which ``einsum``,
  ``matmul`` and ``linear`` lower to), at 2·prod(result)·K; and the
  contractions of the hand-written kernels, each reported by its wrapper
  (``counted``) by the kernel's own formula.
* ``elementwise_flops``: one per output element of every other op that
  computes (not a view, an allocation, a copy or a collective), as the
  reference charges its fusions; a kernel's own elementwise work.
* ``transcendentals``: one per output element of ``exp``, ``log``,
  ``tanh``, ``sigmoid``, ``sqrt``, ``pow``, the softmaxes and their
  kin.
* ``memory_bytes``: the bytes of every op's tensor operands plus its
  results.  Eager PyTorch writes every op's result to memory and reads it
  back, so this is an upper bound on the traffic a fused program would
  make.  Views, reshapes, ``detach`` and allocations move no data and are
  skipped, as the reference's ``_SKIP_MEMORY_OPS`` skips them.  A kernel
  counts its inputs read once and its outputs written once, the count of
  ``PERF.md``'s "bound" column.
* ``collective_operand_bytes``, ``collective_wire_bytes`` (the operand
  bytes times the reference's ``_WIRE_FACTOR``: 2 for an all-reduce, 1
  for the others) and ``collective_counts``, at the ``c10d`` ops the
  dispatcher sees (an all-gather's operand is the rank's block, a
  reduce-scatter's the whole input).  ``collective_result_bytes`` is what
  the ranks receive, which ``distributed.collectives.BYTES`` counts by
  reader.
* ``unknown_customcalls``: the ops that have no formula here
  (convolutions, fused attention, ops of other namespaces); their bytes
  are counted, their operations are not.
* ``kernels``: calls of each hand-written kernel counted by its formula.

A kernel's wrapper is decorated with ``counted(name, work)``: under a
counter the ops the wrapper runs inside (the plain version on the CPU,
allocations on the card; the kernel itself is a ``ctypes`` call the
dispatcher never sees) are not counted, and ``work(*args, **kwargs)``
is, so a step counts the same on the meta device, the CPU and the card.

Live bytes: every storage an op makes is counted from the op until it is
freed (its storage object's finalizer), once however many views it has.
Meta tensors have no addresses, so the counter keys storages by their
objects.  The arguments' storages (``CostCounter(args)``) are not counted
as live, so ``peak_bytes`` is the most the step holds above them.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# bytes moved over links, as a multiple of the operand bytes (the
# reference's _WIRE_FACTOR; a broadcast moves its operand once)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}

# c10d op -> (collective, index of its operand argument, index of its result
# argument); an in-place op's operand is its result
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "broadcast_": ("broadcast", 0, 0),
    "send": ("collective-permute", 0, 0),
    "recv_": ("collective-permute", 0, 0),
}

# ops that move no data: views and allocations (the reference's
# _SKIP_MEMORY_OPS)
_NO_DATA = {"_unsafe_view", "empty", "empty_like", "empty_strided",
            "new_empty", "new_empty_strided", "empty_permuted",
            "_local_scalar_dense", "lift_fresh", "set_", "resize_"}
# ops that move data and compute nothing
_COPIES = {"copy_", "_to_copy", "clone", "contiguous", "_copy_from",
           "_copy_from_and_resize", "zeros", "zeros_like", "ones",
           "ones_like", "full", "full_like", "new_zeros", "new_ones",
           "new_full", "fill_", "zero_", "scalar_tensor", "arange",
           "cat", "stack", "index_select", "gather", "index", "repeat",
           "masked_fill", "masked_fill_", "where", "constant_pad_nd",
           "slice_scatter", "select_scatter", "index_put_", "index_put",
           "scatter", "scatter_", "embedding", "embedding_dense_backward",
           "expand_copy", "unsqueeze_copy", "view_copy"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log1p",
                   "log2", "tanh", "tanh_backward", "sigmoid",
                   "sigmoid_backward", "sqrt", "rsqrt", "pow", "pow_", "erf",
                   "sin", "cos", "silu", "silu_backward", "gelu",
                   "gelu_backward", "softplus", "softplus_backward",
                   "_softmax", "_log_softmax", "logsumexp", "reciprocal"}
# ops whose operations have no formula here
_NO_FORMULA = {"convolution", "_convolution", "convolution_backward",
               "cudnn_convolution", "_scaled_dot_product_flash_attention",
               "_scaled_dot_product_efficient_attention",
               "_scaled_dot_product_cudnn_attention",
               "_flash_attention_forward", "_efficient_attention_forward",
               "_scaled_mm", "linalg_solve", "_linalg_svd", "_linalg_eigh"}


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0                 # tensor-core contractions
    elementwise_flops: float = 0.0     # one per output element
    transcendentals: float = 0.0
    memory_bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_result_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    unknown_customcalls: List[str] = dataclasses.field(default_factory=list)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        """The reference's ``as_dict`` keys but ``while_trips`` (a loop
        here runs in Python and is counted as it runs), with
        ``transcendentals``, ``collective_result_bytes`` and ``kernels``
        beside them."""
        return {
            "flops": self.flops,
            "elementwise_flops": self.elementwise_flops,
            "transcendentals": self.transcendentals,
            "memory_bytes": self.memory_bytes,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_result_bytes": self.collective_result_bytes,
            "collective_counts": dict(self.collective_counts),
            "unknown_customcalls": self.unknown_customcalls[:10],
            "kernels": dict(self.kernels),
        }


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors`` (a view counted
    with its base once)."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _flat_tensors(y)]
    return []


def _contraction_flops(name: str, args, out) -> Optional[float]:
    """2·prod(result)·K of a contraction, else None."""
    if name in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addmv"):
        k = args[1].shape[-1]
    else:
        return None
    return 2.0 * out.numel() * k


_STACK: List["CostCounter"] = []


def active() -> Optional["CostCounter"]:
    """The innermost counter this thread runs under, or None."""
    return _STACK[-1] if _STACK else None


class CostCounter(TorchDispatchMode):
    """Counts every op run inside it (module docstring).  ``args``: the
    tensors of the step's arguments (``launch.steps.arg_tensors``), whose
    storages are not counted as live.  After the block: ``totals``,
    ``peak_bytes`` (the most live bytes above the arguments),
    ``live_bytes`` (what is live at the end: the outputs that are new),
    ``argument_bytes`` and ``top_buffers`` (dtype[shape] -> bytes of the
    tensors of at least ``top_min_bytes`` the step held or made)."""

    def __init__(self, args=(), top_min_bytes: float = 1e8):
        super().__init__()
        self.totals = CostTotals()
        self.live_bytes = self.peak_bytes = 0
        self.top_min_bytes = top_min_bytes
        self.top_buffers: Dict[str, int] = {}
        self._quiet = 0
        self._live: Dict[int, int] = {}
        arg_tensors = list(args)
        self._args = {t.untyped_storage()._cdata for t in arg_tensors}
        self.argument_bytes = storage_bytes(arg_tensors)
        for t in arg_tensors:
            self._top(t)

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    # -- live storages -----------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live or key in self._args:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def _top(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if n >= self.top_min_bytes:
            key = (f"{str(t.dtype).split('.')[-1]}"
                   f"[{','.join(str(d) for d in t.shape)}]")
            self.top_buffers[key] = n

    def top(self, k: int = 10) -> list:
        """The ``k`` largest buffers, as the reference's record lists
        them."""
        rows = sorted(self.top_buffers.items(), key=lambda kv: -kv[1])[:k]
        return [{"type": key, "gb": round(n / 1e9, 3)} for key, n in rows]

    # -- counting ----------------------------------------------------------
    def _collective(self, name: str, args) -> None:
        kind, i_op, i_res = _C10D[name]
        operand = sum(_nbytes(t) for t in _flat_tensors(args[i_op]))
        result = sum(_nbytes(t) for t in _flat_tensors(args[i_res]))
        tot = self.totals
        tot.collective_operand_bytes += operand
        tot.collective_wire_bytes += operand * _WIRE_FACTOR[kind]
        tot.collective_result_bytes += result
        tot.collective_counts[kind] = tot.collective_counts.get(kind, 0) + 1
        tot.memory_bytes += operand + result

    def _op(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        outs = _flat_tensors(out)
        for t in outs:
            self._track(t)
            self._top(t)
        if func.namespace == "c10d" and name in _C10D:
            self._collective(name, args)
            return
        if func.is_view or name in _NO_DATA:
            return
        ins = [t for a in list(args) + list(kwargs.values())
               for t in _flat_tensors(a)]
        tot = self.totals
        tot.memory_bytes += (sum(_nbytes(t) for t in ins)
                             + sum(_nbytes(t) for t in outs))
        n_out = sum(t.numel() for t in outs)
        flops = _contraction_flops(name, args, outs[0]) if outs else None
        if flops is not None:
            tot.flops += flops
            return
        if func.namespace != "aten" or name in _NO_FORMULA:
            label = f"{func.namespace}.{name}"
            if label not in tot.unknown_customcalls:
                tot.unknown_customcalls.append(label)
            return
        if name in _COPIES:
            return
        tot.elementwise_flops += n_out
        if name in _TRANSCENDENTAL:
            tot.transcendentals += n_out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._op(func, args, kwargs, out)
        return out

    def kernel(self, name: str, work: dict, out) -> None:
        """A hand-written kernel's call: its ``work`` (``flops``,
        ``elementwise_flops``, ``transcendentals``, ``bytes``) and its
        outputs, which become live."""
        tot = self.totals
        tot.flops += work.get("flops", 0)
        tot.elementwise_flops += work.get("elementwise_flops", 0)
        tot.transcendentals += work.get("transcendentals", 0)
        tot.memory_bytes += work.get("bytes", 0)
        tot.kernels[name] = tot.kernels.get(name, 0) + 1
        for t in _flat_tensors(out):
            self._track(t)
            self._top(t)


def counted(name: str, work: Callable[..., dict]):
    """Decorate a kernel's wrapper: under a counter, count the call by
    ``work(*args, **kwargs)`` (the kernel's formula, from the shapes)
    instead of the ops the wrapper runs; without one, call it as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = active()
            if counter is None:
                return fn(*args, **kwargs)
            counter._quiet += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                counter._quiet -= 1
            counter.kernel(name, work(*args, **kwargs), out)
            return out
        return call
    return wrap


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Query-key pairs an attention of ``sq`` queries over ``skv`` keys
    computes: key j is seen by query i when ``j <= i`` (causal) and ``j >
    i - window`` (window > 0), as ``kernels.flash_attn.ref.attention_ref``
    masks."""
    i = np.arange(sq)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())
