"""What a run hands the per-layer metrics' readers (``perfbench/metrics``):
the configuration, the client's log and window, each decode's slot
positions, and the trace of a ``--trace 1`` run (None otherwise).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from perfbench import history

# the port's kernels as named in a trace, by the tag of their launch
KERNELS = {"b2": ("flash_attn_bf16_kernel", "flash_attn_f32_kernel"),
           "b3": ("decode_attn_mma", "decode_attn_simt"),
           "b3_merge": ("decode_attn_merge",),
           "b4": ("moe_gemm_mma", "moe_gemm_simt", "moe_gemm_tma"),
           "b4_merge": ("moe_gemm_merge",)}


def kernels_of(ops, tag: str) -> list:
    names = KERNELS.get(tag, ())
    return [e for e in ops if any(n in e.name for n in names)]


class Record:
    def __init__(self, model: dict, serve: dict, window, log, trace=None):
        self.model = model
        self.serve = serve
        self.window = window
        self.log = log
        self.trace = trace
        self.cache_len = history.cache_len(model, serve)
        self._decodes = self._walk()

    def _walk(self) -> Dict[int, Tuple[List[int], List[bool]]]:
        """Per decode (by its place in the log): every slot's cache
        entries it reads, and whether a request runs in the slot."""
        slots = self.serve["slots"]
        pos, left, out = [0] * slots, [0] * slots, {}
        for i, it in enumerate(self.log):
            if it.kind == "prefill":
                pos[it.slot], left[it.slot] = it.prompt_len, it.max_new - 1
                continue
            keys = [history.keys_seen(q, self.model.get("attention", "full"),
                                      self.model.get("window", 0),
                                      self.cache_len) for q in pos]
            out[i] = (keys, [n > 0 for n in left])
            pos = [q + 1 for q in pos]
            left = [max(n - 1, 0) for n in left]
        return out

    def window_steps(self, kind: str) -> Iterator[Tuple[int, object]]:
        """(place in the log, iteration) of the window's iterations of
        ``kind`` that ended inside it."""
        first = len(self.log) - len(self.window.iterations)
        for i, it in enumerate(self.window.iterations, start=first):
            if it.kind == kind and (self.window.t_open <= it.t1
                                    <= self.window.t_close):
                yield i, it

    def decode_keys(self, i: int, active_only: bool = False) -> List[int]:
        keys, active = self._decodes[i]
        return [k for k, a in zip(keys, active) if a or not active_only]

    def traced(self, kind: str) -> Iterator[Tuple[int, object, list]]:
        """(place, iteration, its device operations) for the iterations of
        ``kind`` inside the traced window; nothing without a trace."""
        if self.trace is None:
            return
        from perfbench.trace import within
        for i, it in self.window_steps(kind):
            if self.trace.t0 <= it.t0 and it.t1 <= self.trace.t1:
                yield i, it, within(self.trace, it.t0, it.t1)

    def roofline_share(self, kind: str, tag: str, expected: int, bound
                       ) -> Optional[float]:
        """Percent: the least time of the ``tag`` kernels over their traced
        time, over the traced ``kind`` iterations whose trace holds the
        ``expected`` launches (the profiler now and then loses records);
        ``bound(place, iteration)`` is the least time of them all."""
        least = spent = 0.0
        for i, it, ops in self.traced(kind):
            main = kernels_of(ops, tag)
            if len(main) != expected:
                continue
            merge = kernels_of(ops, f"{tag}_merge")
            least += bound(i, it)
            spent += sum(e.end - e.start for e in main + merge)
        return 100.0 * least / spent if spent > 0 else None
