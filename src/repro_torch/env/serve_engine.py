"""Real serving engine: iteration-level scheduling over the port's LMs
(port of ``repro/env/serve_engine.py``).

Each ``ExpertServer`` wraps one model with a slot-based continuous-batching
cache (a position per sequence) and runs Orca-style iterations, admit one
prefill OR decode all, measuring wall-clock latency per token.
``calibrate`` fits the paper's latency gradients (k1, k2; Eq. 13/14) to the
measured iterations by linear regression.

The host keeps a mirror of each slot's position, so neither the iteration
log's token count nor the done test reads the device; an iteration's one
synchronisation is the copy of its argmax tokens to the host, which ends
its timing.

On CUDA each step is a CUDA graph, as the reference jits each: the decode
of all slots once per server and the prefill once per prompt bucket, each
captured at its first call (``profile_cluster``'s warm-up, one request per
bucket) and replayed after that.  A step reads its inputs from static
device buffers (the bucket's token row, the prompt's length, the slot; the
slots' tokens) that a call fills before it replays, and writes the cache
in place, which keeps its storage for the server's life.  On the CPU the
same steps run eagerly; ``graphs=False`` runs them eagerly on CUDA too
(to time the eager path beside the graphed one).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs import StepGraph
from repro_torch.models import model as model_lib


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # prompt token ids
    max_new: int = 32
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1

    @property
    def latency_per_token(self) -> Optional[float]:
        if self.finish_time is None or not self.generated:
            return None
        return (self.finish_time - self.submit_time) / len(self.generated)


def _bucket(n: int, buckets=(16, 32, 64, 128, 256)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ExpertServer:
    """One edge expert: a model instance + slot-based continuous batching.
    The cache lives on the parameters' device.  It serves the LM families
    the reference's engine serves, dense and MoE, and refuses the others as
    the reference does.  ``iterations`` counts prefills and decodes over the
    server's life (the iteration log is cleared by calibration).  On CUDA
    its steps replay CUDA graphs unless ``graphs=False``."""

    def __init__(self, name: str, cfg: ModelConfig, params, *,
                 slots: int = 4, max_len: int = 256, eos_token: int = 1,
                 graphs: bool = True):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"{cfg.name}: the engine serves the dense and MoE "
                             f"LM families, not {cfg.family!r}")
        self.name = name
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.device = params.embed.device
        self.cache = model_lib.init_cache(cfg, slots, max_len, device=self.device)
        self.pos = np.zeros((slots,), np.int64)       # host mirror of cache["pos"]
        self.active: Dict[int, Request] = {}
        self.waiting: collections.deque = collections.deque()
        self.cur_tokens = np.zeros((slots,), np.int32)
        self.iteration_log: List[dict] = []  # (kind, p or total_tokens, dt)
        self.iterations = {"prefill": 0, "decode": 0}
        # the steps' static inputs, and their graphs (one memory pool: they
        # never run at the same time, and each output is read at once)
        self.graphed = graphs and self.device.type == "cuda"
        self._graphs: Dict[object, StepGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._prompts: Dict[int, torch.Tensor] = {}   # bucket -> (1, bucket)
        self._length = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._tokens = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)

    def _run(self, key, step) -> torch.Tensor:
        """``step()`` eagerly, or the replay of its graph (captured at the
        first call for ``key``)."""
        if not self.graphed:
            return step()
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(step, self._pool)
        return graph.replay()

    def _prefill_one(self, tokens: np.ndarray, length: int, slot: int
                     ) -> torch.Tensor:
        """tokens: the prompt right-padded to its bucket.  Primes slot
        ``slot`` of the cache; returns the first generated token (a device
        scalar)."""
        bucket = len(tokens)
        prompt = self._prompts.get(bucket)
        if prompt is None:
            prompt = self._prompts[bucket] = torch.zeros(
                (1, bucket), dtype=torch.int32, device=self.device)
        prompt.copy_(torch.as_tensor(tokens, dtype=torch.int32)[None])
        self._length.fill_(length)
        self._slot.fill_(slot)
        return self._run(("prefill", bucket), lambda: self._prefill_step(prompt))

    def _prefill_step(self, prompt: torch.Tensor) -> torch.Tensor:
        logits, pc = model_lib.prefill(self.params, self.cfg, prompt,
                                       self.max_len, lengths=self._length)
        # the request's cache into the batched cache at the slot, in place
        # (the reference rebuilds the batched cache with .at[].set)
        self.cache["k"].index_copy_(1, self._slot, pc["k"])
        self.cache["v"].index_copy_(1, self._slot, pc["v"])
        self.cache["kv_pos"].index_copy_(0, self._slot, pc["kv_pos"])
        self.cache["pos"].index_copy_(0, self._slot, pc["pos"])
        return torch.argmax(logits[0])

    def _decode_all(self, tokens: np.ndarray) -> torch.Tensor:
        """tokens (slots,): each slot's last token.  Advances every slot;
        returns the next tokens (slots,) on the device."""
        self._tokens.copy_(torch.as_tensor(tokens, dtype=torch.int32))
        return self._run("decode", self._decode_step)

    def _decode_step(self) -> torch.Tensor:
        logits, _ = model_lib.decode_step(self.params, self.cfg, self.cache,
                                          self._tokens)
        return torch.argmax(logits, dim=-1)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submit_time = req.submit_time or time.perf_counter()
        self.waiting.append(req)

    @property
    def n_running(self) -> int:
        return len(self.active)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.active) or bool(self.waiting)

    def _free_slot(self) -> Optional[int]:
        used = set(r.slot for r in self.active.values())
        for s in range(self.slots):
            if s not in used:
                return s
        return None

    def step(self) -> List[Request]:
        """One engine iteration; returns finished requests."""
        finished: List[Request] = []
        slot = self._free_slot()
        if self.waiting and slot is not None:
            req = self.waiting.popleft()
            p = len(req.tokens)
            toks = np.zeros((_bucket(p),), np.int32)
            toks[:p] = req.tokens[:p]
            t0 = time.perf_counter()
            first = int(self._prefill_one(toks, p, slot).cpu())
            dt = time.perf_counter() - t0
            self.pos[slot] = p
            req.slot = slot
            req.generated.append(first)
            req.first_token_time = time.perf_counter()
            self.active[req.rid] = req
            self.cur_tokens[slot] = first
            self.iteration_log.append(
                {"kind": "prefill", "x": p, "dt": dt, "expert": self.name})
            self.iterations["prefill"] += 1
            return finished
        if self.active:
            total_tokens = int(sum(int(self.pos[r.slot])
                                   for r in self.active.values()))
            t0 = time.perf_counter()
            nxt = self._decode_all(self.cur_tokens).cpu().numpy()
            dt = time.perf_counter() - t0
            self.pos += 1              # decode advances every slot, empty ones too
            self.iteration_log.append(
                {"kind": "decode", "x": total_tokens, "dt": dt,
                 "expert": self.name})
            self.iterations["decode"] += 1
            for rid in list(self.active):
                req = self.active[rid]
                tok = int(nxt[req.slot])
                req.generated.append(tok)
                self.cur_tokens[req.slot] = tok
                done = (tok == self.eos or len(req.generated) >= req.max_new
                        or int(self.pos[req.slot]) >= self.max_len - 1)
                if done:
                    req.finish_time = time.perf_counter()
                    finished.append(req)
                    del self.active[rid]
        return finished


def calibrate(server: ExpertServer) -> dict:
    """Fit k1 (prefill s/token) and k2 (decode s/queued-token) from the
    engine's measured iterations: Eq. 13/14 on the port's own hardware."""
    log = server.iteration_log
    pre = [(e["x"], e["dt"]) for e in log if e["kind"] == "prefill"]
    dec = [(e["x"], e["dt"]) for e in log if e["kind"] == "decode"]

    def fit(points):
        if len(points) < 2:
            return 0.0, 0.0
        x = np.array([p[0] for p in points], np.float64)
        y = np.array([p[1] for p in points], np.float64)
        a = np.stack([x, np.ones_like(x)], axis=1)
        coef, *_ = np.linalg.lstsq(a, y, rcond=None)
        return float(coef[0]), float(coef[1])

    k1, b1 = fit(pre)
    k2, b2 = fit(dec)
    return {"k1": max(k1, 0.0), "k1_intercept": b1,
            "k2": max(k2, 0.0), "k2_intercept": b2,
            "n_prefill": len(pre), "n_decode": len(dec)}
