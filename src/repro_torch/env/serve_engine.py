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
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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
    server's life (the iteration log is cleared by calibration)."""

    def __init__(self, name: str, cfg: ModelConfig, params, *,
                 slots: int = 4, max_len: int = 256, eos_token: int = 1):
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

    def _prefill_one(self, tokens: torch.Tensor, length: int, slot: int
                     ) -> torch.Tensor:
        logits, pc = model_lib.prefill(
            self.params, self.cfg, tokens[None], self.max_len,
            lengths=torch.tensor([length], dtype=torch.int32, device=self.device))
        # write the request's cache into the batched cache at `slot`, in
        # place (the reference rebuilds the batched cache with .at[].set)
        self.cache["k"][:, slot] = pc["k"][:, 0]
        self.cache["v"][:, slot] = pc["v"][:, 0]
        self.cache["kv_pos"][slot] = pc["kv_pos"][0]
        self.cache["pos"][slot] = pc["pos"][0]
        return torch.argmax(logits[0])

    def _decode_all(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, self.cache = model_lib.decode_step(self.params, self.cfg,
                                                   self.cache, tokens)
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
            first = self._prefill_one(torch.as_tensor(toks, device=self.device),
                                      p, slot)
            first = int(first.cpu())
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
            tokens = torch.as_tensor(self.cur_tokens, device=self.device)
            total_tokens = int(sum(int(self.pos[r.slot])
                                   for r in self.active.values()))
            t0 = time.perf_counter()
            nxt = self._decode_all(tokens).cpu().numpy()
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
