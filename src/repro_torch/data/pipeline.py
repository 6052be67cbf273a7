"""Deterministic synthetic LM data (port of ``repro/data/pipeline.py``).

A Markov n-gram mixture corpus: each "domain" has its own successor table,
so a small model measurably learns (its loss drops below the unigram
entropy).  A step's batch depends on ``(seed, step)`` alone: its draws (each
row's domain, first token and branch choices) come from a
``torch.Generator`` seeded with both, so a restart at step k reproduces
the stream.  The tables are the reference's numpy draws, bit for bit; the
per-step draws are the port's own (the reference's come from a JAX key),
and ``walk`` takes either.  Batches keep the trainer's microbatch layout
(M, B/M, S).

On a mesh (``SyntheticLM(cfg, mesh)``) each data rank draws the same
global batch from the seed and keeps its rows by ``sharding_``, a spec
(the default ``distributed.sharding.batch_spec``: dim 0, or dim 1 of
(M, B/M, S), over the data axes), so a mesh changes no token and a
restart on another mesh continues the same stream.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    n_domains: int = 4
    branching: int = 8       # successors per token
    seed: int = 0


def _domain_tables(cfg: DataConfig) -> np.ndarray:
    """(n_domains, vocab, branching) successor tables."""
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, cfg.vocab,
                        size=(cfg.n_domains, cfg.vocab, cfg.branching))


def walk(tables: torch.Tensor, domain: torch.Tensor, tok0: torch.Tensor,
         branch: torch.Tensor) -> torch.Tensor:
    """The Markov walk: ``tok_t = tables[domain, tok_{t-1}, branch[:, t]]``
    from ``tok0`` (B,), for t in 0..S-1 of ``branch`` (B, S); returns the
    (B, S) tokens (``tok0`` itself is not among them)."""
    out = []
    tok = tok0
    for t in range(branch.shape[1]):
        tok = tables[domain, tok, branch[:, t]]
        out.append(tok)
    return torch.stack(out, dim=1)


class SyntheticLM:
    """``batch(step)`` -> ``{"tokens": (B, S) or (M, B/M, S) int32}`` on
    ``device`` (CUDA by default), this rank's rows of it on a ``mesh``;
    iterating yields steps 0, 1, ...."""

    def __init__(self, cfg: DataConfig, mesh=None, sharding_=None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and sharding_ is None:
            sharding_ = sharding.batch_spec(mesh, cfg.global_batch,
                                            cfg.microbatches)
        self.sharding = sharding_
        self.device = resolve(device)
        self.tables = torch.as_tensor(_domain_tables(cfg)).to(
            self.device, torch.int64)

    def draws(self, step: int) -> dict:
        """Step ``step``'s draws, from a CPU generator seeded with (seed,
        step): domain (B,), tok0 (B,), branch (B, S)."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed * 2 ** 32 + int(step))
        b = cfg.global_batch
        return {"domain": torch.randint(0, cfg.n_domains, (b,), generator=gen),
                "tok0": torch.randint(0, cfg.vocab, (b,), generator=gen),
                "branch": torch.randint(0, cfg.branching, (b, cfg.seq_len),
                                        generator=gen)}

    def tokens(self, draws: dict) -> torch.Tensor:
        """The batch's tokens from ``draws`` (``draws()``'s, or the
        reference's), in the microbatch layout."""
        cfg = self.cfg
        d = {k: torch.as_tensor(np.array(v)).to(self.device, torch.int64)
             for k, v in draws.items()}
        tokens = walk(self.tables, d["domain"], d["tok0"], d["branch"])
        tokens = tokens.to(torch.int32)
        if cfg.microbatches > 1:
            tokens = tokens.reshape(cfg.microbatches,
                                    cfg.global_batch // cfg.microbatches,
                                    cfg.seq_len)
        if self.sharding is not None:
            tokens = sharding.local_shard(tokens, self.sharding,
                                          self.mesh).contiguous()
        return tokens

    def batch(self, step: int) -> dict:
        return {"tokens": self.tokens(self.draws(step))}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
