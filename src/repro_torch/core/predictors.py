"""Generation-score / output-length predictors (port of
``repro/core/predictors.py``, paper §V-B1).

The paper fine-tunes one DistilBERT with a prepended expert token to
predict the 10-bucket generation score and output length of a request on
each expert.  Here, as in the reference, requests carry synthetic token
sequences whose unigram statistics depend on the latent task type, and a
small transformer encoder whose CLS token is the expert token predicts the
buckets.  The env's noise-model predictions stand in for it on the routing
path (``env.predict``).

The type-token table is the reference's numpy draw, bit for bit; every
other draw comes from a ``torch.Generator``.  On CUDA each training step,
its batch draw included, is one CUDA graph replay (the generator
registered with the graph), as the reference jits its ``step_fn``.  The
expert and token lookups are one-hot products, so their backward passes
are products too and add no gradient row by atomics: a replayed step is
bit-equal to the same step run eagerly (``Step(..., graphs=False)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import graphs as graphs_lib
from repro_torch.device import generator, resolve
from repro_torch.env.profiles import ExpertPool, sample_request
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    vocab: int = 512
    seq_len: int = 32
    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    n_buckets: int = 10
    max_output: int = 300
    tokens_per_type: int = 24   # type-characteristic token set size
    type_token_prob: float = 0.6


# ---------------------------------------------------------------------------
# Synthetic request text
# ---------------------------------------------------------------------------


def make_type_token_table(cfg: PredictorConfig, n_types: int, seed: int = 0,
                          device=None) -> torch.Tensor:
    """(n_types, tokens_per_type) int32 on ``device`` (CUDA by default)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, cfg.vocab, size=(n_types, cfg.tokens_per_type))
    return torch.as_tensor(table).to(resolve(device), torch.int32)


def request_text(cfg: PredictorConfig, table: torch.Tensor,
                 ttype: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """(B,) types -> (B, seq_len) tokens: each one of the type's token set
    with probability ``type_token_prob``, else uniform noise."""
    b, s, dev = ttype.shape[0], cfg.seq_len, table.device
    from_type = torch.rand((b, s), generator=gen, device=dev) \
        < cfg.type_token_prob
    pick = torch.randint(0, cfg.tokens_per_type, (b, s), generator=gen,
                         device=dev)
    type_tok = table[ttype.long()[:, None], pick]
    noise_tok = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                              device=dev).to(torch.int32)
    return torch.where(from_type, type_tok, noise_tok)


# ---------------------------------------------------------------------------
# Model: tiny transformer encoder with expert-token conditioning
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        new = lambda *shape: nn.Parameter(torch.empty(shape, device=device))
        self.wqkv, self.wo = new(d, 3 * d), new(d, d)
        self.w1, self.w2 = new(d, 4 * d), new(4 * d, d)
        self.ln1, self.ln2 = new(d), new(d)


class Predictor(nn.Module):
    """The reference's parameter tree as modules: ``embed (vocab + N, d)``,
    ``pos (seq_len + 1, d)``, ``head_score``/``head_len (d, n_buckets)``
    and ``layers.i.{wqkv, wo, w1, w2, ln1, ln2}``, float32."""

    def __init__(self, cfg: PredictorConfig, n_experts: int, device):
        super().__init__()
        d = cfg.d_model
        new = lambda *shape: nn.Parameter(torch.empty(shape, device=device))
        self.embed = new(cfg.vocab + n_experts, d)
        self.pos = new(cfg.seq_len + 1, d)
        self.head_score = new(d, cfg.n_buckets)
        self.head_len = new(d, cfg.n_buckets)
        self.layers = nn.ModuleList(Layer(d, device)
                                    for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: PredictorConfig, n_experts: int, seed: int = 0,
                device=None) -> Predictor:
    """The reference's initialisation (embeddings 0.05, matrices
    ``scale / sqrt(fan_in)`` with ``w2`` at scale 0.5, norms 1), drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve(device)
    gen = generator(dev, seed)
    model = Predictor(cfg, n_experts, dev)
    normal = lambda p, sc: p.copy_(torch.randn(p.shape, generator=gen,
                                               device=dev) * sc)
    normal(model.embed, 0.05)
    normal(model.pos, 0.05)
    for p in (model.head_score, model.head_len):
        normal(p, 1.0 / math.sqrt(p.shape[0]))
    for lp in model.layers:
        for p in (lp.wqkv, lp.wo, lp.w1):
            normal(p, 1.0 / math.sqrt(p.shape[0]))
        normal(lp.w2, 0.5 / math.sqrt(lp.w2.shape[0]))
        lp.ln1.fill_(1.0)
        lp.ln2.fill_(1.0)
    return model


def count_params(params: Predictor) -> int:
    return sum(p.numel() for p in params.parameters())


def _ln(x, g):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g


def forward(params: Predictor, cfg: PredictorConfig, tokens: torch.Tensor,
            expert_id: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), expert_id (B,) -> (score_logits, len_logits), each
    (B, n_buckets).  The CLS position holds the expert token ``vocab +
    expert_id``."""
    b, s = tokens.shape
    seq = torch.cat([cfg.vocab + expert_id.long()[:, None], tokens.long()], 1)
    onehot = F.one_hot(seq, params.embed.shape[0]).to(params.embed.dtype)
    x = onehot @ params.embed + params.pos[None, :s + 1]
    h = cfg.n_heads
    dh = cfg.d_model // h
    for lp in params.layers:
        xn = _ln(x, lp.ln1)
        q, k, v = (xn @ lp.wqkv).split(cfg.d_model, dim=-1)
        heads = lambda t: t.reshape(b, s + 1, h, dh).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        a = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(dh), dim=-1)
        o = (a @ v).transpose(1, 2).reshape(b, s + 1, cfg.d_model)
        x = x + o @ lp.wo
        xn = _ln(x, lp.ln2)
        x = x + F.gelu(xn @ lp.w1, approximate="tanh") @ lp.w2
    cls = x[:, 0]
    return cls @ params.head_score, cls @ params.head_len


# ---------------------------------------------------------------------------
# Dataset + training
# ---------------------------------------------------------------------------


def buckets(cfg: PredictorConfig, score: torch.Tensor, out_len: torch.Tensor):
    """(score bucket, length bucket), int32: ``score * n_buckets``
    truncated and ``out_len * n_buckets // max_output``, each clipped to
    ``0 .. n_buckets - 1``."""
    top = cfg.n_buckets - 1
    sb = torch.clamp((score * cfg.n_buckets).to(torch.int32), 0, top)
    lb = torch.clamp(out_len.to(torch.int32) * cfg.n_buckets
                     // cfg.max_output, 0, top)
    return sb, lb


def make_batch(cfg: PredictorConfig, pool: ExpertPool, table: torch.Tensor,
               gen: torch.Generator, batch: int) -> dict:
    """A batch of (text, expert, score bucket, length bucket) drawn from
    ``gen``: a request per row, its text, and a random expert whose
    ground truth gives the buckets."""
    r = sample_request(pool, gen, batch)
    text = request_text(cfg, table, r["type"], gen)
    n = torch.randint(0, pool.n_experts, (batch,), generator=gen,
                      device=table.device)
    rows = torch.arange(batch, device=table.device)
    sb, lb = buckets(cfg, r["score"][rows, n], r["out_len"][rows, n])
    return {"text": text, "expert": n.to(torch.int32), "score_bucket": sb,
            "len_bucket": lb}


def loss_fn(params: Predictor, cfg: PredictorConfig, b: dict) -> torch.Tensor:
    """The two buckets' cross entropies, summed."""
    ls, ll = forward(params, cfg, b["text"], b["expert"])
    ce = lambda lg, y: -F.log_softmax(lg, -1).gather(
        -1, y.long()[:, None]).mean()
    return ce(ls, b["score_bucket"]) + ce(ll, b["len_bucket"])


class Step:
    """One training step (a batch drawn from ``gen``, the loss gradient,
    AdamW) on ``params`` in place; ``run()`` returns the loss, from the
    CUDA graph after the first step when ``graphs`` and on the card."""

    def __init__(self, cfg: PredictorConfig, pool: ExpertPool,
                 table: torch.Tensor, params: Predictor, opt,
                 gen: torch.Generator, batch: int, graphs: bool = True):
        self.cfg, self.pool, self.table = cfg, pool, table
        self.params, self.opt, self.gen, self.batch = params, opt, gen, batch
        self.graphs = graphs and table.is_cuda
        self.graph = None

    def _step(self) -> torch.Tensor:
        b = make_batch(self.cfg, self.pool, self.table, self.gen, self.batch)
        tensors = self.opt.tensors()
        with torch.enable_grad():
            loss = loss_fn(self.params, self.cfg, b)
            grads = torch.autograd.grad(loss, tensors)
        self.opt.update(grads)
        self.opt.step.add_(1)
        return loss.detach()

    def run(self) -> torch.Tensor:
        if not self.graphs:
            return self._step()
        if self.graph is None:
            self.graph, loss = graphs_lib.capture(self._step, (self.gen,))
            return loss
        return self.graph.replay().clone()


def make_optimizer(params: Predictor, steps: int, lr: float):
    """The reference's AdamW: warmup 50, weight decay 0."""
    return opt_lib.make_optimizer("adamw", peak_lr=lr, warmup_steps=50,
                                  total_steps=steps, weight_decay=0.0)(
        dict(params.named_parameters()))


def train(cfg: PredictorConfig, pool: ExpertPool, *, steps: int = 1500,
          batch: int = 256, lr: float = 1e-3, seed: int = 0,
          log_every: int = 250, log_fn=print
          ) -> Tuple[Predictor, Dict[str, float]]:
    """Train on the pool's device, each step after the first replayed
    from a CUDA graph there; returns (params, ``evaluate``'s metrics on
    fresh requests)."""
    dev = pool.k1.device
    table = make_type_token_table(cfg, pool.n_types, seed, device=dev)
    params = init_params(cfg, pool.n_experts, seed, device=dev)
    opt = make_optimizer(params, steps, lr)
    step = Step(cfg, pool, table, params, opt, generator(dev, seed), batch)
    for i in range(steps):
        loss = step.run()
        if log_fn and (i % log_every == 0 or i == steps - 1):
            log_fn({"step": i, "loss": float(loss)})
    return params, evaluate(cfg, pool, table, params, seed=seed + 1)


@torch.no_grad()
def evaluate(cfg: PredictorConfig, pool: ExpertPool, table: torch.Tensor,
             params: Predictor, *, n: int = 4096, seed: int = 1
             ) -> Dict[str, float]:
    """Top-1 and top-3 accuracy of both heads on ``n`` fresh requests, and
    the parameter count."""
    b = make_batch(cfg, pool, table, generator(table.device, seed), n)
    ls, ll = forward(params, cfg, b["text"], b["expert"])

    def topk_acc(logits, y, k):
        top = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
        return float((top == y.long()[:, None]).any(-1).float().mean())

    return {
        "score_top1": topk_acc(ls, b["score_bucket"], 1),
        "score_top3": topk_acc(ls, b["score_bucket"], 3),
        "len_top1": topk_acc(ll, b["len_bucket"], 1),
        "len_top3": topk_acc(ll, b["len_bucket"], 3),
        "n_params": count_params(params),
    }
