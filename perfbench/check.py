"""Whether what the timed path served is right: a sample of the finished
requests, drawn from the seed, judged against the plain reference over
the history that produced them.

The reference is the configuration's (``perfbench/references/``).  The
sample holds the longest finished request, then others in an order
drawn from the seed, until it holds ``sample_tokens`` served tokens.  For
each served token the reference computes the logits at its position from
the prompt and the tokens served before it (the server fed exactly
those), and the token's gap is how far its logit lies below the
reference's best.  The numbers read are the widest gap and the mean gap
over the judged tokens; a cell's file names those it compares, each with
its limit.

A dense model's requests do not meet in the computation, so only the
sampled requests' own segments are run.  An MoE decode routes every
slot's token together and each expert keeps only its first ``capacity``
assignments, so a token's output depends on the other slots' tokens; the
reference then runs the server's whole history, from its creation, with
the tokens of each prefill and of each decode routed together as the
server routed them (``history.replay``), and judges only the tokens whose
routing it can settle (``references/transformer.py moe``).

The control (``precision="fp8"``) puts the reference with fp8 weights in
the program's place: at each judged position its own first token, judged
by the float32 reference in the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench import history
from perfbench.traffic import seed_bits


@dataclasses.dataclass
class Served:
    """A request as the server handled it."""
    rid: int
    prompt: np.ndarray
    max_new: int
    tokens: List[int]           # the tokens it returned
    done: bool                  # finished by the end of the drain


def sample(finished: Sequence[Served], seed: int, tokens: int) -> List[int]:
    """rids of the longest finished request (the lowest rid among equals),
    then of others in an order drawn from ``seed``, until they hold
    ``tokens`` served tokens."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in finished if r.rid != longest.rid]
    order = np.random.default_rng([seed_bits(seed), 7]).permutation(len(rest))
    out, total = [longest.rid], len(longest.tokens)
    for i in order:
        if total >= tokens:
            break
        out.append(rest[i].rid)
        total += len(rest[i].tokens)
    return out


@dataclasses.dataclass
class Inputs:
    segments: List[np.ndarray]
    judged: np.ndarray          # flat index of each judged position
    served: np.ndarray          # the token served from it
    groups: list                # MoE: (flat indices, tokens routed together)


def inputs(model: dict, slots: int, log, requests: Dict[int, Served],
           rids: Sequence[int]) -> Inputs:
    """The reference's inputs for judging the requests ``rids``: their own
    segments for a dense model, the whole history for an MoE model."""
    if model["family"] != "moe":
        segs, judged, served, off = [], [], [], 0
        for rid in rids:
            r = requests[rid]
            p, n = len(r.prompt), len(r.tokens)
            segs.append(np.concatenate([np.asarray(r.prompt, np.int64),
                                        np.asarray(r.tokens[:-1], np.int64)]))
            judged.append(off + p - 1 + np.arange(n))
            served.append(np.asarray(r.tokens, np.int64))
            off += len(segs[-1])
        return Inputs(segs, np.concatenate(judged), np.concatenate(served), [])
    table = {rid: (r.prompt, r.tokens, r.max_new)
             for rid, r in requests.items()}
    segments, steps = history.replay(log, table, slots)
    segs = [s.tokens for s in segments]
    start = np.concatenate([[0], np.cumsum([len(s) for s in segs])])
    groups = []
    for s in segments:
        if s.rid is not None:
            groups.append((start[s.sid] + np.arange(len(s.prompt)), s.bucket))
    for st in steps:
        groups.append((np.array([start[sid] + q for sid, q
                                 in zip(st.sids, st.positions)]), slots))
    by_rid = {s.rid: s for s in segments if s.rid is not None}
    judged, served = [], []
    for rid in rids:
        s, r = by_rid[rid], requests[rid]
        judged.append(start[s.sid] + len(s.prompt) - 1
                      + np.arange(len(r.tokens)))
        served.append(np.asarray(r.tokens, np.int64))
    return Inputs(segs, np.concatenate(judged), np.concatenate(served), groups)


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]


def judge(reference, model: dict, serve: dict, weights: dict, inp: Inputs,
          margin: float, device, control: bool = False) -> dict:
    """Readings of the served tokens against the float32 reference: the
    widest and the mean gap over the settled judged tokens, how many were
    judged and how many left unsettled; with ``control``, the same of the
    fp8 reference's own first tokens over the same positions.
    ``reference``: the configuration's module of ``perfbench/references``."""
    cache_len = history.cache_len(model, serve)
    run = lambda precision: reference.forward(
        reference.Weights(weights, precision), model, cache_len, inp.segments,
        inp.judged, inp.groups, margin, device)
    widest = lambda g: float(g.max()) if g.numel() else float("nan")
    mean = lambda g: float(g.mean()) if g.numel() else float("nan")
    with torch.no_grad():
        logits, unsettled = run("float32")
        keep = ~unsettled
        served = torch.as_tensor(inp.served, device=logits.device)
        g = gaps(logits, served)
        out = {"max_gap": widest(g[keep]), "mean_gap": mean(g[keep]),
               "judged": int(keep.sum()), "unsettled": int(unsettled.sum())}
        if control:
            low, _ = run("fp8")
            c = gaps(logits, low.argmax(-1))
            out["control_max_gap"] = widest(c[keep])
            out["control_mean_gap"] = mean(c[keep])
            del low
        del logits
    return out
