"""The server's history, worked out from the client's log of iterations and
the tokens the server returned: which token each slot held at each
position, and what each decode step ran.

This is the engine's contract as the client sees it from outside.  A slot
starts empty at position 0 feeding token 0.  A prefill writes the
request's prompt into its slot (positions 0 .. p-1) and returns its first
token; each decode feeds every slot its last token at its position and
advances all of them, empty ones too; a request is done after ``max_new``
tokens, and its slot then keeps feeding its last token.  So a slot's
history is a run of segments, each a sequence of tokens at positions 0, 1,
..., started by a prefill (or by the server's creation) and fed by the
decodes until the next prefill in that slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Segment:
    sid: int
    slot: int
    rid: Optional[int]            # None: the slot's state from the creation
    prompt: np.ndarray            # positions 0 .. p-1
    bucket: int                   # the prefill's padded length (0: none)
    inputs: List[int] = dataclasses.field(default_factory=list)
    served: Sequence[int] = ()    # the request's tokens, as returned

    @property
    def tokens(self) -> np.ndarray:
        """Every token this segment fed, prompt first, by position."""
        return np.concatenate([np.asarray(self.prompt, np.int64),
                               np.asarray(self.inputs, np.int64)])


@dataclasses.dataclass
class DecodeStep:
    index: int                    # into the log
    sids: List[int]               # per slot: its segment
    positions: List[int]          # per slot: the position it was fed at
    active: List[bool]            # per slot: a request was running in it


def replay(log, requests: Dict[int, tuple], slots: int):
    """(segments, decode steps).  ``requests``: rid -> (prompt, served
    tokens, max_new) for every request the log admits."""
    segments: List[Segment] = []
    cur, pos, token, left = [], [0] * slots, [0] * slots, [0] * slots
    for s in range(slots):
        segments.append(Segment(len(segments), s, None,
                                np.zeros((0,), np.int64), 0))
        cur.append(segments[-1])
    steps: List[DecodeStep] = []
    for i, it in enumerate(log):
        if it.kind == "prefill":
            prompt, served, max_new = requests[it.rid]
            seg = Segment(len(segments), it.slot, it.rid, np.asarray(prompt),
                          it.bucket, served=served)
            segments.append(seg)
            cur[it.slot] = seg
            pos[it.slot] = len(prompt)
            token[it.slot] = int(served[0])
            left[it.slot] = max_new - 1
            continue
        steps.append(DecodeStep(i, [c.sid for c in cur], list(pos),
                                [n > 0 for n in left]))
        for s in range(slots):
            seg = cur[s]
            seg.inputs.append(token[s])
            pos[s] += 1
            if left[s] > 0:
                token[s] = int(seg.served[len(seg.inputs)])
                left[s] -= 1
    return segments, steps



def cache_len(model: dict, serve: dict) -> int:
    """The positions a slot's cache holds: the ring of ``min(window,
    max_len)`` under a sliding window, else ``max_len``."""
    if model.get("attention") == "swa":
        return min(model["window"], serve["max_len"])
    return serve["max_len"]


def keys_seen(q: int, attention: str, window: int, cache_len: int) -> int:
    """How many cache entries a token at position ``q`` attends to through
    the slot cache of ``cache_len`` positions: under a sliding window the
    ring holds the last ``min(window, cache_len)``; under full attention
    a position past the cache is written into its last entry, so it sees
    ``cache_len`` entries."""
    if attention == "swa":
        return min(q + 1, window, cache_len)
    return min(q + 1, cache_len)
