"""Judging a served CTC transcript against the reference's log-probs.

A greedy transcript is the collapse of one frame path. Its gap is the
least, over every CTC alignment of the transcript to the utterance's
frames, of the widest shortfall of an aligned token's log-prob below the
frame's best: 0 when the transcript is the collapse of the reference's
best path, small when the program's path departs from it only where two
tokens nearly tie, and large when a token was served that the reference
puts well below the best. An alignment that cannot exist (more frames
needed than there are) gives inf.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def collapse(path: Sequence[int], blank: int = 0) -> List[int]:
    out, prev = [], -1
    for t in path:
        t = int(t)
        if t != prev and t != blank:
            out.append(t)
        prev = t
    return out


def text_to_ids(text: str, tokens: Sequence[str], space: str = "<space>") -> List[int]:
    """A char-token transcript back to its ids: ``<...>`` symbols whole,
    a space as ``space``, every other character alone. Raises on a
    character that is no token."""
    index = {t: i for i, t in enumerate(tokens)}
    specials = sorted((t for t in tokens if len(t) > 1), key=len, reverse=True)
    ids, i = [], 0
    while i < len(text):
        for s in specials:
            if text.startswith(s, i) and s != space:
                ids.append(index[s])
                i += len(s)
                break
        else:
            c = space if text[i] == " " else text[i]
            if c not in index:
                raise ValueError(f"{text[i]!r} is no token")
            ids.append(index[c])
            i += 1
    return ids


def ids_to_text(ids: Sequence[int], tokens: Sequence[str], space: str = "<space>") -> str:
    return "".join(" " if tokens[i] == space else tokens[i] for i in ids)


def minmax_gap(logp: np.ndarray, ids: Sequence[int], blank: int = 0) -> float:
    """The transcript ``ids``' gap over ``logp`` (T, V), the utterance's
    valid frames: min over alignments of max over frames of
    (best log-prob - aligned token's log-prob)."""
    t_len = logp.shape[0]
    short = logp.max(axis=1, keepdims=True) - logp  # (T, V) shortfall of each token
    ext = np.full(2 * len(ids) + 1, blank, np.int64)
    ext[1::2] = ids
    s_len = len(ext)
    if t_len == 0:
        return 0.0 if not ids else float("inf")
    cost = short[:, ext]  # (T, S)
    skip = np.zeros(s_len, bool)
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    d = np.full(s_len, np.inf)
    d[0] = cost[0, 0]
    if s_len > 1:
        d[1] = cost[0, 1]
    for t in range(1, t_len):
        best = d.copy()
        best[1:] = np.minimum(best[1:], d[:-1])
        best[2:] = np.where(skip[2:], np.minimum(best[2:], d[:-2]), best[2:])
        d = np.maximum(best, cost[t])
    return float(min(d[-1], d[-2]) if s_len > 1 else d[-1])
