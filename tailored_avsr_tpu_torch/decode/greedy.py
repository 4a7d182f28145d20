"""Greedy CTC decoding: best path -> collapse repeats -> drop blanks
(counterpart of ``tailored_avsr_tpu/decode/greedy.py``, ported because that
package's ``decode/__init__.py`` imports the JAX beam search).

Host-side: the argmax runs on the device in the model (``CTCHead.argmax``);
the collapse is O(T) list work.
"""

from __future__ import annotations

from typing import List

import numpy as np


def ctc_greedy_collapse(ids: np.ndarray, lengths: np.ndarray, blank_id: int = 0) -> List[List[int]]:
    """(B, T) argmax ids + (B,) lengths -> list of collapsed token id lists."""
    ids = np.asarray(ids)
    lengths = np.asarray(lengths)
    out = []
    for b in range(ids.shape[0]):
        prev = -1
        toks = []
        for t in ids[b, : int(lengths[b])]:
            t = int(t)
            if t != prev and t != blank_id:
                toks.append(t)
            prev = t
        out.append(toks)
    return out
