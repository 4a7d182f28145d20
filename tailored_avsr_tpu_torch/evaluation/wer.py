"""WER / CER evaluation: edit distance, bootstrap confidence intervals, the
.inf file protocol (counterpart of ``tailored_avsr_tpu/evaluation/wer.py``,
its pure-Python path): "ref#hyp" lines; WER splits on spaces, CER counts
bytes; bootstrap mean and 95 % half-width over seeded resamples.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    n, m = len(ref), len(hyp)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(
                prev[j - 1] + (ref[i - 1] != hyp[j - 1]),
                prev[j] + 1,
                cur[j - 1] + 1,
            )
        prev = cur
    return prev[m]


def _split(s: str, words: bool) -> List:
    """Symbols as the JAX package's scorer counts them: WER splits on the
    space character only; CER counts every byte of the UTF-8 encoding (a
    wrong 'ñ' is 2 edits)."""
    if words:
        return [w for w in s.split(" ") if w]
    return list(s.encode("utf-8"))


def error_rate(pairs: Sequence[Tuple[str, str]], words: bool = True) -> float:
    """Corpus error rate (%) over (ref, hyp) string pairs."""
    edits = total = 0
    for ref, hyp in pairs:
        r, h = _split(ref, words), _split(hyp, words)
        edits += edit_distance(r, h)
        total += len(r)
    return 100.0 * edits / total if total else 0.0


def bootstrap_error_rate(
    pairs: Sequence[Tuple[str, str]],
    words: bool = True,
    resamples: int = 1000,
    seed: int = 0,
) -> Tuple[float, float]:
    """Bootstrap mean ± 95% CI half-width (the tasasIntervalo protocol)."""
    if not pairs:
        raise ValueError(
            "no 'ref#hyp' pairs to score (empty or malformed .inf file)"
        )
    per_sent = []
    for ref, hyp in pairs:
        r, h = _split(ref, words), _split(hyp, words)
        per_sent.append((edit_distance(r, h), len(r)))
    per_sent = np.asarray(per_sent, np.int64)
    rng = np.random.RandomState(seed)
    n = len(per_sent)
    idx = rng.randint(0, n, size=(resamples, n))
    edits = per_sent[idx, 0].sum(axis=1)
    lens = np.maximum(per_sent[idx, 1].sum(axis=1), 1)
    rates = 100.0 * edits / lens
    lo, hi = np.percentile(rates, [2.5, 97.5])
    return float(rates.mean()), float((hi - lo) / 2.0)


def write_inf_file(path: str, pairs: Sequence[Tuple[str, str]]) -> None:
    """Write the 'ref#hyp' .inf protocol."""
    with open(path, "w", encoding="utf-8") as f:
        for ref, hyp in pairs:
            f.write(f"{ref}#{hyp}\n")


def read_inf_file(path: str) -> List[Tuple[str, str]]:
    pairs = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if "#" in line:
                ref, hyp = line.split("#", 1)
                pairs.append((ref, hyp))
    return pairs


def compute_bootstrap_wer(
    path: str, resamples: int = 1000, seed: int = 0
) -> Tuple[float, float, float, float]:
    """(wer, cer, ci_wer, ci_cer) of a .inf file."""
    pairs = read_inf_file(path)
    wer, ci_wer = bootstrap_error_rate(pairs, words=True, resamples=resamples, seed=seed)
    cer, ci_cer = bootstrap_error_rate(pairs, words=False, resamples=resamples, seed=seed)
    return wer, cer, ci_wer, ci_cer


def cer_from_ids(
    refs: Sequence[Sequence[int]], hyps: Sequence[Sequence[int]]
) -> float:
    """Token-level error rate (%) of greedy CTC output: the validation CER."""
    edits = total = 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(list(r), list(h))
        total += len(r)
    return 100.0 * edits / total if total else 0.0
