"""Character n-gram LM scorer for shallow fusion (counterpart of
``tailored_avsr_tpu/decode/ngram.py``).

The ARPA file is parsed on the host (``parse_arpa``) and, for a
character vocabulary, turned into a dense (V^(order-1) contexts, V) table
of backoff-resolved log-probabilities, which lives on the device. Scoring
a beam step is then one gather: ``score_step`` (every token, the
``full`` scorer), ``score_step_candidates`` (the pre-beam candidates, the
``part`` scorer) and ``score_candidates`` (one candidate a row, the
time-synchronous beam). Nothing here needs a kernel: the JAX scorer is XLA
gathers too. ``write_arpa`` counts a token n-gram model from token
sequences (absolute discounting) into an ARPA file.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

LOG10 = math.log(10.0)


def parse_arpa(path: str) -> Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]]:
    """ARPA -> {order: {n-gram tuple: (log-prob, backoff)}}, natural logs."""
    tables: Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]] = {}
    order = 0
    section = re.compile(r"\\(\d+)-grams:")
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("\\data") or line == "\\end\\" or line.startswith("ngram "):
                continue
            m = section.fullmatch(line)
            if m:
                order = int(m.group(1))
                tables[order] = {}
                continue
            if order == 0:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            backoff = float(parts[2]) * LOG10 if len(parts) > 2 else 0.0
            tables[order][tuple(parts[1].split())] = (float(parts[0]) * LOG10, backoff)
    return tables


def write_arpa(path: str, sentences: Iterable[Sequence[str]], order: int = 3, discount: float = 0.5) -> None:
    """An ARPA file of the token n-grams (up to ``order``) seen in
    ``sentences``: unigrams by relative frequency, a longer n-gram
    log10((count - discount) / context count), and each context's backoff
    log10(discount * its distinct continuations / its count), the mass the
    discount freed."""
    counts = [Counter() for _ in range(order + 1)]
    for sent in sentences:
        toks = tuple(sent)
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                counts[n][toks[i:i + n]] += 1
    total = sum(counts[1].values())
    follow = Counter(ng[:-1] for n in range(2, order + 1) for ng in counts[n])
    lines = ["\\data\\"] + [f"ngram {n}={len(counts[n])}" for n in range(1, order + 1)]
    for n in range(1, order + 1):
        lines += ["", f"\\{n}-grams:"]
        for ng, c in sorted(counts[n].items()):
            ctx = counts[n - 1][ng[:-1]] if n > 1 else total
            logp = math.log10((c - discount) / ctx if n > 1 else c / ctx)
            row = f"{logp:.6f}\t{' '.join(ng)}"
            if n < order and follow[ng]:
                row += f"\t{math.log10(discount * follow[ng] / c):.6f}"
            lines.append(row)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))


class NgramScorer:
    """The dense-table n-gram scorer; ``table`` is (V^(order-1), V) f32 on
    ``device``, context rows indexed with the most recent token as the
    lowest base-V digit."""

    def __init__(self, arpa_path: str, token_list: Sequence[str], order: int = 3, *, device=None):
        self.token_list = list(token_list)
        v = len(self.token_list)
        tables = parse_arpa(arpa_path)
        order = min(order, max(tables) if tables else 1)
        self.order = order

        def cond_logp(context: Tuple[str, ...], w: str) -> float:
            """Backoff-resolved log P(w | context)."""
            for k in range(len(context), -1, -1):
                ng = context[len(context) - k:] + (w,)
                tab = tables.get(k + 1, {})
                if ng in tab:
                    bo = 0.0  # the backoff weights of the longer contexts skipped
                    for j in range(k, len(context)):
                        entry = tables.get(j + 1, {}).get(context[len(context) - j - 1:])
                        if entry is not None:
                            bo += entry[1]
                    return tab[ng][0] + bo
            return -20.0  # OOV floor

        def ctx_tokens(idx: int) -> Tuple[str, ...]:
            toks = []
            for _ in range(order - 1):
                toks.append(self.token_list[idx % v])
                idx //= v
            return tuple(reversed(toks))

        n_ctx = v ** (order - 1)
        table = np.zeros((n_ctx, v), np.float32)
        for ci in range(n_ctx):
            context = ctx_tokens(ci)
            for wi, w in enumerate(self.token_list):
                table[ci, wi] = cond_logp(context, w)
        self.table = torch.from_numpy(table).to(device)
        self.vocab = v

    def _index(self, tokens: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
        """Context rows of (N, L) buffers whose most recent token sits at
        column ``last`` (N,) (a column < 0 reads as token 0)."""
        n, l = tokens.shape
        idx = torch.zeros(n, dtype=torch.long, device=tokens.device)
        for j in range(self.order - 1):
            p = last - j
            tok = torch.gather(tokens, 1, torch.clamp(p, 0, l - 1)[:, None])[:, 0]
            idx = idx + torch.where(p >= 0, tok, 0).long() * (self.vocab ** j)
        return idx

    def context_index(self, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """(N, L) sos-prefixed buffers, host ``pos`` -> (N,) context rows."""
        return self._index(ys, torch.full((ys.shape[0],), pos - 1, dtype=torch.long, device=ys.device))

    def score_step(self, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """(N, L), ``pos`` -> (N, V) conditional log-probs (the full scorer)."""
        return self.table[self.context_index(ys, pos)]

    def score_step_candidates(self, ys: torch.Tensor, pos: int, cand: torch.Tensor) -> torch.Tensor:
        """The part scorer: (N, P) pre-beam candidates -> (N, P) log-probs."""
        return self.table[self.context_index(ys, pos)[:, None], cand]

    def score_candidates(self, tokens: torch.Tensor, lengths: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """The time-synchronous form: (N, L) buffers with no sos and per-row
        ``lengths``, one candidate a row -> (N,) log-probs."""
        return self.table[self._index(tokens, lengths.long() - 1), cand]
