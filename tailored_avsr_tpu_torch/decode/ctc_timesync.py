"""Time-synchronous CTC prefix beam search (counterpart of
``tailored_avsr_tpu/decode/ctc_timesync.py``).

The search advances frame by frame: K beams live as a (B, K, Lmax) token
buffer with per-beam blank / non-blank log-probabilities; each frame
proposes K stay candidates (blank, or a repeat of the last token) and K * P
extensions by the frame's top P tokens, merges candidates that spell the
same prefix (two rolling 32-bit hashes, a stable sort by the first and a
log-sum-exp over each run of equal hashes) and keeps the K best. An
n-gram scorer over each extension's last tokens and a per-token bonus ride
in the beams' fusion score. Frames at or past an utterance's length leave
its state as it is, so a length-0 utterance ends with the empty prefix.

The JAX ``fori_loop`` over frames becomes a Python loop with no host
synchronisation in it: every step is device ops, the frame index a host
integer. Ties break as in JAX: ``jnp.argsort`` is stable and
``jax.lax.top_k`` keeps the lower index, so the sorts here are stable and
the top-k is ``decode/beam_search.top_k``. The unsigned hashes are int64
values masked to 32 bits after each multiply-add (the same wrap-around).
The state is chunk-chainable: ``ctc_timesync_chunk`` over successive
chunks equals one pass over their concatenation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tailored_avsr_tpu_torch.decode.beam_search import top_k

NEG_INF = -1.0e30
_H1, _H2 = 1000003, 10000019  # rolling-hash multipliers
_MASK32 = 0xFFFFFFFF


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis`` over the beam axis (1) of 2-D or higher state."""
    if x.dim() > 2:
        idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m_safe = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    out = m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))
    return torch.where((a <= NEG_INF) & (b <= NEG_INF), NEG_INF, out)


def timesync_init_state(b: int, beam_size: int, max_len: int, device=None):
    """Fresh state: beam 0 holds the empty prefix, the others are dead with
    distinct hashes. (tokens, lengths, log_pb, log_pnb, fusion, h1, h2,
    last token)."""
    k = beam_size
    tokens = torch.zeros((b, k, max_len), dtype=torch.long, device=device)
    tok_len = torch.zeros((b, k), dtype=torch.long, device=device)
    log_pb = torch.full((b, k), NEG_INF, device=device)
    log_pb[:, 0] = 0.0
    log_pnb = torch.full((b, k), NEG_INF, device=device)
    fusion = torch.zeros((b, k), device=device)
    h1 = torch.arange(1, k + 1, dtype=torch.long, device=device)[None].expand(b, k).clone()
    h2 = (h1 * 2654435761) & _MASK32
    last = torch.full((b, k), -1, dtype=torch.long, device=device)
    return (tokens, tok_len, log_pb, log_pnb, fusion, h1, h2, last)


def timesync_best(state):
    """(tokens (B, K, L), lengths (B, K), scores, ctc scores), best first by
    score = CTC log-prob + fusion."""
    tokens, tok_len, log_pb, log_pnb, fusion = state[:5]
    ctc_score = _logaddexp(log_pb, log_pnb)
    score = ctc_score + fusion
    order = torch.sort(-score, dim=1, stable=True).indices
    return tuple(_gather_beams(x, order) for x in (tokens, tok_len, score, ctc_score))


def ctc_timesync_beam_search(
    log_probs: torch.Tensor,  # (B, T, V) CTC log-softmax
    lengths: torch.Tensor,  # (B,)
    beam_size: int = 10,
    pre_beam: int = 10,
    blank_id: int = 0,
    max_len: int = 200,
    penalty: float = 0.0,
    ngram_scorer: Optional[Callable] = None,  # (tokens (N, L), lens (N,), cand (N,)) -> (N,)
    ngram_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (tokens (B, K, max_len), lengths (B, K), scores (B, K), CTC scores
    (B, K)), best first by score = CTC log-prob + fusion (the per-token
    ``penalty`` and the weighted n-gram)."""
    b, t, _ = log_probs.shape
    state = timesync_init_state(b, beam_size, max_len, device=log_probs.device)
    state = ctc_timesync_chunk(log_probs, lengths, state, beam_size, pre_beam, blank_id, penalty,
                               ngram_scorer, ngram_weight)
    return timesync_best(state)


def ctc_timesync_chunk(
    log_probs: torch.Tensor,  # (B, Tc, V) CTC log-softmax of this chunk
    valid_lengths: torch.Tensor,  # (B,) valid frames within the chunk
    state,
    beam_size: int = 10,
    pre_beam: int = 10,
    blank_id: int = 0,
    penalty: float = 0.0,
    ngram_scorer: Optional[Callable] = None,
    ngram_weight: float = 0.0,
):
    """The state after one chunk of frames; read partial hypotheses at any
    point with ``timesync_best``."""
    step = _make_step(log_probs, valid_lengths, beam_size, pre_beam, blank_id, penalty, ngram_scorer,
                      ngram_weight)
    for ti in range(log_probs.shape[1]):
        state = step(ti, state)
    return state


def _make_step(log_probs, lengths, beam_size, pre_beam, blank_id, penalty, ngram_scorer, ngram_weight):
    b, _, v = log_probs.shape
    dev = log_probs.device
    k = beam_size
    p = min(pre_beam, v - 1)
    n = k * (p + 1)  # stay + extensions a beam
    lengths = lengths.to(device=dev)
    not_blank = torch.arange(v, device=dev) != blank_id
    slots = torch.arange(n, device=dev)[None].expand(b, n)

    def seg_lse(x, seg):  # per utterance, the log-sum-exp of each segment into n slots
        m = torch.full((b, n), float("-inf"), device=dev).scatter_reduce(1, seg, x, "amax")
        m = torch.clamp(m, min=NEG_INF)
        s = torch.zeros((b, n), device=dev).scatter_add(1, seg, torch.exp(x - torch.gather(m, 1, seg)))
        return torch.where(s > 0, m + torch.log(s), NEG_INF)

    def step(ti, state):
        tokens, tok_len, log_pb, log_pnb, fusion, h1, h2, last = state
        max_len = tokens.shape[-1]
        lp = log_probs[:, ti]  # (B, V)
        active = ti < lengths  # (B,)

        # stay candidates, one a beam: the prefix unchanged
        stay_pb = _logaddexp(log_pb, log_pnb) + lp[:, blank_id][:, None]
        rep = torch.gather(lp, 1, torch.clamp(last, 0, v - 1))
        stay_pnb = torch.where(last >= 0, log_pnb + rep, NEG_INF)

        # extension candidates: the frame's top P non-blank tokens
        top_lp, top_ids = top_k(torch.where(not_blank, lp, NEG_INF), p)  # (B, P)
        cand = top_ids[:, None, :]  # (B, 1, P)
        is_rep = cand == last[:, :, None]  # a repeat must cross a blank
        base = torch.where(is_rep, log_pb[:, :, None], _logaddexp(log_pb, log_pnb)[:, :, None])
        ext_pnb = base + top_lp[:, None, :]  # (B, K, P)
        ext_pnb = torch.where((tok_len >= max_len)[:, :, None], NEG_INF, ext_pnb)
        ext_fusion = fusion[:, :, None].expand(b, k, p) + penalty
        if ngram_scorer is not None and ngram_weight != 0.0:
            flat_tok = tokens[:, :, None, :].expand(b, k, p, max_len).reshape(b * k * p, max_len)
            flat_len = tok_len[:, :, None].expand(b, k, p).reshape(-1)
            flat_cand = cand.expand(b, k, p).reshape(-1)
            ext_fusion = ext_fusion + ngram_weight * ngram_scorer(flat_tok, flat_len, flat_cand).reshape(b, k, p)
        ext_h1 = (h1[:, :, None] * _H1 + cand + 1) & _MASK32
        ext_h2 = (h2[:, :, None] * _H2 + cand + 1) & _MASK32

        def cat(stay, ext):  # (B, K) + (B, K, P) -> (B, N)
            return torch.cat([stay, ext.reshape(b, -1)], dim=1)

        c_pb = cat(stay_pb, torch.full((b, k, p), NEG_INF, device=dev))
        c_pnb = cat(stay_pnb, ext_pnb)
        c_fus = cat(fusion, ext_fusion)
        c_h1, c_h2 = cat(h1, ext_h1), cat(h2, ext_h2)
        c_last = cat(last, cand.expand(b, k, p))
        c_len = cat(tok_len, torch.clamp(tok_len + 1, max=max_len)[:, :, None].expand(b, k, p))
        at_end = torch.arange(max_len, device=dev)[None, None, None, :] == tok_len[:, :, None, None]
        ext_tok = torch.where(at_end, cand[..., None], tokens[:, :, None, :])  # (B, K, P, L)
        c_tok = torch.cat([tokens, ext_tok.reshape(b, -1, max_len)], dim=1)  # (B, N, L)

        # merge equal prefixes: stable sort by hash, log-sum-exp each run
        order = torch.sort(c_h1, dim=1, stable=True).indices
        s_h1, s_h2, s_pb, s_pnb, s_fus, s_last, s_len, s_tok = (
            _gather_beams(x, order) for x in (c_h1, c_h2, c_pb, c_pnb, c_fus, c_last, c_len, c_tok))
        same = (s_h1 == torch.roll(s_h1, 1, dims=1)) & (s_h2 == torch.roll(s_h2, 1, dims=1))
        same[:, 0] = False
        seg = torch.cumsum((~same).long(), dim=1) - 1  # (B, N) segment ids
        m_pb, m_pnb = seg_lse(s_pb, seg), seg_lse(s_pnb, seg)
        # a segment's representative is its first row (tokens, fusion, ...)
        firsts = torch.full((b, n), n, dtype=torch.long, device=dev).scatter_reduce(1, seg, slots, "amin")
        seg_valid = slots < (seg[:, -1] + 1)[:, None]
        firsts = torch.where(seg_valid, firsts, 0)
        r_fus, r_last, r_len, r_tok, r_h1, r_h2 = (
            _gather_beams(x, firsts) for x in (s_fus, s_last, s_len, s_tok, s_h1, s_h2))
        score = torch.where(seg_valid, _logaddexp(m_pb, m_pnb) + r_fus, NEG_INF)

        keep = top_k(score, k)[1]  # (B, K)
        new = tuple(_gather_beams(x, keep) for x in (r_tok, r_len, m_pb, m_pnb, r_fus, r_h1, r_h2, r_last))
        # frames past an utterance's length leave its state untouched
        return tuple(torch.where(active.reshape((b,) + (1,) * (a.dim() - 1)), a, o) for a, o in zip(new, state))

    return step
