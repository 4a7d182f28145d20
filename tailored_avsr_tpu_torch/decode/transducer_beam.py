"""Transducer beam search, alignment-length synchronous (ALSD)
(counterpart of ``tailored_avsr_tpu/decode/transducer_beam.py``).

Every step extends each of the (B, K) hypotheses by one symbol: the blank
(advance one encoder frame) or one of its ``prune_tokens`` best tokens
(stay on the frame, grow the label prefix). The search runs a fixed
``T + max_symbols`` steps, as the JAX ``fori_loop`` does; hypotheses that
consume all their frames move into a finished buffer by a top-k merge.
With ``merge_prefixes`` the candidates of equal (label prefix, encoder
frame) are merged before the beam's top-k: the lowest-index one takes the
log-sum-exp of the group's scores and the others retire.

Every top-k is the port's stable descending sort (``decode/beam_search.top_k``),
ties to the lower index as ``jax.lax.top_k``. The prefix merge compares
the (B, C, C, Lmax) token prefixes (C = K * (prune_tokens + 1)) in int32
and bool: at beam 30, B = 32 and Lmax = 99 that is 71M booleans a step.
Nothing here reads the device from the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tailored_avsr_tpu_torch.decode.beam_search import top_k
from tailored_avsr_tpu_torch.ops.rnnt import select_state

NEG_INF = -1.0e10


class TransducerBeamResult(NamedTuple):
    tokens: torch.Tensor  # (B, K, Lmax) int32
    lengths: torch.Tensor  # (B, K)
    scores: torch.Tensor  # (B, K) f32


def _merge_prefixes(cand_scores, tokens, lens, t_idx, top_id, b: int, k: int, p1: int):
    """Candidates of equal (prefix, frame): the lowest index takes the group's
    log-sum-exp, the others NEG_INF (``transducer_beam.py:97-140``)."""
    n, lmax = tokens.shape[0] * tokens.shape[1], tokens.shape[2]
    dev = cand_scores.device
    hyp_tokens, hyp_lens = tokens.reshape(n, lmax), lens.reshape(n)
    col = torch.arange(lmax, device=dev)
    appended = torch.where((col[None, :] == hyp_lens[:, None])[:, None, :], top_id[:, :, None].to(torch.int32),
                           hyp_tokens[:, None, :])  # (N, P, L)
    cand_tokens = torch.cat([hyp_tokens[:, None, :], appended], dim=1)  # (N, P1, L)
    kind = torch.arange(p1, device=dev)
    c = k * p1
    cl = (hyp_lens[:, None] + (kind > 0).to(torch.int32)).reshape(b, c)
    cf = (t_idx.reshape(n)[:, None] + (kind == 0).to(torch.int32)).reshape(b, c)
    ct = torch.where(col[None, None, :] < cl[:, :, None], cand_tokens.reshape(b, c, lmax), -1)  # int32
    okay = cand_scores > NEG_INF / 2
    eq = ((cl[:, :, None] == cl[:, None, :]) & (cf[:, :, None] == cf[:, None, :])
          & okay[:, :, None] & okay[:, None, :])
    eq &= (ct[:, :, None, :] == ct[:, None, :, :]).all(dim=-1)  # (B, C, C) bool
    first = eq.to(torch.uint8).argmax(dim=-1)  # the lowest j with eq[i, j]
    merged = torch.logsumexp(torch.where(eq, cand_scores[:, None, :], NEG_INF), dim=-1)
    canonical = first == torch.arange(c, device=dev)[None, :]
    return torch.where(okay, torch.where(canonical, merged, NEG_INF), cand_scores)


def transducer_beam_search(
    enc: torch.Tensor,  # (B, T, D), as joint_apply takes it
    enc_lengths: torch.Tensor,  # (B,)
    pred_apply: Callable,  # (state, label (N,)) -> (state, (N, H))
    joint_apply: Callable,  # (enc_t (N, D), g (N, H)) -> (N, V) logits
    init_state,  # prediction-network state for N = B*K rows
    beam_size: int = 5,
    max_symbols: int = 50,
    blank_id: int = 0,
    prune_tokens: int = 4,
    merge_prefixes: bool = True,
) -> TransducerBeamResult:
    b, t, _ = enc.shape
    k, lmax, p1 = beam_size, max_symbols, prune_tokens + 1
    n = b * k
    dev = enc.device
    i32 = {"dtype": torch.int32, "device": dev}
    tokens = torch.zeros((b, k, lmax), **i32)
    lens = torch.zeros((b, k), **i32)
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    t_idx = torch.zeros((b, k), **i32)  # each hypothesis' encoder frame
    last = torch.full((n,), -1, **i32)  # its last emitted token (-1: start)
    state = init_state
    fin_tokens = torch.zeros((b, k, lmax), **i32)
    fin_lens = torch.zeros((b, k), **i32)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    batch_rows = torch.arange(b, device=dev).repeat_interleave(k)  # (N,) utterance of each row
    row_lengths = enc_lengths[batch_rows]
    bidx = torch.arange(b, device=dev)[:, None]
    col = torch.arange(lmax, device=dev)[None, :]

    for _ in range(t + max_symbols):
        new_state, g = pred_apply(state, last)  # the state moves only where a token is emitted
        enc_t = enc[batch_rows, t_idx.reshape(n).clamp(max=t - 1).long()]
        logp = torch.log_softmax(joint_apply(enc_t, g).float(), dim=-1)
        flat = scores.reshape(n)
        alive = (t_idx.reshape(n) < row_lengths) & (flat > NEG_INF / 2)
        full = lens.reshape(n) >= lmax
        blank_score = flat + torch.where(alive, logp[:, blank_id], NEG_INF)
        top_lp, top_id = top_k(logp.index_fill(1, torch.tensor([blank_id], device=dev), NEG_INF), prune_tokens)
        tok_scores = flat[:, None] + torch.where((alive & ~full)[:, None], top_lp, NEG_INF)
        cand_scores = torch.cat([blank_score[:, None], tok_scores], dim=1).reshape(b, k * p1)
        if merge_prefixes:
            cand_scores = _merge_prefixes(cand_scores, tokens, lens, t_idx, top_id, b, k, p1)

        top_sc, top_ix = top_k(cand_scores, k)  # (B, K)
        g_src = (bidx * k + top_ix // p1).reshape(n)
        cand_kind = (top_ix % p1).reshape(n, 1)  # 0: blank, j >= 1: the (j-1)-th token
        is_blank = cand_kind[:, 0] == 0
        emit = ~is_blank
        tok_choice = top_id[g_src].gather(1, (cand_kind - 1).clamp(min=0))[:, 0].to(torch.int32)
        new_tokens = tokens.reshape(n, lmax)[g_src]
        new_lens = lens.reshape(n)[g_src]
        new_t = t_idx.reshape(n)[g_src] + is_blank.to(torch.int32)
        new_tokens = torch.where(emit[:, None] & (col == new_lens[:, None]), tok_choice[:, None], new_tokens)
        new_lens = new_lens + emit.to(torch.int32)
        last = torch.where(emit, tok_choice, last[g_src])
        state = select_state(emit, tuple((c[g_src], h[g_src]) for c, h in new_state),
                             tuple((c[g_src], h[g_src]) for c, h in state))

        # finished: the frame pointer reached the utterance's length
        done = new_t >= row_lengths
        done_scores = torch.where(done, top_sc.reshape(n), NEG_INF).reshape(b, k)
        best, best_ix = top_k(torch.cat([fin_scores, done_scores], dim=1), k)
        from_old = best_ix < k
        new_rows, old_rows = (best_ix - k).clamp(0, k - 1), best_ix.clamp(0, k - 1)
        fin_tokens = torch.where(from_old[..., None], fin_tokens[bidx, old_rows],
                                 new_tokens.reshape(b, k, lmax)[bidx, new_rows])
        fin_lens = torch.where(from_old, fin_lens[bidx, old_rows], new_lens.reshape(b, k)[bidx, new_rows])
        fin_scores = best
        tokens, lens, t_idx = new_tokens.reshape(b, k, lmax), new_lens.reshape(b, k), new_t.reshape(b, k)
        scores = torch.where(done, NEG_INF, top_sc.reshape(n)).reshape(b, k)
    return TransducerBeamResult(fin_tokens, fin_lens, fin_scores)
