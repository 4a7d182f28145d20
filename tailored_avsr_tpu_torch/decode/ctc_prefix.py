"""Tensorized CTC prefix scorer for joint CTC/attention beam search
(counterpart of ``tailored_avsr_tpu/decode/ctc_prefix.py``).

The label-synchronous prefix DP scores every pre-beam candidate extension of
every live hypothesis at once; N = batch * beam hypotheses, P candidates,
every DP array time-minor: log-probs (N, V, T), state (N, 2, T), candidate
work (N, P, T).

For prefix g with last token ``last`` extended by c (log domain):
    phi[t]      = logaddexp(r_b[t], c != last ? r_n[t] : -inf)
    r_n'[t][c]  = logaddexp(r_n'[t-1][c], phi[t-1]) + x[t][c]
    r_b'[t][c]  = logaddexp(r_b'[t-1][c], r_n'[t-1][c]) + x[t][blank]
    psi[c]      = logsumexp_t(phi[t-1] + x[t][c])
    psi[eos]    = logaddexp(r_n[T-1], r_b[T-1])

Each of r_n', r_b' is a first-order affine recurrence
r[t] = logaddexp(r[t-1] + g[t], u[t]), solved by a log2(T)-level doubling
scan over the time axis with the JAX package's compose rule
(g1, u1) o (g2, u2) = (g1 + g2, logaddexp(u1 + g2, u2)): no loop over T.
A closed form through cumulative sums is not used: padded frames carry
-1e10 log-probs, so prefix sums reach -1e11 and f32 cancellation would
destroy the result.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG_INF = -1.0e10


class CTCPrefixState(NamedTuple):
    r: torch.Tensor  # (N, 2, T) [r_n, r_b] of the current prefix, time-minor
    score: torch.Tensor  # (N,) total CTC prefix score psi of the current prefix
    last: torch.Tensor  # (N,) last emitted token id (-1 for the empty prefix)
    length: torch.Tensor  # (N,) number of emitted tokens


def neutralize_padding(logp: torch.Tensor, lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """(B, T, V) log-probs with blank forced to probability 1 (others to
    NEG_INF) on frames >= length, so the DP stalls there."""
    t, v = logp.shape[1], logp.shape[2]
    pad = torch.arange(t, device=logp.device)[None, :] >= lengths[:, None]  # (B, T)
    neutral = torch.full((v,), NEG_INF, dtype=logp.dtype, device=logp.device)
    neutral[blank_id] = 0.0
    return torch.where(pad[..., None], neutral, logp)


def to_time_minor(logp: torch.Tensor) -> torch.Tensor:
    """(N, T, V) -> (N, V, T), contiguous: the layout every scorer function consumes."""
    return logp.transpose(1, 2).contiguous()


def ctc_prefix_init_state(logp_vt: torch.Tensor, blank_id: int = 0) -> CTCPrefixState:
    """State of the empty prefix; ``logp_vt`` (N, V, T) neutralised."""
    n, _, t = logp_vt.shape
    r_b = torch.cumsum(logp_vt[:, blank_id, :], dim=1)
    r_n = torch.full_like(r_b, NEG_INF)
    dev = logp_vt.device
    return CTCPrefixState(
        r=torch.stack([r_n, r_b], dim=1),
        score=torch.zeros(n, dtype=logp_vt.dtype, device=dev),
        last=torch.full((n,), -1, dtype=torch.long, device=dev),
        length=torch.zeros(n, dtype=torch.long, device=dev),
    )


def _affine_scan(g: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over the last axis of the affine maps (g[t], u[t])
    under (g1, u1) o (g2, u2) = (g1 + g2, logaddexp(u1 + g2, u2)), by
    doubling: level k composes each element with the one 2^k to its left."""
    t = g.shape[-1]
    off = 1
    while off < t:
        g_prev, u_prev = g[..., :-off], u[..., :-off]
        g_cur, u_cur = g[..., off:], u[..., off:]
        u = torch.cat([u[..., :off], torch.logaddexp(u_prev + g_cur, u_cur)], dim=-1)
        g = torch.cat([g[..., :off], g_prev + g_cur], dim=-1)
        off *= 2
    return g, u


def ctc_prefix_score_step(
    logp_vt: torch.Tensor,  # (N, V, T) neutralised log-probs, time-minor
    state: CTCPrefixState,
    cand_ids: torch.Tensor,  # (N, P) candidate extensions
    eos_id: int,
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every candidate extension -> (psi (N, P) total prefix scores,
    r_new (N, P, 2, T) per-candidate DP state)."""
    n, _, t = logp_vt.shape
    p = cand_ids.shape[1]
    xc = torch.gather(logp_vt, 1, cand_ids[:, :, None].expand(n, p, t))  # (N, P, T)
    x_blank = logp_vt[:, blank_id, :]  # (N, T)

    r_n_prev, r_b_prev = state.r[:, 0], state.r[:, 1]  # (N, T)
    same_as_last = (cand_ids == state.last[:, None])[:, :, None]  # (N, P, 1)
    phi = torch.logaddexp(
        r_b_prev[:, None, :],
        torch.where(same_as_last, torch.full_like(xc, NEG_INF), r_n_prev[:, None, :]),
    )  # (N, P, T)
    # phi[-1] = 0 for the empty prefix, else -inf
    phi_prev0 = torch.where(state.length == 0, 0.0, NEG_INF).to(xc.dtype)  # (N,)
    phi_shifted = torch.cat([phi_prev0[:, None, None].expand(n, p, 1), phi[:, :, :-1]], dim=2)

    u = phi_shifted + xc  # (N, P, T)
    psi = torch.logsumexp(u, dim=2)  # (N, P)

    # r_n[t] = logaddexp(r_n[t-1] + xc[t], phi[t-1] + xc[t]),  r_n[-1] = -inf
    g_n, u_n = _affine_scan(xc, u)
    r_n_all = torch.logaddexp(NEG_INF + g_n, u_n)
    # r_b[t] = logaddexp(r_b[t-1] + xb[t], r_n[t-1] + xb[t]),  r_b[-1] = -inf
    xb = x_blank[:, None, :].expand(n, p, t)
    r_n_shifted = torch.cat([torch.full_like(r_n_all[:, :, :1], NEG_INF), r_n_all[:, :, :-1]], dim=2)
    g_b, u_b = _affine_scan(xb, r_n_shifted + xb)
    r_b_all = torch.logaddexp(NEG_INF + g_b, u_b)

    # eos scores the prefix as a complete output; blank extensions are invalid
    prefix_final = torch.logaddexp(r_n_prev[:, -1], r_b_prev[:, -1])  # (N,)
    psi = torch.where(cand_ids == eos_id, prefix_final[:, None], psi)
    psi = torch.where(cand_ids == blank_id, torch.full_like(psi, NEG_INF), psi)
    return psi, torch.stack([r_n_all, r_b_all], dim=2)  # (N, P, 2, T)


def ctc_prefix_select(
    state: CTCPrefixState,
    psi: torch.Tensor,  # (N, P)
    r_new: torch.Tensor,  # (N, P, 2, T)
    cand_ids: torch.Tensor,  # (N, P)
    src_hyp: torch.Tensor,  # (N,) global source hypothesis of each new hypothesis
    sel_cand: torch.Tensor,  # (N,) index into P of the chosen candidate
) -> CTCPrefixState:
    """Gather the DP state of the chosen (source hypothesis, candidate) pairs."""
    return CTCPrefixState(
        r=r_new[src_hyp, sel_cand],
        score=psi[src_hyp, sel_cand],
        last=cand_ids[src_hyp, sel_cand],
        length=state.length[src_hyp] + 1,
    )
