"""Batched joint CTC/attention beam search with LM shallow fusion
(counterpart of ``tailored_avsr_tpu/decode/beam_search.py``).

Hypotheses live in a fixed (B, K, L+2) token buffer; every step scores all
N = B*K rows at once, prunes to ``pre_beam`` candidates on the attention
(+ LM) scores, adds the weighted CTC prefix score of each candidate
(``ctc_prefix.py``), moves candidates that emit eos into a finished buffer
by a top-k merge and keeps the top K others alive. Eos is blocked before
``minlen`` and forced at each utterance's ``maxlen``.

The JAX ``lax.while_loop`` becomes a Python loop of one step per iteration
(the JAX unroll-2 overshoot exists for XLA's loop buffers; one step per
iteration is the result-exact form). Everything stays on the device except
the exact early-exit test, one device-to-host read per step: the loop stops
once no alive hypothesis' upper bound (its score + remaining steps *
max(0, penalty)) can displace the nbest-th finished score of any utterance.
Phased widths run the early steps with a narrower attend (cache columns
[0, w)), which is exact because columns >= pos-1 are dead.

Every top-k is a stable descending sort: ``jax.lax.top_k`` keeps the lower
index among equal values and the search relies on it (exact ties keep the
OLD finished entry; many candidates clamp to exactly NEG_INF), while
``torch.topk`` promises no order for ties.

An LM left out of the stateful scorer (``lm_score_fn``, the full-prefix
LM at ``ctc_weight: 1.0``, or an n-gram alone) joins the selection
scores with ``lm_weight``; a part scorer (``ngram_part_fn``, the n-gram's
``part`` mode) scores only the pre-beam candidates, with
``ngram_weight``. A stateful scorer's state is reordered by
``att_gather_fn``, or, without one, row by row (``reorder_beam_rows`` on
every tensor of the state).

The ancestry cache protocol: the caches are never reordered; each step
writes every slot's new K/V column of every layer in one launch
(``write_beam_step``, the step write) and threads the (N, Lc) ancestry
table through the reorder (``update_ancestry``). An int8 cache side
(``cache_dtype: int8``) is an (int8 payload, f32 scale) tuple: the step's
columns are quantised, and the same launch writes payloads and scales.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tailored_avsr_tpu_torch.decode.ctc_prefix import (
    ctc_prefix_init_state,
    ctc_prefix_score_step,
    ctc_prefix_select,
    neutralize_padding,
    to_time_minor,
)
from tailored_avsr_tpu_torch.ops.cache_update import write_cache_column, write_step_columns
from tailored_avsr_tpu_torch.ops.group_attend import to_group
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

NEG_INF = -1.0e10


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, ties to the lower index (``jax.lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def write_beam_column(x: torch.Tensor, new_col: torch.Tensor, pos: int) -> torch.Tensor:
    """Write this step's (N, H, 1, dk) columns into the (B, H, K, Lc, dk)
    group cache at column ``pos - 1``, in place (K5')."""
    return write_cache_column(x, to_group(new_col, x.shape[2]), pos - 1)


def write_beam_step(leaves, pos: int) -> None:
    """Every cached layer's K and V column of one beam step at column
    ``pos - 1``, in place, in one launch (``write_step_columns``). ``leaves``:
    one (ck, cv, k_new, v_new) a layer, with the step's (N, H, 1, dk)
    columns as the scorer returns them. An int8 side ``(payload, scale)``:
    the columns are quantised (``quantize_kv_column``) and their (N, H, 1)
    scales written at the same column, as
    ``tailored_avsr_tpu/decode/beam_search.py:142-161``."""
    write_step_columns([
        (ck, cv, quantize_kv_column(kn), quantize_kv_column(vn)) if isinstance(ck, tuple)
        else (ck, cv, kn, vn) for ck, cv, kn, vn in leaves], pos)


def write_beam_columns_kv(ck, cv, k_new: torch.Tensor, v_new: torch.Tensor, pos: int):
    """One layer's K and V column writes at column ``pos - 1``, in place:
    ``write_beam_step`` of one layer. Returns the sides."""
    write_beam_step([(ck, cv, k_new, v_new)], pos)
    return ck, cv


def update_ancestry(anc: torch.Tensor, g_src: torch.Tensor, src_bk: torch.Tensor, pos: int) -> torch.Tensor:
    """New slot i of group b continues the hypothesis of slot ``src_bk[b, i]``:
    it inherits that row's ancestry for columns < pos-1, and its column pos-1
    (written this step by the source slot) lives at ``src_bk[b, i]``."""
    anc = anc[g_src]
    anc[:, pos - 1] = src_bk.reshape(-1).to(anc.dtype)
    return anc


def _rows(src_bk: torch.Tensor) -> torch.Tensor:
    """(B, K) within-group beam sources -> (N,) global rows b*K + src."""
    b, k = src_bk.shape
    return (torch.arange(b, device=src_bk.device)[:, None] * k + src_bk).reshape(b * k)


def reorder_beam_rows(x: torch.Tensor, src_bk: torch.Tensor) -> torch.Tensor:
    """The beam reorder of a row-major state tensor: ``out[b*K + i] =
    x[b*K + src_bk[b, i]]``."""
    return x[_rows(src_bk)]


def insert_permute_rows(x: torch.Tensor, new_col: torch.Tensor, src_bk: torch.Tensor, pos: int) -> torch.Tensor:
    """The append protocol's cache write: the beam reorder of an (N, H, Lc,
    dk) cache leaf with column ``pos - 1`` replaced by the step's (N, H, 1,
    dk) column of the source row, cast to the cache's dtype -> a new leaf
    (one read and one write of the whole cache a step)."""
    g_src = _rows(src_bk)
    out = x[g_src]
    out[:, :, pos - 1] = new_col[g_src, :, 0].to(x.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 30
    ctc_weight: float = 0.1
    lm_weight: float = 0.0
    penalty: float = 0.0
    maxlenratio: float = 0.0
    minlenratio: float = 0.0
    pre_beam_ratio: float = 1.5
    nbest: int = 1
    early_exit: bool = True  # exact upper-bound stop (one host read per step)
    # weight of the n-gram part scorer (``ngram_part_fn``), on the pre-beam candidates
    ngram_weight: float = 0.0
    # attend widths of the early steps: entries <= 1 are fractions of the
    # max decode length, > 1 absolute columns; each rounds up to width_tile
    phase_widths: tuple = ()
    # the JAX package's cache tile: 8, or 32 for cache_dtype: int8 (kept so
    # that the phase schedule is the JAX package's step for step)
    width_tile: int = 8


def _map_tensors(state, fn):
    """``fn`` on every tensor of a nest of lists, tuples and dicts."""
    if torch.is_tensor(state):
        return fn(state)
    if isinstance(state, dict):
        return {k: _map_tensors(v, fn) for k, v in state.items()}
    return type(state)(_map_tensors(v, fn) for v in state)


class BeamSearchResult(NamedTuple):
    tokens: torch.Tensor  # (B, nbest, L+2) sos ... eos, padded with eos
    scores: torch.Tensor  # (B, nbest)
    lengths: torch.Tensor  # (B, nbest) token count excluding sos/eos


def beam_search(
    att_score_fn: Callable,
    ctc_logp: torch.Tensor,  # (B, T, V) CTC log-probs
    enc_lens: torch.Tensor,  # (B,)
    sos: int,
    eos: int,
    config: BeamSearchConfig,
    lm_score_fn: Optional[Callable] = None,
    blank_id: int = 0,
    att_state=None,
    att_gather_fn: Optional[Callable] = None,
    att_fn_for_width: Optional[Callable] = None,
    ngram_part_fn: Optional[Callable] = None,
) -> BeamSearchResult:
    """att_score_fn(ys (N, L+2), pos int) -> (N, V) step log-probs, or, with
    ``att_state``, ``(ys, pos, state) -> (logp, state)`` whose state
    ``att_gather_fn(state, g_src (N,), pos)`` carries through each reorder
    (by default every tensor of the state is reordered by rows).
    ``att_fn_for_width(w)`` gives the stateful scorer of a phase of width w.
    ``lm_score_fn(ys, pos) -> (N, V)`` adds with ``lm_weight`` to the
    selection scores; ``ngram_part_fn(ys, pos, cand (N, P)) -> (N, P)``
    with ``ngram_weight`` to the pre-beam candidates' scores.
    """
    stateful = att_state is not None
    if stateful and att_gather_fn is None:
        def att_gather_fn(st, g_src, pos):
            return _map_tensors(st, lambda x: x[g_src])
    dev = ctc_logp.device
    b, t, v = ctc_logp.shape
    k = config.beam_size
    p = min(v, max(1, int(config.pre_beam_ratio * k)))
    if config.maxlenratio == 0.0:
        lmax = t
    elif config.maxlenratio < 0.0:
        lmax = max(1, min(t, int(-config.maxlenratio)))
    else:
        lmax = max(1, min(t, int(config.maxlenratio * t)))
    n = b * k
    use_ctc = config.ctc_weight > 0.0
    att_w = 1.0 - config.ctc_weight
    enc_lens = enc_lens.to(device=dev, dtype=torch.long)
    if config.maxlenratio == 0.0:
        maxlen = enc_lens
    elif config.maxlenratio < 0.0:
        maxlen = torch.full_like(enc_lens, lmax)
    else:
        maxlen = torch.floor(config.maxlenratio * enc_lens).long()
    maxlen = torch.clamp(maxlen, 1, lmax)  # (B,)
    minlen = torch.floor(config.minlenratio * enc_lens).long()

    if use_ctc:
        logp_vt = to_time_minor(neutralize_padding(ctc_logp, enc_lens, blank_id).repeat_interleave(k, dim=0))
        ctc_state = ctc_prefix_init_state(logp_vt, blank_id)
    ys = torch.full((b, k, lmax + 2), eos, dtype=torch.long, device=dev)
    ys[:, :, 0] = sos
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    fin_tokens = torch.full((b, k, lmax + 2), eos, dtype=torch.long, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    fin_lengths = torch.zeros((b, k), dtype=torch.long, device=dev)
    batch_idx = torch.arange(b, device=dev)[:, None]
    is_eos = torch.arange(v, device=dev) == eos  # (V,)
    nbest = min(config.nbest, k)
    state = att_state

    def step(i: int, score_fn) -> None:
        nonlocal ys, scores, ctc_state, state, fin_tokens, fin_scores, fin_lengths
        pos = i + 1  # position being generated
        ys_flat = ys.reshape(n, lmax + 2)
        if stateful:
            att_logp, state = score_fn(ys_flat, pos, state)
        else:
            att_logp = score_fn(ys_flat, pos)  # (N, V)
        # with att_w == 0 (pure CTC) select candidates on the unweighted
        # decoder posterior; the accumulated totals still use 0 * att
        sel_w = att_w if att_w > 0.0 else 1.0
        step_logp = sel_w * att_logp
        if lm_score_fn is not None and config.lm_weight > 0.0:
            step_logp = step_logp + config.lm_weight * lm_score_fn(ys_flat, pos)
        step_logp = step_logp + config.penalty

        # eos gating: block eos before minlen, force eos at maxlen
        block_eos = (i < minlen)[:, None]  # (B, 1)
        force_eos = (i >= maxlen - 1)[:, None]
        gate = torch.zeros((b, v), device=dev)
        gate = torch.where(block_eos & is_eos, NEG_INF, gate)
        gate = torch.where(force_eos & ~is_eos, NEG_INF, gate)
        step_logp = step_logp + gate.repeat_interleave(k, dim=0)
        step_logp[:, blank_id] += NEG_INF  # blank is never a decoder output

        pre_scores, cand_ids = top_k(step_logp, p)  # (N, P)
        if att_w == 0.0:
            pre_scores = pre_scores - torch.gather(att_logp, 1, cand_ids)
        if use_ctc:
            psi, r_new = ctc_prefix_score_step(logp_vt, ctc_state, cand_ids, eos, blank_id)
            cand_scores = pre_scores + config.ctc_weight * (psi - ctc_state.score[:, None])
        else:
            cand_scores = pre_scores
        if ngram_part_fn is not None and config.ngram_weight > 0.0:
            cand_scores = cand_scores + config.ngram_weight * ngram_part_fn(ys_flat, pos, cand_ids)
        total = torch.clamp(scores.reshape(n, 1) + cand_scores, min=NEG_INF)  # (N, P)

        # finished (eos) candidates merge into the finished buffer
        cand_tok = cand_ids.reshape(b, k * p)
        cand_total = total.reshape(b, k * p)
        eos_cand = cand_tok == eos
        fin_cand = torch.where(eos_cand, cand_total, NEG_INF)
        top_fin, top_fin_idx = top_k(torch.cat([fin_scores, fin_cand], dim=1), k)  # (B, K)
        from_old = top_fin_idx < k
        new_src = torch.clamp(top_fin_idx - k, 0, k * p - 1) // p
        new_fin_tokens = ys[batch_idx, new_src]  # (B, K, L+2)
        new_fin_tokens[:, :, pos] = eos
        old_rows = torch.clamp(top_fin_idx, 0, k - 1)
        fin_tokens = torch.where(from_old[..., None], fin_tokens[batch_idx, old_rows], new_fin_tokens)
        fin_lengths = torch.where(from_old, fin_lengths[batch_idx, old_rows], i)
        fin_scores = top_fin

        # alive: the top K non-eos candidates
        top_alive, top_alive_idx = top_k(torch.where(eos_cand, NEG_INF, cand_total), k)
        src_hyp = top_alive_idx // p  # (B, K) source slot in the group
        sel_cand = top_alive_idx % p
        new_ys = ys[batch_idx, src_hyp]
        new_ys[:, :, pos] = cand_tok[batch_idx, top_alive_idx]
        ys, scores = new_ys, top_alive

        g_src = (batch_idx * k + src_hyp).reshape(n)
        if use_ctc:
            ctc_state = ctc_prefix_select(ctc_state, psi, r_new, cand_ids, g_src, sel_cand.reshape(n))
        if stateful:
            state = att_gather_fn(state, g_src, pos)

    def running(i: int, hi: int) -> bool:
        if i >= hi:
            return False
        if not config.early_exit:
            return True
        pen = max(config.penalty, 0.0)
        bound = scores.max(dim=1).values + torch.clamp(maxlen - i, min=0).float() * pen
        return not bool((bound <= fin_scores[:, nbest - 1]).all())  # the one host read

    phases = []
    if config.phase_widths and stateful and att_fn_for_width is not None:
        prev = 0
        for w in config.phase_widths:
            w = int(w * lmax) if 0 < w <= 1 else int(w)
            w = -(-w // config.width_tile) * config.width_tile
            if prev < w < lmax:
                phases.append(w)
                prev = w
    i = 0
    for hi, fn in [(w, att_fn_for_width(w)) for w in phases] + [(lmax, att_score_fn)]:
        while running(i, hi):
            step(i, fn)
            i += 1
    best_scores, best_idx = top_k(fin_scores, nbest)
    return BeamSearchResult(
        tokens=fin_tokens[batch_idx, best_idx],
        scores=best_scores,
        lengths=fin_lengths[batch_idx, best_idx],
    )
