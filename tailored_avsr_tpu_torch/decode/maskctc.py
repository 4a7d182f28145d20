"""Mask-CTC non-autoregressive decoding (counterpart of
``tailored_avsr_tpu/decode/maskctc.py``): CTC greedy, collapse, mask the
low-confidence tokens, then ``num_iterations`` rounds of the conditional
MLM filling the most confident masked positions.

- ``collapse_rows``: each utterance's best CTC path collapsed (repeats,
  then blanks) and left-packed, each token with the highest posterior of
  its segment; frames at or past the length take no part, and a length-0
  utterance gives 0 tokens.
- ``maskctc_decode``: tokens under ``threshold`` become ``mask_token``;
  ``eos`` goes at each utterance's length, which the MLM reads at length
  + 1; a round fills ``max(mask_num // K, min(mask_num, 1))`` positions of
  each utterance, the last round everything left. The JAX ``fori_loop`` is
  a Python loop of exactly ``num_iterations`` MLM calls with no host read.

``jnp.argsort`` is stable and the ranks rely on it (masked positions with
equal MLM confidence fill in position order): every sort here passes
``stable=True``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

NEG_INF = -1.0e10


class MaskCTCResult(NamedTuple):
    tokens: torch.Tensor  # (B, T) token ids, right-padded with the mask token
    lengths: torch.Tensor  # (B,)


def collapse_rows(probs: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor, blank_id: int, pad_id: int):
    """(B, T) best-path posteriors and ids -> (packed ids (B, T) padded with
    ``pad_id``, their segment-max posteriors (B, T) padded with 0, token
    counts (B,)) (``_collapse_row`` of the JAX module, batched)."""
    b, t = ids.shape
    pos = torch.arange(t, device=ids.device)[None, :]
    valid = pos < lengths[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device), ids[:, :-1]], dim=1)
    seg_start = (ids != prev) & valid
    seg_id = (seg_start.long().cumsum(dim=1) - 1).clamp(min=0)  # frames before any start: no token reads them
    seg_max = torch.full((b, t), float("-inf"), dtype=probs.dtype, device=probs.device).scatter_reduce(
        1, seg_id, torch.where(valid, probs, NEG_INF), "amax")
    keep = seg_start & (ids != blank_id)
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1, stable=True)
    kept = keep.gather(1, order)
    packed_ids = torch.where(kept, ids.gather(1, order), pad_id)
    packed_probs = torch.where(kept, seg_max.gather(1, seg_id).gather(1, order), 0.0)
    return packed_ids, packed_probs, keep.sum(dim=1)


def maskctc_decode(
    ctc_logp: torch.Tensor,  # (B, T, V) CTC log-probs
    enc_lens: torch.Tensor,  # (B,)
    mlm_score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (ys (B, T+1), lengths) -> logits
    mask_token: int,
    threshold: float = 0.999,
    num_iterations: int = 10,
    blank_id: int = 0,
    eos: Optional[int] = None,
) -> MaskCTCResult:
    """Mask-CTC decode; ``mlm_score_fn`` returns (B, T+1, V') MLM logits, of
    which the first V are read (the ``<mask>`` logit is ignored)."""
    b, t, v = ctc_logp.shape
    eos = v - 1 if eos is None else eos
    num_iterations = max(1, num_iterations)
    best, ids = ctc_logp.max(dim=-1)
    tokens, tok_probs, lengths = collapse_rows(best.exp(), ids, enc_lens, blank_id, mask_token)
    dev = ctc_logp.device
    masked = (tok_probs < threshold) & (torch.arange(t, device=dev)[None, :] < lengths[:, None])
    ys = torch.cat([torch.where(masked, mask_token, tokens),
                    torch.full((b, 1), mask_token, dtype=tokens.dtype, device=dev)], dim=1)
    ys = torch.where(torch.arange(t + 1, device=dev)[None, :] == lengths[:, None], eos, ys)
    masked = torch.cat([masked, torch.zeros((b, 1), dtype=torch.bool, device=dev)], dim=1)
    mask_num = masked.sum(dim=1)
    # mask_num // K a round, one a round when fewer than K are masked
    per_round = torch.maximum(mask_num // num_iterations, mask_num.clamp(max=1))
    for j in range(num_iterations):
        logits = mlm_score_fn(ys, lengths + 1)[..., :v]
        pred = logits.argmax(dim=-1).to(ys.dtype)
        pred_prob = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
        score = torch.where(masked, pred_prob, NEG_INF)
        rank = torch.argsort(torch.argsort(-score, dim=-1, stable=True), dim=-1, stable=True)
        fill_k = torch.full_like(per_round, t + 1) if j == num_iterations - 1 else per_round
        fill = masked & (rank < fill_k[:, None])
        ys = torch.where(fill, pred, ys)
        masked = masked & ~fill
    return MaskCTCResult(tokens=ys[:, :t], lengths=lengths)
