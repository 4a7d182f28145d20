"""Training losses and metrics: CTC, label smoothing, accuracy, sos/eos packing
(counterpart of ``tailored_avsr_tpu/ops/losses.py``).

- ``ctc_loss``: ``torch.nn.functional.ctc_loss`` (a library dynamic
  programme, as the JAX side uses optax's) summed over the batch and divided
  by B, the JAX reduction (torch's ``"mean"`` divides each utterance by its
  target length, a different loss). An utterance whose labels cannot be
  aligned (T < L + adjacent repeats) gives 0 and no gradient, the JAX
  package's feasibility rule.
- ``label_smoothing_loss``: espnet's KL form with the constant entropy term,
  normalised by the batch unless ``normalize_length``.
- ``token_accuracy`` and ``add_sos_eos``: as in the JAX package.

Targets are (B, L) padded with ``ignore_id`` (-1); sos/eos packing gives
(B, L+1) tensors. Losses are taken in f32 whatever the logits' dtype.
Under data parallelism (``parallel/host_data.data_shard``) each divides
this rank's sum by the global batch's count, so the data group's losses
and gradients sum to the global batch's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.parallel.host_data import global_count, global_rows


def ctc_feasible(logit_lengths: torch.Tensor, labels: torch.Tensor,
                 label_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: an alignment exists, T >= L + the number of adjacent
    repeated labels (``tailored_avsr_tpu/ops/losses.py:53-58``)."""
    l = labels.shape[1]
    pos = torch.arange(l, device=labels.device)[None, :]
    valid = (pos < label_lengths[:, None]) & (labels >= 0)
    safe = torch.where(labels >= 0, labels, 0)
    prev = F.pad(safe[:, :-1], (1, 0), value=-1)
    repeats = ((safe == prev) & valid & (pos > 0)).sum(dim=-1)
    return logit_lengths >= label_lengths + repeats


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    reduce: bool = True,
) -> torch.Tensor:
    """Batch-mean CTC loss (per sequence with ``reduce=False``).
    logits: (B, T, V); labels: (B, L), valid ids >= 0."""
    b = logits.shape[0]
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    safe = torch.where(labels >= 0, labels, 0).long()
    per_seq = F.ctc_loss(logp, safe, logit_lengths.long(), label_lengths.long(),
                         blank=blank_id, reduction="none", zero_infinity=True)
    per_seq = torch.where(ctc_feasible(logit_lengths, labels, label_lengths), per_seq, 0.0)
    if not reduce:
        return per_seq
    return per_seq.sum() / global_rows(b)


def add_sos_eos(text: torch.Tensor, sos: int, eos: int,
                ignore_id: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) ignore-padded -> (ys_in (B, L+1) eos-padded, ys_out (B, L+1)
    ignore-padded): ys_in = [sos, y1..yn, eos, eos...], ys_out = [y1..yn,
    eos, ignore...]."""
    b, l = text.shape
    valid = text != ignore_id
    lengths = valid.sum(dim=-1)
    ys = torch.where(valid, text, eos)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=text.dtype, device=text.device), ys], dim=-1)
    ys_out = torch.cat([ys, torch.full((b, 1), eos, dtype=text.dtype, device=text.device)], dim=-1)
    pos = torch.arange(l + 1, device=text.device)[None, :]
    ys_out = torch.where(pos == lengths[:, None], eos, ys_out)
    ys_out = torch.where(pos > lengths[:, None], ignore_id, ys_out)
    return ys_in, ys_out


def label_smoothing_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smoothing: float = 0.1,
    ignore_id: int = -1,
    normalize_length: bool = False,
) -> torch.Tensor:
    """KL(true_dist || softmax(logits)) summed over the valid tokens, divided
    by the batch size (or the valid-token count with ``normalize_length``);
    true_dist is smoothing/(V-1) everywhere and 1-smoothing at the target,
    and 0 * log 0 counts 0, so smoothing 0 is plain cross-entropy."""
    v = logits.shape[-1]
    confidence, low = 1.0 - smoothing, smoothing / (v - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, 0).long()
    # sum_v p_v (log p_v - logp_v), with p = low off the target, confidence on it
    ent = 0.0
    if low > 0.0:
        ent += (v - 1) * low * torch.log(torch.tensor(low, dtype=torch.float64)).item()
    if confidence > 0.0:
        ent += confidence * torch.log(torch.tensor(confidence, dtype=torch.float64)).item()
    logp_tgt = logp.gather(-1, tgt[..., None]).squeeze(-1)
    cross = confidence * logp_tgt
    if low > 0.0:
        cross = cross + low * (logp.sum(dim=-1) - logp_tgt)
    kl = (ent - cross) * valid.float()
    denom = global_count(valid.sum()) if normalize_length else global_rows(targets.shape[0])
    return kl.sum() / denom


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor, ignore_id: int = -1) -> torch.Tensor:
    """Fraction of correctly predicted non-ignored tokens."""
    valid = targets != ignore_id
    correct = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return correct / global_count(valid.sum()).clamp(min=1)
