"""Mask-CTC models: joint CTC + conditional-MLM training (counterpart of
``tailored_avsr_tpu/models/maskctc.py``).

``<mask>`` is one past the vocabulary (``mask_token = vocab_size``; the MLM
decoder has V + 1 outputs). The attention loss becomes the MLM loss over
uniformly masked targets (``mask_uniform``: per utterance the number of
masked tokens is uniform in [1, len]; one uniform score a position, the
smallest scores masked, eos appended and never masked). Training draws
from the CPU generator the train step passes to ``forward`` (the JAX
``mlm`` stream); eval masking is deterministic, from a fresh generator
seeded 0, as the JAX package's ``PRNGKey(0)`` (the draws differ from
JAX's: the two are compared by their statistics). The iterative decode is
``decode/maskctc.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tailored_avsr_tpu_torch.models.asr_model import ASRModel
from tailored_avsr_tpu_torch.models.avsr_model import AVSRModel
from tailored_avsr_tpu_torch.parallel.host_data import rand_rows

EVAL_MASK_SEED = 0


def mask_uniform(text: torch.Tensor, text_lengths: torch.Tensor, mask_token: int, eos: int, ignore_id: int,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) ignore-padded text -> (ys_in (B, L+1): ``<mask>`` at the masked
    positions, eos after the tokens and appended; ys_out (B, L+1): the
    original token at the masked positions, else ``ignore_id``). The
    uniforms are drawn on the CPU from ``generator``."""
    b, l = text.shape
    dev = text.device
    u = rand_rows(b, generator=generator).to(dev)
    scores = rand_rows(b, l, generator=generator).to(dev)
    valid = text != ignore_id
    num_mask = 1 + torch.floor(u * text_lengths.float()).long()
    num_mask = torch.minimum(num_mask, text_lengths.long().clamp(min=1))
    order = torch.argsort(torch.where(valid, scores, float("inf")), dim=-1, stable=True)  # invalid last
    ranks = torch.argsort(order, dim=-1, stable=True)
    to_mask = (ranks < num_mask[:, None]) & valid
    ys_in = torch.where(to_mask, mask_token, torch.where(valid, text, eos))
    ys_out = torch.where(to_mask, text, ignore_id)
    return (torch.cat([ys_in, torch.full((b, 1), eos, dtype=text.dtype, device=dev)], dim=-1),
            torch.cat([ys_out, torch.full((b, 1), ignore_id, dtype=text.dtype, device=dev)], dim=-1))


class _MaskCTCMixin:
    """The MLM targets in place of sos/eos packing."""

    is_maskctc = True

    @property
    def mask_token(self) -> int:
        return self.vocab_size  # one past the original vocabulary

    def attention_targets(self, text, text_lengths, generator=None):
        if not self.training:
            generator = torch.Generator().manual_seed(EVAL_MASK_SEED)
        return mask_uniform(text, text_lengths, self.mask_token, self.eos, self.ignore_id, generator)


class MaskCTCModel(_MaskCTCMixin, ASRModel):
    pass


class AVSRMaskCTCModel(_MaskCTCMixin, AVSRModel):
    pass
