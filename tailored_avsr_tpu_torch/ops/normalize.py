"""Utterance-level mean normalisation
(counterpart of ``UtteranceMVN`` in ``tailored_avsr_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.masking import make_valid_mask


class UtteranceMVN(nn.Module):
    """Subtract each utterance's mean over its valid frames; zero the padding.

    Only ``norm_vars=False`` is ported: the flagship configs normalise means
    only (``normalize_conf: norm_means true / norm_vars false``).
    """

    def __init__(self, norm_means: bool = True, norm_vars: bool = False, eps: float = 1.0e-20):
        super().__init__()
        if norm_vars:
            raise NotImplementedError("UtteranceMVN norm_vars=True is not ported")
        self.norm_means = norm_means
        self.eps = eps  # read only by the variance normalisation

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """(B, T, F), (B,) -> normalised over the valid frames of each utterance."""
        if not self.norm_means:
            return x, lengths
        mask = make_valid_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        n = torch.clamp(lengths.to(x.dtype), min=1.0)[:, None, None]
        mean = (x * mask).sum(dim=1, keepdim=True) / n
        return (x - mean) * mask, lengths
