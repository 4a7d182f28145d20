"""Feature normalisation: utterance-level and global mean-variance norm
(counterpart of ``UtteranceMVN`` and ``GlobalMVN`` in
``tailored_avsr_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.masking import make_valid_mask


class UtteranceMVN(nn.Module):
    """Each utterance's mean over its valid frames subtracted
    (``norm_means``) and, with ``norm_vars``, its standard deviation over
    them divided out (at least ``eps``); the padding set to zero."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = False, eps: float = 1.0e-20):
        super().__init__()
        self.norm_means, self.norm_vars, self.eps = norm_means, norm_vars, eps

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """(B, T, F), (B,) -> normalised over the valid frames of each utterance."""
        if not (self.norm_means or self.norm_vars):
            return x, lengths
        mask = make_valid_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        n = torch.clamp(lengths.to(x.dtype), min=1.0)[:, None, None]
        mean = (x * mask).sum(dim=1, keepdim=True) / n
        if self.norm_means:
            x = (x - mean) * mask
        if self.norm_vars:
            var = (((x if self.norm_means else x - mean) ** 2) * mask).sum(dim=1, keepdim=True) / n
            x = x / torch.clamp(torch.sqrt(var), min=self.eps) * mask
        return x, lengths


class GlobalMVN(nn.Module):
    """Normalise with corpus statistics: the ``mean`` and ``std`` buffers
    (the JAX ``stats`` collection; zeros and ones until loaded), cast to
    the input's dtype before use as the JAX module casts them."""

    def __init__(self, feature_size: int, norm_means: bool = True, norm_vars: bool = True,
                 eps: float = 1.0e-20, *, device=None):
        super().__init__()
        self.feature_size, self.norm_means, self.norm_vars, self.eps = feature_size, norm_means, norm_vars, eps
        self.register_buffer("mean", torch.zeros(feature_size, dtype=torch.float32, device=device))
        self.register_buffer("std", torch.ones(feature_size, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        mask = make_valid_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        mean, std = self.mean.to(x.dtype), self.std.to(x.dtype)
        if self.norm_means:
            x = (x - mean) * mask
        if self.norm_vars:
            x = x / torch.clamp(std, min=self.eps) * mask
        return x, lengths
