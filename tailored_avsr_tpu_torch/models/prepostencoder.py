"""Pre-encoders and post-encoders, the ``linear`` choice of each slot
(counterpart of ``tailored_avsr_tpu/models/prepostencoder.py``): a Linear
(``linear_out``) on the features before the encoder, with dropout, or on
the encoder's output; the lengths pass through."""

from __future__ import annotations

import torch
from torch import nn


class LinearProjection(nn.Module):
    """espnet's ``LinearProjection`` pre-encoder: Linear, then dropout."""

    def __init__(self, input_size: int, output_size: int, dropout_rate: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        self.output_size = output_size
        self.linear_out = nn.Linear(input_size, output_size, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        return self.dropout(self.linear_out(x)), lengths


class LinearPostencoder(nn.Module):
    """A Linear after the encoder."""

    def __init__(self, input_size: int, output_size: int, *, device=None, dtype=None):
        super().__init__()
        self.output_size = output_size
        self.linear_out = nn.Linear(input_size, output_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        return self.linear_out(x), lengths
