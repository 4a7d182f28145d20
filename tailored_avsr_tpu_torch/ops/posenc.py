"""Relative (Transformer-XL, espnet "latest") positional encoding
(counterpart of ``RelPositionalEncoding`` in ``tailored_avsr_tpu/ops/posenc.py``).

Table layout (``2T-1`` rows): row ``j`` encodes relative position ``T-1-j``,
so that after the rel-shift in attention score(i, j) reads distance ``i - j``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sinusoidal_table(positions: np.ndarray, d_model: int) -> np.ndarray:
    """Sin/cos table for arbitrary (possibly negative) integer positions."""
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    pe = np.zeros((len(positions), d_model), dtype=np.float32)
    ang = positions[:, None].astype(np.float64) * div[None, :]
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def rel_pos_table(t: int, d_model: int) -> np.ndarray:
    """(2t-1, d) table; row j encodes relative position t-1-j."""
    return sinusoidal_table(np.arange(t - 1, -t, -1), d_model)


class RelPositionalEncoding(nn.Module):
    """Returns (x * sqrt(d) with dropout, pos_emb (1, 2T-1, d) with dropout)."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        t, d = x.shape[-2], x.shape[-1]
        pos = torch.from_numpy(rel_pos_table(t, d)).to(device=x.device, dtype=x.dtype)[None]
        return self.dropout(x * math.sqrt(d)), self.dropout(pos)
