"""Positional encodings (counterpart of ``tailored_avsr_tpu/ops/posenc.py``):
absolute (x * sqrt(d) + PE), scaled absolute (x + alpha * PE, alpha
learned), relative (Transformer-XL, espnet "latest") and the pre-2020
legacy relative one.

Relative table layout (``2T-1`` rows): row ``j`` encodes relative position
``T-1-j``, so that after the rel-shift in attention score(i, j) reads
distance ``i - j``. The legacy table has ``T`` rows (positions 0..T-1); the
legacy shift (``ops/attention.legacy_rel_shift``) reads row ``T-1-(i-j)``
for key j <= query i.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

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


def abs_pos_table(max_len: int, d_model: int) -> np.ndarray:
    return sinusoidal_table(np.arange(max_len), d_model)


def rel_pos_table(t: int, d_model: int) -> np.ndarray:
    """(2t-1, d) table; row j encodes relative position t-1-j."""
    return sinusoidal_table(np.arange(t - 1, -t, -1), d_model)


class AbsolutePositionalEncoding(nn.Module):
    """x * sqrt(d) + PE, then dropout. sqrt(d) and PE are rounded to x's
    dtype, as the JAX module takes them; ``dtype`` (default x's) is the
    dtype the sum is computed and returned in: a bf16 embedding table
    under an f32 model (``quantize_dtype: bfloat16``) sums in f32, as the
    jitted JAX graph does once XLA drops the bf16 rounding its next f32
    use would undo."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        t, d = x.shape[-2], x.shape[-1]
        dt = dtype or x.dtype
        pe = torch.from_numpy(abs_pos_table(t, d)).to(device=x.device, dtype=x.dtype)
        return self.dropout(x.to(dt) * _root(d, x.dtype) + pe.to(dt))

    def at_position(self, x: torch.Tensor, pos: int, max_len: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Single-step form: x (N, 1, D) at position ``pos`` of a table of
        ``max_len`` rows."""
        if not 0 <= pos < max_len:  # the JAX form clamps the index; a beam step never needs it
            raise IndexError(f"position {pos} outside a table of {max_len} rows")
        d, dt = x.shape[-1], dtype or x.dtype
        return x.to(dt) * _root(d, x.dtype) + _abs_table(max_len, d, x.device, x.dtype)[pos].to(dt)


@functools.lru_cache(maxsize=16)
def _root(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype`` (the JAX package multiplies by it
    as an array of x's dtype: in bf16 sqrt(32) is 5.65625)."""
    return float(torch.tensor(math.sqrt(d_model), dtype=torch.float64).to(dtype))


@functools.lru_cache(maxsize=16)
def _abs_table(max_len: int, d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The absolute table on the device, built once per shape (a beam step
    reads one row of it)."""
    return torch.from_numpy(abs_pos_table(max_len, d_model)).to(device=device, dtype=dtype)


class RelPositionalEncoding(nn.Module):
    """Returns (x * sqrt(d) with dropout, pos_emb (1, 2T-1, d) with dropout)."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        t, d = x.shape[-2], x.shape[-1]
        pos = torch.from_numpy(rel_pos_table(t, d)).to(device=x.device, dtype=x.dtype)[None]
        return self.dropout(x * _root(d, x.dtype)), self.dropout(pos)


class ScaledPositionalEncoding(nn.Module):
    """x + alpha * PE with a learned scalar ``alpha`` (1,), ones at init; no
    sqrt(d) scaling (espnet's ``ScaledPositionalEncoding``)."""

    def __init__(self, dropout_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, device=device, dtype=dtype))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, d = x.shape[-2], x.shape[-1]
        pe = torch.from_numpy(abs_pos_table(t, d)).to(device=x.device, dtype=x.dtype)
        return self.dropout(x + self.alpha.to(x.dtype) * pe)


class LegacyRelPositionalEncoding(nn.Module):
    """Returns (x * sqrt(d) with dropout, pos_emb (1, T, d) with dropout): the
    absolute table's rows 0..T-1, no negative side."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        t, d = x.shape[-2], x.shape[-1]
        pos = torch.from_numpy(abs_pos_table(t, d)).to(device=x.device, dtype=x.dtype)[None]
        return self.dropout(x * _root(d, x.dtype)), self.dropout(pos)


RELATIVE = ("rel_pos", "legacy_rel_pos")  # the encodings that return (x, pos_emb)


def positional_encoding(pos_type: str, dropout_rate: float, **kw) -> nn.Module:
    """The encoding of ``pos_type`` (after ``rel_pos_type`` resolution);
    ``kw`` (device, dtype) for the one with a weight."""
    if pos_type == "scaled_abs_pos":
        return ScaledPositionalEncoding(dropout_rate, **kw)
    cls = {"abs_pos": AbsolutePositionalEncoding, "rel_pos": RelPositionalEncoding,
           "legacy_rel_pos": LegacyRelPositionalEncoding}.get(pos_type)
    if cls is None:
        raise ValueError(pos_type)
    return cls(dropout_rate)
