"""Convolutional subsampling of a feature stream: 2-D convs over (time,
freq) and 1-D convs over time (counterpart of ``Conv2dSubsampling`` and
``Conv1dSubsampling`` in ``tailored_avsr_tpu/ops/subsampling.py``).

All convs are VALID (no padding); positional encoding is applied by the
caller after the two streams are aligned.
"""

from __future__ import annotations

import torch
from torch import nn

# factor -> (kernel, stride) conv stages
_CONV2D_STAGES = {
    1: [(3, 1), (3, 1)],
    2: [(3, 2), (3, 1)],
    4: [(3, 2), (3, 2)],
    6: [(3, 2), (5, 3)],
    8: [(3, 2), (3, 2), (3, 2)],
}

_CONV1D_STAGES = {2: [(3, 2)], 3: [(5, 3)]}


def subsampled_length(length, factor: int, conv1d: bool = False):
    """Output length after the VALID conv stack (ints or tensors)."""
    for k, s in (_CONV1D_STAGES if conv1d else _CONV2D_STAGES)[factor]:
        length = (length - k) // s + 1
    return length


class Conv2dSubsampling(nn.Module):
    """(B, T, F) -> (B, T', D): 2-D convs over (time, freq), ReLU, then Linear
    over the flattened (channel, freq) axis (``conv.{2j}``, ``out``). With
    ``pos_enc_slot`` the Linear is ``out.0``: an encoder's subsampling keeps
    its positional encoding as ``out.1`` in the reference key grammar (it
    holds no weights, and the encoder applies it)."""

    def __init__(self, input_size: int, output_size: int, factor: int = 4, pos_enc_slot: bool = False,
                 *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        layers = []
        in_ch, freq = 1, input_size
        for k, s in _CONV2D_STAGES[factor]:
            layers += [nn.Conv2d(in_ch, output_size, k, s, **kw), nn.ReLU()]
            in_ch, freq = output_size, (freq - k) // s + 1
        self.conv = nn.Sequential(*layers)
        out = nn.Linear(output_size * freq, output_size, **kw)
        self.out = nn.Sequential(out) if pos_enc_slot else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x[:, None])  # (B, D, T', F')
        b, c, t, f = h.shape
        return self.out(h.transpose(1, 2).reshape(b, t, c * f))


class Conv1dSubsampling(nn.Module):
    """(B, T, F) -> (B, T', D): one VALID 1-D conv over time (factor 2: k 3,
    stride 2; factor 3: k 5, stride 3) and a ReLU (``conv.0``)."""

    def __init__(self, input_size: int, output_size: int, factor: int = 2, *, device=None, dtype=None):
        super().__init__()
        (k, s), = _CONV1D_STAGES[factor]
        self.conv = nn.Sequential(nn.Conv1d(input_size, output_size, k, s, device=device, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)
