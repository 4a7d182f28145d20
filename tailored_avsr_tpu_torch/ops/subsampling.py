"""Conv2d subsampling of the audio feature stream
(counterpart of ``Conv2dSubsampling`` in ``tailored_avsr_tpu/ops/subsampling.py``).

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


def subsampled_length(length, factor: int):
    """Output length after the VALID conv stack (ints or tensors)."""
    for k, s in _CONV2D_STAGES[factor]:
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
