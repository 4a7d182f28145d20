"""SpecAugment: time warp, frequency masks and time masks
(counterpart of ``tailored_avsr_tpu/ops/specaug.py``).

The same distributions as the JAX module, utterance by utterance: the warp
moves a random anchor in (window, length - window) by up to ``window``
frames (piecewise-linear remap, linear interpolation, padding untouched);
``num_freq_mask`` masks of width in ``freq_mask_width_range`` [lo, hi); and
``num_time_mask`` masks of width in [lo, hi) times the utterance's length
(at least 1 frame wide). Every random number is a uniform drawn on the CPU
from the ``generator`` passed in (torch's default generator when None), one
row per utterance, and moved to the device in one copy; the rest runs on
the device without reading it back. Under data parallelism each rank draws
the global batch's rows and keeps its own (``parallel/host_data.rand_rows``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch.parallel.host_data import rand_rows


def _uniform_int(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """Integers in [lo, hi) from uniforms in [0, 1), as the JAX module's
    ``_rand_int``: lo + floor(u * (hi - lo))."""
    return (lo + u * (hi - lo)).floor().long()


def time_warp(x: torch.Tensor, lengths: torch.Tensor, window: int, u: torch.Tensor) -> torch.Tensor:
    """Warp each utterance of (B, T, F) along time within [0, length);
    ``u`` holds two uniforms per utterance (anchor, shift)."""
    b, t, _ = x.shape
    lengths = lengths.long()
    safe = lengths > 2 * window + 1
    center = _uniform_int(u[:, 0], window + 1, torch.clamp(lengths - window, min=window + 2))
    shift = _uniform_int(u[:, 1], -window, window + 1)
    warped = torch.minimum(torch.clamp(center + shift, min=1), torch.clamp(lengths - 1, min=1))
    center = torch.where(safe, center, 1).float()[:, None]
    warped = torch.where(safe, warped, 1).float()[:, None]
    lengthf = lengths.float()[:, None]
    pos = torch.arange(t, device=x.device, dtype=torch.float32)[None, :]
    src = torch.where(
        pos < warped,
        pos * center / torch.clamp(warped, min=1.0),
        center + (pos - warped) * (lengthf - center) / torch.clamp(lengthf - warped, min=1.0),
    )
    src = torch.where(pos < lengthf, src, pos)  # padding untouched
    lo = src.floor().long().clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    frac = (src - lo.float())[..., None].to(x.dtype)
    gather = lambda idx: x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))  # noqa: E731
    return gather(lo) * (1.0 - frac) + gather(hi) * frac


def _band(n: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """(B, n) bool, True inside [start, start + width) of each row."""
    pos = torch.arange(n, device=start.device)[None, :]
    return (pos >= start[:, None]) & (pos < (start + width)[:, None])


class SpecAug(nn.Module):
    def __init__(
        self,
        apply_time_warp: bool = True,
        time_warp_window: int = 5,
        apply_freq_mask: bool = True,
        freq_mask_width_range=(0, 27),
        num_freq_mask: int = 2,
        apply_time_mask: bool = True,
        time_mask_width_ratio_range=(0.0, 0.05),
        num_time_mask: int = 5,
        mask_value: float = 0.0,
    ):
        super().__init__()
        self.apply_time_warp = apply_time_warp
        self.time_warp_window = time_warp_window
        self.apply_freq_mask = apply_freq_mask
        self.freq_mask_width_range = tuple(freq_mask_width_range)
        self.num_freq_mask = num_freq_mask
        self.apply_time_mask = apply_time_mask
        self.time_mask_width_ratio_range = tuple(time_mask_width_ratio_range)
        self.num_time_mask = num_time_mask
        self.mask_value = mask_value

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(B, T, F), (B,) -> the same shapes, augmented (training only)."""
        if not self.training:
            return x, lengths
        b, t, f = x.shape
        n_freq = self.num_freq_mask if self.apply_freq_mask else 0
        n_time = self.num_time_mask if self.apply_time_mask else 0
        u = rand_rows(b, 2 + 2 * n_freq + 2 * n_time, generator=generator)
        u = u.to(x.device, non_blocking=True)
        if self.apply_time_warp:
            x = time_warp(x, lengths, self.time_warp_window, u[:, :2])
        drop = torch.zeros((b, t, f), dtype=torch.bool, device=x.device)
        k = 2
        lo, hi = self.freq_mask_width_range
        for _ in range(n_freq):
            width = _uniform_int(u[:, k], lo, max(hi, lo + 1))
            start = _uniform_int(u[:, k + 1], 0, torch.clamp(f - width, min=1))
            drop |= _band(f, start, width)[:, None, :]
            k += 2
        rlo, rhi = self.time_mask_width_ratio_range
        lens = lengths.long()
        max_w = torch.clamp((rhi * lens.float()).long(), min=1)
        min_w = (rlo * lens.float()).long()
        for _ in range(n_time):
            width = _uniform_int(u[:, k], min_w, torch.maximum(max_w, min_w + 1))
            start = _uniform_int(u[:, k + 1], 0, torch.clamp(lens - width, min=1))
            drop |= _band(t, start, width)[:, :, None]
            k += 2
        return x.masked_fill(drop, self.mask_value), lengths
