"""Length/mask utilities (counterpart of ``tailored_avsr_tpu/ops/masking.py``).

One convention: boolean ``(B, T)`` masks, True = valid frame.
"""

from __future__ import annotations

import torch

# Large negative value that kills masked logits before a softmax; finite in bf16.
MASK_MIN = -1.0e9


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True where t < length."""
    t = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return t[None, :] < lengths[:, None]


def mask_lengths(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool mask -> (B,) int32 lengths."""
    return mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
