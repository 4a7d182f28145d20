"""Per-column int8 quantisation of the beam KV cache and the encoder memory
(counterpart of ``tailored_avsr_tpu/ops/kv_quant.py``; plain PyTorch, as
the JAX functions are XLA).

``cache_dtype: int8`` stores each cache side as ``(int8 payload, f32
scale)`` with one symmetric scale per written (row, head) column;
``mem_dtype: int8`` does the same for the decoder's cross-attention memory
K/V. The group attend (K6, ``ops/group_attend.group_attend_anc_q``) folds
the scales into its logits and weights. Not exact against the float cache
(the error is up to half a step of 1/127 of the column's max); bit-exact
against the JAX functions: the same f32 upcast, a true division by the
scale, round half to even (``torch.round`` as ``jnp.round``), the clamp to
+-127, and scale 0 for an all-zero column.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_column(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., dk) -> (int8 payload (..., dk), f32 scale (...))."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(s > 0, s, 1.0)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_cache(payload: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., Lc, dk) int8 + (..., Lc) scale -> (..., Lc, dk) in ``dtype``."""
    return (payload.float() * scale[..., None].float()).to(dtype)
