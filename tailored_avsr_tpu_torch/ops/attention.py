"""Relative-position multi-head self-attention
(counterpart of ``tailored_avsr_tpu/ops/attention.py:480-603``).

Routing follows the JAX module: with ``use_flash`` outside training and a
key-side mask, the in-kernel rel-pos flash kernel (K1) runs once the
materialised (B, H, T, T) bias would reach 32 MiB, and below that the bias
is built here and streamed through the flash kernel (K2). Otherwise the
eager formulation runs. The 32 MiB switch was measured on the TPU and is
kept so both kernels sit on the serving path; it has not been measured on
the H100.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

FLASH_RELPOS_MIN_BIAS_BYTES = 32 * 1024 * 1024


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 softmax over the last axis of (B, H, Tq, Tk) scores with a (B, Tk)
    key-side mask (True = valid); fully masked rows give zeros."""
    scores = scores.float()
    if mask is None:
        return torch.softmax(scores, dim=-1)
    m = mask[:, None, None, :]
    attn = torch.softmax(scores.masked_fill(~m, MASK_MIN), dim=-1)
    return attn.masked_fill(~m, 0.0)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T); out[..., i, j] = x[..., i, T-1-i+j]."""
    b, h, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0))  # (b, h, t, 2t)
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]  # (b, h, 2t-1, t)
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL style relative-position MHA with learned u/v biases.

    ``pos_emb`` is the (1, 2T-1, D) table from ``RelPositionalEncoding``.
    """

    def __init__(
        self,
        size: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        use_flash: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        if size % num_heads:
            raise ValueError(f"size {size} is not a multiple of num_heads {num_heads}")
        kw = {"device": device, "dtype": dtype}
        self.h, self.d_k = num_heads, size // num_heads
        self.use_flash = use_flash
        self.linear_q = nn.Linear(size, size, **kw)
        self.linear_k = nn.Linear(size, size, **kw)
        self.linear_v = nn.Linear(size, size, **kw)
        self.linear_out = nn.Linear(size, size, **kw)
        self.linear_pos = nn.Linear(size, size, bias=False, **kw)
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, self.d_k, **kw))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, self.d_k, **kw))
        self.dropout = nn.Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1, self.h, self.d_k).transpose(1, 2)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        pos_emb: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, t, d = query.shape
        q = self._heads(self.linear_q(query))  # (B, H, T, dk)
        k = self._heads(self.linear_k(key))
        v = self._heads(self.linear_v(value))
        p = self._heads(self.linear_pos(pos_emb))  # (1, H, 2T-1, dk)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)

        flash_ok = self.use_flash and not self.training and (mask is None or mask.dim() == 2)
        bias_bytes = b * self.h * t * t * q.element_size()
        if flash_ok and bias_bytes >= FLASH_RELPOS_MIN_BIAS_BYTES:
            from tailored_avsr_tpu_torch.ops.flash_attention import flash_attention_relpos

            out = flash_attention_relpos(
                q_u.contiguous(), k.contiguous(), v.contiguous(), q_v.contiguous(),
                p[0].contiguous(), mask,
            )
        else:
            matrix_bd = rel_shift(q_v @ p.transpose(-2, -1))  # (B, H, T, T)
            if flash_ok:
                from tailored_avsr_tpu_torch.ops.flash_attention import flash_attention

                out = flash_attention(
                    q_u.contiguous(), k.contiguous(), v.contiguous(),
                    bias=matrix_bd.contiguous(), mask=mask,
                )
            else:
                scores = (q_u @ k.transpose(-2, -1) + matrix_bd) / math.sqrt(self.d_k)
                attn = self.dropout(_masked_softmax(scores, mask).to(v.dtype))
                out = attn @ v
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))
