"""Flash attention with an additive bias or an in-kernel rel-pos term.

Counterpart of ``tailored_avsr_tpu/ops/flash_attention.py``. Both wrappers
launch the one CUDA kernel template in ``csrc/attention.cu`` (see its header
for the design and what bounds it on the H100):

- ``flash_attention_relpos`` (K1) replaces ``_attn_rel_kernel``: the
  Transformer-XL term ``rel_shift(q_rel . pos^T)`` is computed inside the
  kernel, so no (B, H, T, T) bias exists in device memory;
- ``flash_attention`` (K2) replaces ``_attn_kernel``: a precomputed additive
  pre-scale (B, H, T, T) bias, or none, streamed tile by tile.

Each has its plain PyTorch version beside it, the formulation of the eager
attention path. A wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``<wrapper>.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tailored_avsr_tpu_torch.ops.attention import _masked_softmax, rel_shift
from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel

_MODE_NONE, _MODE_DENSE, _MODE_RELPOS = 0, 1, 2
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_DK = (64,)  # the head size of every config in the repository


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax((q . k^T + bias) / sqrt(dk)) . v, masked by key, f32 softmax."""
    scores = q @ k.transpose(-2, -1)
    if bias is not None:
        scores = scores + bias
    attn = _masked_softmax(scores / math.sqrt(q.shape[-1]), mask).to(v.dtype)
    return attn @ v


def flash_attention_relpos_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_rel: torch.Tensor,
    pos: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``flash_attention_plain`` with bias = rel_shift(q_rel . pos^T)."""
    return flash_attention_plain(q, k, v, rel_shift(q_rel @ pos.transpose(-2, -1)), mask)


def check_inputs(mode: int, q, k, v, bias, q_rel, pos, mask) -> None:
    """Raise on inputs the kernel does not take. The bf16 tensor-core forms of
    K1 and K2 copy 16 bytes at a time, so they also want every tensor they
    copy (q, k, v and the bias, or q_rel and the rel table ``pos``) to start
    16-byte aligned."""
    b, h, t, dk = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    if dk not in _KERNEL_DK:
        raise ValueError(f"flash attention kernel takes head dim in {_KERNEL_DK}, got {dk}")
    if t < 1 or b * h > 65535:
        raise ValueError(f"flash attention kernel: unsupported shape {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(x, name, (b, h, t, dk), q.dtype)
    if bias is not None:
        check_kernel_input(bias, "bias", (b, h, t, t), q.dtype)
    if q_rel is not None:
        check_kernel_input(q_rel, "q_rel", (b, h, t, dk), q.dtype)
        check_kernel_input(pos, "pos", (h, 2 * t - 1, dk), q.dtype)
    check_kernel_input(mask, "mask", (b, t), torch.bool)
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 for x in (q, k, v, bias, q_rel, pos) if x is not None):
        raise ValueError("bf16 flash attention kernel: q, k, v, bias, q_rel and pos must be "
                         "16-byte aligned")


def _launch(mode, q, k, v, bias, q_rel, pos, mask) -> torch.Tensor:
    from tailored_avsr_tpu_torch.kernels import build

    check_inputs(mode, q, k, v, bias, q_rel, pos, mask)
    b, h, t, dk = q.shape
    out = torch.empty_like(q)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = build.load().avsr_flash_attention(
            ptr(q), ptr(k), ptr(v), ptr(bias), ptr(q_rel), ptr(pos), ptr(mask), ptr(out),
            b, h, t, dk, int(q.dtype == torch.bfloat16), mode,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_flash_attention (mode {mode}) failed: CUDA error {err}")
    return out


def _key_mask(q: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        return mask
    return torch.ones(q.shape[0], q.shape[2], dtype=torch.bool, device=q.device)


def flash_attention(
    q: torch.Tensor,  # (B, H, T, dk) pre-biased query (q + pos_bias_u)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, H, T, T) additive, pre-scale
    mask: Optional[torch.Tensor] = None,  # (B, T) True = valid key
) -> torch.Tensor:
    """K2: flash attention with an optional additive bias -> (B, H, T, dk)."""
    if not use_kernel(*(x for x in (q, k, v, bias, mask) if x is not None)):
        return flash_attention_plain(q, k, v, bias, mask)
    mode = _MODE_NONE if bias is None else _MODE_DENSE
    out = _launch(mode, q, k, v, bias, None, None, _key_mask(q, mask))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_relpos(
    q: torch.Tensor,  # (B, H, T, dk) content query (q + pos_bias_u)
    k: torch.Tensor,
    v: torch.Tensor,
    q_rel: torch.Tensor,  # (B, H, T, dk) positional query (q + pos_bias_v)
    pos: torch.Tensor,  # (H, 2T-1, dk) per-head projected rel table
    mask: Optional[torch.Tensor] = None,  # (B, T) True = valid key
) -> torch.Tensor:
    """K1: ``flash_attention(q, k, v, rel_shift(q_rel . pos^T), mask)`` with the
    rel-pos term computed in the kernel -> (B, H, T, dk)."""
    if not use_kernel(*(x for x in (q, k, v, q_rel, pos, mask) if x is not None)):
        return flash_attention_relpos_plain(q, k, v, q_rel, pos, mask)
    out = _launch(_MODE_RELPOS, q, k, v, None, q_rel, pos, _key_mask(q, mask))
    flash_attention_relpos.launches += 1
    return out


flash_attention_relpos.launches = 0
