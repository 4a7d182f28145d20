"""Ancestry-group attention for one beam step, K4, and K6 over an int8 cache.

Counterpart of ``group_attend_anc`` and ``group_attend_anc_q`` in
``tailored_avsr_tpu/ops/group_attend.py``: both launch the CUDA kernel
template in ``csrc/group_attend.cu`` (see its header for the design and what
bounds it on the H100), which replaces ``_group_attend_kernel`` (K4) and
``_group_attend_q_kernel`` (K6). Each of the K queries of a beam group
attends over its group's never-reordered (B, H, K, Lc, dk) cache: column
(j, t) counts for query i iff ``anc[b, i, t] == j`` and ``t < pos - 1``; the
step's own K/V column joins the max and the normaliser; softmax in f32;
``width`` limits the columns read to [0, width).

``group_attend_anc_plain`` is the JAX package's XLA formulation
(``MultiHeadedAttention.attend_kv_anc``, ``ops/attention.py:321-367``) in
the group layout: dense (K, dk) x (dk, K*Lc) products with a one-hot
ancestry mask; the products round to the input dtype before the f32
upcast, where the kernel sums in f32.

K6 reads an int8 payload with one f32 scale per (b, h, j, t) column
(``ops/kv_quant.py``): the key scale folds into the column's logit and the
value scale into its softmax weight; the step's own column stays
unquantised. Its plain version ``group_attend_anc_q_plain`` is the JAX
package's dequantising twin (``ops/attention.py:282-288``): the cache
dequantised to the query's dtype, then ``group_attend_anc_plain``.

A wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises. ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel
from tailored_avsr_tpu_torch.ops.kv_quant import dequantize_cache
from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_DK = 64  # the head size of the decoder and the LM
_MAX_LC = 16384  # keeps the block's shared memory (about 8 bytes a column) under the H100's limit


def to_group(rows: torch.Tensor, beam: int) -> torch.Tensor:
    """(N, H, 1, dk) per-row step tensors, rows n = b*beam + i -> the group
    layout (B, H, beam, dk), contiguous."""
    n, h, _, dk = rows.shape
    return rows[:, :, 0].reshape(n // beam, beam, h, dk).transpose(1, 2).contiguous()


def _check_width(width: Optional[int], lc: int) -> None:
    if width is not None and (width % 8 != 0 or not 0 < width <= lc):
        raise ValueError(f"width must be a multiple of 8 in (0, {lc}], got {width}")


def group_attend_anc_plain(
    k: torch.Tensor,  # (B, H, K, Lc, dk) group-major cached keys
    v: torch.Tensor,  # (B, H, K, Lc, dk) cached values
    q: torch.Tensor,  # (B, H, K, dk) query heads
    k_new: torch.Tensor,  # (B, H, K, dk) this step's key column
    v_new: torch.Tensor,  # (B, H, K, dk) this step's value column
    anc: torch.Tensor,  # (B, K, Lc) ancestry slots (-1 = none)
    pos: int,  # cache columns < pos-1 are live
    *,
    width: Optional[int] = None,
) -> torch.Tensor:
    """The group attend as dense masked products -> (B, H, K, dk) in v's dtype."""
    b, h, km, lc, dk = k.shape
    _check_width(width, lc)
    if width is not None and width < lc:
        k, v, lc = k[:, :, :, :width], v[:, :, :, :width], width
    scale = 1.0 / math.sqrt(dk)
    s = torch.einsum("bhid,bhjtd->bhijt", q, k).float() * scale  # (B, H, i, j, t)
    slot = torch.arange(km, device=k.device)[None, None, None, :, None]
    live = (torch.arange(lc, device=k.device) < pos - 1)[None, None, None, None, :]
    valid = (anc[:, :, :lc][:, None, :, None, :] == slot) & live
    s = s.masked_fill(~valid, MASK_MIN)
    s_new = torch.einsum("bhid,bhid->bhi", q, k_new).float() * scale  # (B, H, i)
    m = torch.maximum(s.amax(dim=(3, 4)), s_new)
    p = torch.exp(s - m[..., None, None]) * valid
    p_new = torch.exp(s_new - m)
    lsum = p.sum(dim=(3, 4)) + p_new
    w = (p / lsum[..., None, None]).to(v.dtype)
    out = torch.einsum("bhijt,bhjtd->bhid", w, v)
    return out + (p_new / lsum).to(v.dtype)[..., None] * v_new


def _launch_args(name: str, k: torch.Tensor, v: torch.Tensor, q: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, anc: torch.Tensor, pos: int, width: Optional[int],
                 cache_dtype: torch.dtype):
    """Check the kernel's inputs; -> (groups, heads, beam, lc, n_live, is_bf16)."""
    if k.dim() != 5:
        raise ValueError(f"{name}: k must be (B, H, K, Lc, dk), got {tuple(k.shape)}")
    b, h, km, lc, dk = k.shape
    _check_width(width, lc)
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 queries, got {q.dtype}")
    if dk != _KERNEL_DK:
        raise ValueError(f"{name} kernel takes head dim {_KERNEL_DK}, got {dk}")
    if not 0 < lc <= _MAX_LC or b * h * km > 2 ** 31 - 1:
        raise ValueError(f"{name} kernel: unsupported shape {tuple(k.shape)}")
    for arg, x in (("k", k), ("v", v)):
        check_kernel_input(x, arg, (b, h, km, lc, dk), cache_dtype)
    for arg, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        check_kernel_input(x, arg, (b, h, km, dk), q.dtype)
    check_kernel_input(anc, "anc", (b, km, lc), torch.int32)
    if any(x.data_ptr() % 16 for x in (k, v, q, k_new, v_new)):
        raise ValueError(f"{name} kernel: k, v, q, k_new, v_new must be 16-byte aligned")
    n_live = max(0, min(int(pos) - 1, width or lc))
    return b * h, h, km, lc, n_live, int(q.dtype == torch.bfloat16)


def group_attend_anc(
    k: torch.Tensor,
    v: torch.Tensor,
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    anc: torch.Tensor,
    pos: int,
    *,
    width: Optional[int] = None,
) -> torch.Tensor:
    """K4: the group attend of ``group_attend_anc_plain`` -> (B, H, K, dk).
    ``pos`` is a host integer."""
    if not use_kernel(k, v, q, k_new, v_new, anc):
        return group_attend_anc_plain(k, v, q, k_new, v_new, anc, pos, width=width)
    from tailored_avsr_tpu_torch.kernels import build

    shape = _launch_args("group_attend_anc", k, v, q, k_new, v_new, anc, pos, width, q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(k.device):
        err = build.load().avsr_group_attend(
            k.data_ptr(), v.data_ptr(), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            anc.data_ptr(), out.data_ptr(), *shape, torch.cuda.current_stream(k.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_group_attend failed: CUDA error {err}")
    group_attend_anc.launches += 1
    return out


group_attend_anc.launches = 0


def group_attend_anc_q_plain(
    k: torch.Tensor,  # (B, H, K, Lc, dk) int8 cached keys
    k_scale: torch.Tensor,  # (B, H, K, Lc) f32 key column scales
    v: torch.Tensor,  # (B, H, K, Lc, dk) int8 cached values
    v_scale: torch.Tensor,  # (B, H, K, Lc) f32 value column scales
    q: torch.Tensor,  # (B, H, K, dk) query heads, f32 or bf16
    k_new: torch.Tensor,  # (B, H, K, dk) this step's key column, unquantised
    v_new: torch.Tensor,  # (B, H, K, dk) this step's value column
    anc: torch.Tensor,  # (B, K, Lc) ancestry slots (-1 = none)
    pos: int,
    *,
    width: Optional[int] = None,
) -> torch.Tensor:
    """The int8-cache group attend as the dequantised cache through
    ``group_attend_anc_plain`` -> (B, H, K, dk) in q's dtype."""
    kd, vd = dequantize_cache(k, k_scale, q.dtype), dequantize_cache(v, v_scale, q.dtype)
    return group_attend_anc_plain(kd, vd, q, k_new, v_new, anc, pos, width=width)


def group_attend_anc_q(
    k: torch.Tensor,
    k_scale: torch.Tensor,
    v: torch.Tensor,
    v_scale: torch.Tensor,
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    anc: torch.Tensor,
    pos: int,
    *,
    width: Optional[int] = None,
) -> torch.Tensor:
    """K6: the group attend of ``group_attend_anc_q_plain`` -> (B, H, K, dk)
    in v_new's dtype. ``width`` is a multiple of 8 (K4's rule); ``pos`` is a
    host integer."""
    if not use_kernel(k, k_scale, v, v_scale, q, k_new, v_new, anc):
        return group_attend_anc_q_plain(k, k_scale, v, v_scale, q, k_new, v_new, anc, pos, width=width)
    from tailored_avsr_tpu_torch.kernels import build

    shape = _launch_args("group_attend_anc_q", k, v, q, k_new, v_new, anc, pos, width, torch.int8)
    for arg, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_kernel_input(x, arg, tuple(k.shape[:4]), torch.float32)
    out = torch.empty_like(v_new)
    with torch.cuda.device(k.device):
        err = build.load().avsr_group_attend_q(
            k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(), q.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), anc.data_ptr(), out.data_ptr(), *shape,
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_group_attend_q failed: CUDA error {err}")
    group_attend_anc_q.launches += 1
    return out


group_attend_anc_q.launches = 0
