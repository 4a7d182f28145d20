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

``group_attend_plan`` decides, on the host, how a launch cuts the work
(columns a copy, columns a block, blocks a group); ``launch_shape`` checks
the inputs and returns the launch's integers. A wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel (and,
when a group's ancestry takes several blocks, the kernel that combines
their partial results) or raises. ``<wrapper>.launches`` counts the
kernels launched, the combining kernel included.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel
from tailored_avsr_tpu_torch.ops.kv_quant import dequantize_cache
from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_DK = 64  # the head size of the decoder and the LM
_MAX_LC = 16384
_MAX_BEAM = 64  # a warp a query, 10 warps a block taking the queries in turn
_SMEM_LIMIT = 232448  # the most shared memory one block may take on the H100
_SMEM_TWO_BLOCKS = 115712  # an SM's 228 KB for two blocks, less 1 KB each reserved
_ANC_PAIRS = 4096  # (query, column) ancestry entries a block holds
_PARTIAL = _KERNEL_DK + 2  # a (max, sum, accumulator) triple: accumulator, max, sum
_RING = 4  # chunk buffers a block
_VWARPS = 4  # value accumulators a query (the kernel's fixed order of sums)


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


def _smem_bytes(beam: int, chunk: int, per: int, cache_esize: int) -> int:
    """A block's shared memory, as ``smem_bytes`` in ``csrc/group_attend.cu``
    lays it out: a ring of ``_RING`` buffers of cache rows (one
    16-byte-skewed row a slot, ``beam * chunk`` slots) with the int8 cache's
    scales, the queries, the logits of the block's ``per`` columns, the
    value accumulators, three floats a query, the ancestry and a byte a
    (slot, column) naming the rows to copy."""
    slots = beam * chunk
    scales = 4 * _RING * slots if cache_esize == 1 else 0
    return (_RING * slots * (_KERNEL_DK * cache_esize + 16) + scales
            + beam * _KERNEL_DK * 4 * (1 + _VWARPS) + 12 * beam + 9 * beam * per)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)  # called a few thousand times a beam request, on few shapes
def group_attend_plan(groups: int, beam: int, n_live: int, cache_esize: int, *,
                      sms: int = 132) -> Tuple[int, int, int]:
    """How the kernel cuts the work -> (chunk, per, split).

    ``split`` blocks serve a group's ``n_live`` columns, ``per`` columns each
    (a multiple of ``chunk``), copied ``chunk`` columns (<= 32, one lane
    each) at a time. A group takes one block unless its ancestry does not
    fit one: a block holds that of at most ~4,096 (query, column) pairs
    (beam 10: 409 columns), and more columns are split over blocks whose
    partial results a second kernel combines. Splitting a group only to
    fill idle SMs lost wherever it was measured (``PERF.md``). The chunk is
    the widest that fits: when the groups outnumber the ``sms`` SMs, first
    the widest of 32, 16 or 8 columns whose block fits two to an SM, else
    the widest that fits one."""
    if not 1 <= beam <= _MAX_BEAM:
        raise ValueError(f"group attend kernel takes a beam of 1 to {_MAX_BEAM}, got {beam}")
    n = max(int(n_live), 1)
    passes = [(_SMEM_LIMIT, (32, 16, 8, 4, 2, 1))]
    if groups > sms:
        passes.insert(0, (_SMEM_TWO_BLOCKS, (32, 16, 8)))
    for budget, chunks in passes:
        for c in chunks:
            per_max = max(c, _ANC_PAIRS // beam // c * c)
            per = _cdiv(_cdiv(n, _cdiv(n, per_max)), c) * c
            if _smem_bytes(beam, c, per, cache_esize) <= budget:
                return c, per, _cdiv(n, per)
    raise ValueError(f"group attend kernel: beam {beam} does not fit a block's shared memory")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_shape(entry: str, k: torch.Tensor, v: torch.Tensor, scales: tuple, q: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, anc: torch.Tensor, pos: int,
                 width: Optional[int], cache_dtype: torch.dtype, *, sms: int) -> dict:
    """Check the kernel's inputs (raise on what it does not take) -> the
    launch's integers: groups, heads, beam, lc, n_live, chunk, per, split."""
    if k.dim() != 5:
        raise ValueError(f"{entry}: k must be (B, H, K, Lc, dk), got {tuple(k.shape)}")
    b, h, km, lc, dk = k.shape
    _check_width(width, lc)
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{entry} kernel takes float32 or bfloat16 queries, got {q.dtype}")
    if dk != _KERNEL_DK:
        raise ValueError(f"{entry} kernel takes head dim {_KERNEL_DK}, got {dk}")
    if not 0 < lc <= _MAX_LC or b * h * km * lc > 2 ** 31 - 1:
        raise ValueError(f"{entry} kernel: unsupported shape {tuple(k.shape)}")
    for arg, x in (("k", k), ("v", v)):
        check_kernel_input(x, arg, (b, h, km, lc, dk), cache_dtype)
    for arg, x in zip(("k_scale", "v_scale"), scales):
        check_kernel_input(x, arg, (b, h, km, lc), torch.float32)
    for arg, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        check_kernel_input(x, arg, (b, h, km, dk), q.dtype)
    check_kernel_input(anc, "anc", (b, km, lc), torch.int32)
    if any(x.data_ptr() % 16 for x in (k, v, q, k_new, v_new)):
        raise ValueError(f"{entry} kernel: k, v, q, k_new, v_new must be 16-byte aligned")
    n_live = max(0, min(int(pos) - 1, width or lc))
    chunk, per, split = group_attend_plan(b * h, km, n_live, k.element_size(), sms=sms)
    return {"groups": b * h, "heads": h, "beam": km, "lc": lc, "n_live": n_live, "chunk": chunk,
            "per": per, "split": split}


def _launch(entry: str, k: torch.Tensor, v: torch.Tensor, scales: tuple, q: torch.Tensor,
            k_new: torch.Tensor, v_new: torch.Tensor, anc: torch.Tensor, shape: dict) -> torch.Tensor:
    """Allocate the output and, when a group takes more than one block, the
    (groups, split, K, 66) f32 partial triples, and launch ``entry`` as
    ``shape`` (``launch_shape``'s integers) cuts the work."""
    from tailored_avsr_tpu_torch.kernels import build

    out = torch.empty_like(v_new)
    partial = None
    if shape["split"] > 1:
        partial = torch.empty((shape["groups"], shape["split"], shape["beam"], _PARTIAL),
                              dtype=torch.float32, device=k.device)
    ptr = [x.data_ptr() for x in (k, *scales[:1], v, *scales[1:], q, k_new, v_new, anc, out)]
    with torch.cuda.device(k.device):
        err = getattr(build.load(), entry)(
            *ptr, None if partial is None else partial.data_ptr(),
            *(shape[x] for x in ("groups", "heads", "beam", "lc", "n_live", "chunk", "per", "split")),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(k.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return out


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
    shape = launch_shape("avsr_group_attend", k, v, (), q, k_new, v_new, anc, pos, width, q.dtype,
                         sms=_sm_count(k.device))
    out = _launch("avsr_group_attend", k, v, (), q, k_new, v_new, anc, shape)
    group_attend_anc.launches += 1 + (shape["split"] > 1)  # the combining kernel too
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
    scales = (k_scale, v_scale)
    shape = launch_shape("avsr_group_attend_q", k, v, scales, q, k_new, v_new, anc, pos, width,
                         torch.int8, sms=_sm_count(k.device))
    out = _launch("avsr_group_attend_q", k, v, scales, q, k_new, v_new, anc, shape)
    group_attend_anc_q.launches += 1 + (shape["split"] > 1)
    return out


group_attend_anc_q.launches = 0
