"""In-place beam KV-cache column writes, K5 and its one-tensor case K5'.

Counterpart of ``tailored_avsr_tpu/ops/cache_update.py``:
``write_cache_columns_kv`` (K5, replaces ``_rmw_col_kv_kernel``) and
``write_cache_column`` (K5', replaces ``_rmw_col_kernel``) both launch the
one CUDA kernel in ``csrc/cache_update.cu`` (see its header), which writes
the (B, H, K, dk) column(s) into column ``min(pos, Lc - 1)`` of the
(B, H, K, Lc, dk) cache(s), cast to the cache dtype in the kernel (f32 ->
bf16 rounds to nearest even, as ``Tensor.to`` does). An int8 cache (the
payload of ``cache_dtype: int8``) takes int8 columns, quantised by the
caller (``decode/beam_search.write_beam_columns_kv``), and copies them.

The JAX functions return new (aliased) buffers; these update the caches in
place and return the same tensors. That is safe on the beam path because
the write comes after the step's attend has read the caches. The clamp is
kept; the Mosaic 8/32-row block read-modify-write and its ``Lc % 8`` check
are not.

The plain versions are the indexed assignment; the kernel agrees with them
bit for bit. A wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``<wrapper>.launches``
counts launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc/cache_update.cu


def _column(pos: int, lc: int) -> int:
    if pos < 0:
        raise ValueError(f"cache column must be >= 0, got {pos}")
    return min(int(pos), lc - 1)


def write_cache_column_plain(cache: torch.Tensor, col: torch.Tensor, pos: int) -> torch.Tensor:
    """cache[:, :, :, min(pos, Lc-1)] = col, in place; returns ``cache``."""
    cache[:, :, :, _column(pos, cache.shape[3])] = col.to(cache.dtype)
    return cache


def write_cache_columns_kv_plain(kcache, vcache, kcol, vcol, pos: int):
    """The K and V forms of ``write_cache_column_plain``; returns the caches."""
    return write_cache_column_plain(kcache, kcol, pos), write_cache_column_plain(vcache, vcol, pos)


def _launch(kcache: torch.Tensor, vcache: Optional[torch.Tensor], kcol: torch.Tensor,
            vcol: Optional[torch.Tensor], pos: int) -> None:
    from tailored_avsr_tpu_torch.kernels import build

    if kcache.dim() != 5:
        raise ValueError(f"cache must be (B, H, K, Lc, dk), got {tuple(kcache.shape)}")
    b, h, km, lc, dk = kcache.shape
    codes = (_TYPE_CODES.get(kcache.dtype), _TYPE_CODES.get(kcol.dtype))
    if None in codes or (codes[0] == 2) != (codes[1] == 2):
        raise TypeError("cache write kernel takes float32 or bfloat16 caches and columns, or an int8 "
                        f"cache and int8 columns, got {kcache.dtype} <- {kcol.dtype}")
    col = _column(pos, lc)
    for name, c, x in (("cache", kcache, kcol), ("vcache", vcache, vcol)):
        if c is None:
            continue
        check_kernel_input(c, name, (b, h, km, lc, dk), kcache.dtype)
        check_kernel_input(x, f"{name} column", (b, h, km, dk), kcol.dtype)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(kcache.device):
        err = build.load().avsr_write_cache_columns(
            ptr(kcache), ptr(vcache), ptr(kcol), ptr(vcol), b * h * km, lc, col, dk, *codes,
            torch.cuda.current_stream(kcache.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_write_cache_columns failed: CUDA error {err}")


def write_cache_columns_kv(
    kcache: torch.Tensor,  # (B, H, K, Lc, dk) key cache
    vcache: torch.Tensor,  # (B, H, K, Lc, dk) value cache, same shape and dtype
    kcol: torch.Tensor,  # (B, H, K, dk) this step's key column
    vcol: torch.Tensor,  # (B, H, K, dk) this step's value column
    pos: int,  # target column (clamped to Lc - 1), a host integer
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: both column writes of one layer in one launch, in place."""
    if not use_kernel(kcache, vcache, kcol, vcol):
        return write_cache_columns_kv_plain(kcache, vcache, kcol, vcol, pos)
    _launch(kcache, vcache, kcol, vcol, pos)
    write_cache_columns_kv.launches += 1
    return kcache, vcache


write_cache_columns_kv.launches = 0


def write_cache_column(cache: torch.Tensor, col: torch.Tensor, pos: int) -> torch.Tensor:
    """K5': the one-tensor form of K5, in place."""
    if not use_kernel(cache, col):
        return write_cache_column_plain(cache, col, pos)
    _launch(cache, None, col, None, pos)
    write_cache_column.launches += 1
    return cache


write_cache_column.launches = 0
