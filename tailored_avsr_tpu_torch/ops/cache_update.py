"""In-place beam KV-cache column writes: the step write, with K5 and K5' as
its one-layer and one-tensor cases.

Counterpart of ``tailored_avsr_tpu/ops/cache_update.py``:
``write_cache_columns_kv`` (K5, replaces ``_rmw_col_kv_kernel``) and
``write_cache_column`` (K5', replaces ``_rmw_col_kernel``) write (B, H, K, dk)
columns into column ``min(pos, Lc - 1)`` of (B, H, K, Lc, dk) caches;
``write_step_columns`` writes every cached layer's K and V column of one
beam step (the JAX beam search's per-layer ``write_beam_columns_kv`` calls)
from the step's (N, H, 1, dk) projections, rows ``n = b*K + i``, read where
they lie. All three launch the one CUDA kernel in ``csrc/cache_update.cu``
(see its header), once a call for up to ``MAX_LEAVES`` layers, with a
table of the layers' pointers, strides and columns (``step_leaf_table``).
Values are cast to the cache dtype in the kernel (f32 -> bf16 rounds to
nearest even, as ``Tensor.to`` does). An int8 cache (the payload of
``cache_dtype: int8``) takes int8 columns, quantised by the caller
(``decode/beam_search.write_beam_step``), and its f32 scale cache the step's
scales at the same column.

The JAX functions return new (aliased) buffers; these update the caches in
place and return the same tensors. That is safe on the beam path because
the write comes after the step's attends have read the caches. The clamp is
kept; the Mosaic 8/32-row block read-modify-write and its ``Lc % 8`` check
are not.

The plain versions are the indexed assignment; the kernel agrees with them
bit for bit. A wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``<wrapper>.launches``
counts launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tailored_avsr_tpu_torch.ops.backend import use_kernel
from tailored_avsr_tpu_torch.ops.group_attend import to_group

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc/cache_update.cu
MAX_LEAVES = 32  # layers one launch's parameter table holds (csrc/cache_update.cu)
# csrc/cache_update.cu's StepLeaf, field for field: k/v cache, k/v source,
# k/v scale cache, k/v source scale; heads, beam, Lc, column, rows (B*H*K);
# the (b, h, i) element strides of the K source, the V source and the scales
LEAF_DTYPE = np.dtype([
    ("ptr", "<u8", (8,)), ("heads", "<i4"), ("beam", "<i4"), ("lc", "<i4"), ("col", "<i4"),
    ("rows", "<i4"), ("k_stride", "<i4", (3,)), ("v_stride", "<i4", (3,)), ("s_stride", "<i4", (3,)),
])
assert LEAF_DTYPE.itemsize == 120


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


def write_step_columns_plain(leaves: Sequence[tuple], pos: int) -> None:
    """``write_step_columns`` as a loop of ``write_cache_columns_kv_plain``
    over the layers, plus the int8 scale writes."""
    for kc, vc, kn, vn in leaves:
        if isinstance(kc, tuple):
            (kc, ks), (vc, vs), (kn, ksn), (vn, vsn) = kc, vc, kn, vn
            b, h, km, lc = ks.shape
            col = _column(pos - 1, lc)
            ks[:, :, :, col] = ksn[:, :, 0].reshape(b, km, h).transpose(1, 2)
            vs[:, :, :, col] = vsn[:, :, 0].reshape(b, km, h).transpose(1, 2)
        km = kc.shape[2]
        write_cache_columns_kv_plain(kc, vc, to_group(kn, km), to_group(vn, km), pos - 1)


def _strides(x: Optional[torch.Tensor], b: int, h: int, km: int, trail: tuple, name: str) -> tuple:
    """The (b, h, i) element strides of a source laid out as the beam step's
    (B*K, H, 1, *trail) rows or as the group's (B, H, K, *trail)."""
    if x is None:
        return 0, 0, 0
    if tuple(x.shape) == (b * km, h, 1, *trail):
        s = x.stride()
        return km * s[0], s[1], s[0]
    if tuple(x.shape) == (b, h, km, *trail):
        return x.stride()[:3]
    raise ValueError(f"{name}: expected shape {(b * km, h, 1, *trail)} or {(b, h, km, *trail)}, "
                     f"got {tuple(x.shape)}")


def _check_cache(x: torch.Tensor, shape: tuple, dtype: torch.dtype, name: str) -> None:
    if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape}, got "
                         f"{x.dtype} {tuple(x.shape)}{'' if x.is_contiguous() else ' (strided)'}")


def step_leaf_table(leaves: Sequence[tuple], col: int):
    """The kernel's table for column ``col`` (clamped to each layer's Lc - 1)
    -> (``LEAF_DTYPE`` records, cache dtype, column dtype, dk, vec): one
    record a layer, and vec = 1 when every copy can move 16 bytes. A layer
    is (k cache, v cache or None, k source, v source or None), a cache (B,
    H, K, Lc, dk) contiguous and a source (B*K, H, 1, dk) or (B, H, K, dk)
    with unit last stride. A layer whose caches are (int8 payload, f32
    scale) pairs takes (payload, scale) sources: (B, H, K, Lc) scale caches
    and (B*K, H, 1) or (B, H, K) step scales. Raises on what the kernel does
    not take."""
    records, types, dks, ptrs, strides = [], set(), set(), [], []
    for kc, vc, kn, vn in leaves:
        scaled = isinstance(kc, tuple)
        if scaled != isinstance(kn, tuple):
            raise TypeError("(payload, scale) caches take (payload, scale) columns, and only they do")
        (kc, ks), (vc, vs) = (kc, vc) if scaled else ((kc, None), (vc, None))
        (kn, ksn), (vn, vsn) = (kn, vn) if scaled else ((kn, None), (vn, None))
        if kc.dim() != 5:
            raise ValueError(f"cache must be (B, H, K, Lc, dk), got {tuple(kc.shape)}")
        b, h, km, lc, dk = kc.shape
        if (vc is None) != (vn is None):
            raise ValueError("a V cache takes a V column, and a V column a V cache")
        for name, c in (("cache", kc), ("vcache", vc)):
            if c is not None:
                _check_cache(c, (b, h, km, lc, dk), kc.dtype, name)
        if any(x is not None and (x.dtype != kn.dtype or x.stride(-1) != 1) for x in (kn, vn)):
            raise ValueError("the K and V columns must share one dtype and have unit last stride")
        src = [_strides(x, b, h, km, (dk,), name) for name, x in (("cache column", kn), ("vcache column", vn))]
        sc = (0, 0, 0)
        if scaled:
            for name, c in (("k scale", ks), ("v scale", vs)):
                if c is not None:
                    _check_cache(c, (b, h, km, lc), torch.float32, name)
            sc = _strides(ksn, b, h, km, (), "k scale column")
            if any(x is not None and (x.dtype != torch.float32
                                      or _strides(x, b, h, km, (), "scale column") != sc) for x in (ksn, vsn)):
                raise ValueError("the K and V step scales must be f32 with one layout")
        types.add((kc.dtype, kn.dtype))
        dks.add(dk)
        strides += [*src[0], *src[1]]  # the vector copies' strides (a scale is one element)
        if max(sc) >= 2 ** 31:
            raise ValueError("cache write kernel: a scale stride passes 2**31 elements")
        ptr = [0 if x is None else x.data_ptr() for x in (kc, vc, kn, vn, ks, vs, ksn, vsn)]
        ptrs += ptr
        records.append((ptr, h, km, lc, _column(col, lc), b * h * km, *src, sc))
    if len(types) != 1 or len(dks) != 1:
        raise ValueError(f"one launch takes one cache/column dtype pair and one dk, got {types}, {dks}")
    (cache_dtype, col_dtype), dk = types.pop(), dks.pop()
    if cache_dtype not in _TYPE_CODES or col_dtype not in _TYPE_CODES or (
            (cache_dtype == torch.int8) != (col_dtype == torch.int8)):
        raise TypeError("cache write kernel takes float32 or bfloat16 caches and columns, or an int8 "
                        f"cache and int8 columns, got {cache_dtype} <- {col_dtype}")
    if max(strides) >= 2 ** 31:
        raise ValueError("cache write kernel: a column stride passes 2**31 elements")
    elems = 16 // max(cache_dtype.itemsize, col_dtype.itemsize)  # a 16-byte copy's elements
    vec = int(dk % elems == 0 and all(p % 16 == 0 for p in ptrs) and all(s % elems == 0 for s in strides))
    return np.array(records, LEAF_DTYPE), cache_dtype, col_dtype, dk, vec


def _launch(leaves: Sequence[tuple], col: int) -> None:
    from tailored_avsr_tpu_torch.kernels import build

    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"cache write kernel: at most {MAX_LEAVES} layers a launch, got {len(leaves)}")
    table, cache_dtype, col_dtype, dk, vec = step_leaf_table(leaves, col)
    device = (leaves[0][0][0] if isinstance(leaves[0][0], tuple) else leaves[0][0]).device
    with torch.cuda.device(device):
        err = build.load().avsr_write_step_columns(
            table.ctypes.data, len(table), int(table["rows"].max()), dk, _TYPE_CODES[cache_dtype],
            _TYPE_CODES[col_dtype], vec, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"avsr_write_step_columns failed: CUDA error {err}")


def _tensors(leaves: Sequence[tuple]) -> list:
    return [t for leaf in leaves for x in leaf if x is not None
            for t in (x if isinstance(x, tuple) else (x,))]


def write_step_columns(leaves: Sequence[tuple], pos: int) -> None:
    """The step write: every layer's K and V column of one beam step into
    column ``min(pos - 1, Lc - 1)`` of its caches, in place, in one launch
    (at most ``MAX_LEAVES`` layers). ``leaves``: one (k cache, v cache, k_new,
    v_new) a layer, caches (B, H, K, Lc, dk) and the step's (N, H, 1, dk)
    columns, rows n = b*K + i, views allowed; an int8 layer has (payload,
    scale) pairs: (B, H, K, Lc) f32 scale caches and (N, H, 1) step scales.
    Layers may differ in H, K and Lc, not in dtypes or dk."""
    if not leaves:
        return
    if not use_kernel(*_tensors(leaves)):
        write_step_columns_plain(leaves, pos)
        return
    _launch(leaves, pos - 1)
    write_step_columns.launches += 1


write_step_columns.launches = 0


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
    _launch([(kcache, vcache, kcol, vcol)], pos)
    write_cache_columns_kv.launches += 1
    return kcache, vcache


write_cache_columns_kv.launches = 0


def write_cache_column(cache: torch.Tensor, col: torch.Tensor, pos: int) -> torch.Tensor:
    """K5': the one-tensor form of K5, in place."""
    if not use_kernel(cache, col):
        return write_cache_column_plain(cache, col, pos)
    _launch([(cache, None, col, None)], pos)
    write_cache_column.launches += 1
    return cache


write_cache_column.launches = 0
