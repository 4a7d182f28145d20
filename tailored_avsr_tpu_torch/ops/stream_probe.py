"""HBM streaming probe, P1: the sum of |x| over each batch row.

Counterpart of ``stream_time`` / ``stream_kernel`` in
``scripts/bench_int8_stream.py``, the probe that sized the int8 beam cache
(``cache_dtype: int8``, K6): does an int8 (..., 64)-minor cache stream at
half the time of a bf16 one? ``stream_abs_sum`` launches the CUDA kernel in
``csrc/stream_probe.cu`` (see its header). The TPU kernel writes every
row's sum into one (1, 1) output block, so it returns the last row's sum:
that is element ``[-1]`` here.

``run_probe(device)`` reproduces the script's four cases at
(96, 8, 10, 104, 64): bf16 and int8 with dk 64, int8 viewed as dk 128, and
int8 flat, each with its allocated size and the kernel's time, rate and
share of the H100's 3.35 TB/s. It is on no serving path.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises. ``stream_abs_sum.launches`` counts calls
(one call is the kernel's two passes).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from tailored_avsr_tpu_torch.ops.backend import use_kernel

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc/stream_probe.cu
_CHUNK_BYTES = 32 * 1024  # per block of the first pass
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate
PROBE_SHAPE = (96, 8, 10, 104, 64)


def stream_abs_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,) f32 sums of |x| over each batch row."""
    return x.reshape(x.shape[0], -1).float().abs().sum(dim=1)


def stream_abs_sum(x: torch.Tensor) -> torch.Tensor:
    """P1: ``stream_abs_sum_plain`` of a contiguous f32, bf16 or int8 tensor."""
    if not use_kernel(x):
        return stream_abs_sum_plain(x)
    from tailored_avsr_tpu_torch.kernels import build

    if x.dtype not in _TYPE_CODES:
        raise TypeError(f"stream_abs_sum kernel takes float32, bfloat16 or int8, got {x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError("stream_abs_sum kernel: x must be contiguous with a batch axis")
    rows = x.shape[0]
    row_len = x.numel() // rows if rows else 0
    if rows > 65535:
        raise ValueError(f"stream_abs_sum kernel: at most 65535 rows, got {rows}")
    size = x.element_size()
    vec = int(x.data_ptr() % 16 == 0 and row_len * size % 16 == 0)
    chunk = _CHUNK_BYTES // 16 if vec else _CHUNK_BYTES // size  # units: vectors or elements
    units = row_len * size // 16 if vec else row_len
    nblk = max(1, -(-units // chunk))
    partial = torch.empty((rows, nblk), dtype=torch.float32, device=x.device)
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load().avsr_stream_abs_sum(
            x.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, row_len, _TYPE_CODES[x.dtype],
            vec, chunk, nblk, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_stream_abs_sum failed: CUDA error {err}")
    stream_abs_sum.launches += 1
    return out


stream_abs_sum.launches = 0


def cold_time_ms(fn: Callable[[], object], n: int = 25, flush_bytes: int = 64 << 20) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, after 3
    warm-up calls, with the L2 cold: before each timed call a ``flush_bytes``
    buffer (more than the H100's 50 MB L2) is written, then a spin kernel of
    about 1 ms runs, so the host has enqueued the whole call before its start
    event fires. CUDA events; the current device."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        scratch.fill_(1)
        torch.cuda._sleep(2_000_000)  # clock cycles
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def probe_cases(shape=PROBE_SHAPE):
    """The script's four cases: (name, shape, dtype)."""
    b, h, k, lc, dk = shape
    return [
        ("bf16_dk64", (b, h, k, lc, dk), torch.bfloat16),
        ("int8_dk64", (b, h, k, lc, dk), torch.int8),
        ("int8_dk128", (b, h, k, lc // 2, dk * 2), torch.int8),
        ("int8_flat", (b, h, k, lc * dk), torch.int8),
    ]


def run_probe(device, shape=PROBE_SHAPE, n: int = 25) -> List[dict]:
    """Each case on the card: allocated MB (``torch.cuda.memory_allocated``
    delta), kernel and plain ms (L2 cold, median of n), the kernel's GB/s
    and its share of 3.35 TB/s, and the kernel's largest absolute and
    relative differences from the plain version on seeded random data."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"run_probe measures the card; got device {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    with torch.cuda.device(device):
        for name, shp, dtype in probe_cases(shape):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            if dtype == torch.int8:
                x = torch.randint(-128, 128, shp, generator=gen, device=device, dtype=torch.int8)
            else:
                x = torch.randn(shp, generator=gen, device=device).to(dtype)
            alloc = torch.cuda.memory_allocated(device) - before
            got, want = stream_abs_sum(x), stream_abs_sum_plain(x)
            err = (got - want).abs()
            rel = float((err / want.abs().clamp_min(1e-30)).max())
            ms = cold_time_ms(lambda: stream_abs_sum(x), n)
            plain_ms = cold_time_ms(lambda: stream_abs_sum_plain(x), n)
            rate = x.numel() * x.element_size() / (ms * 1e-3)
            rows.append({"case": name, "shape": list(shp), "dtype": str(dtype).replace("torch.", ""),
                         "alloc_mb": alloc / 2 ** 20, "bytes": x.numel() * x.element_size(),
                         "ms": ms, "plain_ms": plain_ms, "gb_per_s": rate / 1e9,
                         "hbm_share": rate / HBM_BYTES_PER_S, "max_abs_err": float(err.max()),
                         "max_rel_err": rel})
            del x, got, want
    return rows
