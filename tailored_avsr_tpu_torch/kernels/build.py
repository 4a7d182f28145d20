"""nvcc -> shared library -> ctypes, for the CUDA sources under ``csrc/``.

The library is built on first use, only from the sources in the checkout,
into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
Its file name carries a hash of the sources and the compiler flags, so an
edited source is rebuilt and a stale library is never loaded. The sources
have a plain C interface and include no PyTorch header, so one build takes
seconds: each source compiles in its own nvcc process, all started at once,
and one more links the objects.

Every pointer and the stream are passed as ``c_void_p``; integers as
``c_int``, a row length that may pass 2**31 as ``c_longlong``. Each entry point returns the ``cudaError_t`` of its launch
(``cudaGetLastError()``); the Python wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libavsr_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile each ``csrc/*.cu`` to an object, all at once, and link them
    into one shared library, unless it is built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, compiles = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        compiles.append([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    _run_all(compiles)
    tmp = out.with_name(f"{tag}.so.tmp")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # q, k, v, bias, q_rel, pos, mask, out, batch, heads, t, dk, is_bf16, mode, stream
    lib.avsr_flash_attention.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.avsr_flash_attention.restype = i32
    # x, gamma, beta, w, b, out, batch, t, channels, kernel_size, is_bf16, stream
    lib.avsr_fused_csgu.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.avsr_fused_csgu.restype = i32
    # k, v, q, k_new, v_new, anc, out, partial, groups, heads, beam, lc, n_live, chunk, per,
    # split, is_bf16, stream
    lib.avsr_group_attend.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
    lib.avsr_group_attend.restype = i32
    # k, k_scale, v, v_scale, q, k_new, v_new, anc, out, partial, groups, heads, beam, lc,
    # n_live, chunk, per, split, is_bf16, stream
    lib.avsr_group_attend_q.argtypes = [ptr] * 10 + [i32] * 9 + [ptr]
    lib.avsr_group_attend_q.restype = i32
    # leaves (host table), n_leaves, max_rows, dk, cache_type, col_type, vec, stream
    lib.avsr_write_step_columns.argtypes = [ptr] + [i32] * 6 + [ptr]
    lib.avsr_write_step_columns.restype = i32
    # x, partial, out, rows, row_len, elem_type, vec, chunk, nblk, stream
    lib.avsr_stream_abs_sum.argtypes = [ptr] * 3 + [i32, i64] + [i32] * 4 + [ptr]
    lib.avsr_stream_abs_sum.restype = i32
    return lib
