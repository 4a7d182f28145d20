"""Kernel or plain form, decided by where the tensors lie.

Counterpart of ``tailored_avsr_tpu/ops/backend.py``. A kernel wrapper runs
its plain PyTorch version only for tensors on the CPU; for CUDA tensors it
launches the hand-written kernel or raises. There is no fallback from a
failed launch to the plain version.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors.

    Raises for tensors on mixed or other devices, and for an input that
    autograd would track: the kernels are forward-only, like the Pallas
    kernels they replace (training keeps the plain formulation).
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    if tracks_grad(*tensors):
        raise RuntimeError(
            "forward-only kernel called on a tensor that requires grad; "
            "run it under torch.no_grad() or torch.inference_mode()"
        )
    kind = devices.pop().type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain form for device type {kind!r}")


def tracks_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd would track an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_kernel_input(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is contiguous with exactly this shape and dtype."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
