"""The plain reference's arithmetic: every product of the reference goes
through ``linear``, ``matmul``, ``einsum`` or ``conv``, so one switch sets
the precision its operands are rounded to.

``precision`` is one of
- ``f32``: float32 with TF32 off (the reference itself);
- ``tf32``: float32 products on the tensor cores in TF32 (the control of a
  float32 configuration);
- ``fp8``: operands rounded to float8 e4m3 with a per-tensor scale (the
  control of a bfloat16 configuration), f32 sums.

Everything else (norms, softmax, activations) stays in f32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = {"precision": "f32"}
PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def precision(name: str):
    """Run the reference's products in ``name``'s precision."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    old = (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _MODE["precision"] = name
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        _MODE["precision"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the current precision's operand type, in f32."""
    mode = _MODE["precision"]
    if mode == "fp8":
        scale = (x.detach().abs().amax().float() / FP8_MAX).clamp(min=1e-30)
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x


def linear(x: torch.Tensor, m) -> torch.Tensor:
    return F.linear(rounded(x), rounded(m.weight), m.bias)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(rounded(a), rounded(b))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, rounded(a), rounded(b))


def conv(x: torch.Tensor, m, **kw) -> torch.Tensor:
    """``m``'s convolution (1-, 2- or 3-D by its weight) with ``kw`` as its
    stride, padding and groups."""
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[m.weight.dim()]
    return fn(rounded(x), rounded(m.weight), m.bias, **kw)
