"""Fused Convolutional Spatial Gating Unit (the cgMLP gate), K3.

Counterpart of ``tailored_avsr_tpu/ops/fused_csgu.py``: ``fused_csgu``
launches the CUDA kernel in ``csrc/csgu.cu`` (see its header for the design
and what bounds it on the H100), which replaces ``_csgu_kernel``. It computes
``x_r * (dwconv_k(LN(x_g) * gamma + beta) + b)`` with an identity gate, the
LayerNorm (eps 1e-6) and the conv in f32, and the LN output kept in f32 into
the conv, as the TPU kernel does. The eager gate in ``ops/cgmlp.py`` rounds
the LN output to the input dtype before its conv: the two agree in f32 and
differ by rounding in bf16.

The wrapper runs ``fused_csgu_plain`` for CPU tensors only; for CUDA tensors
it launches the kernel or raises (``check_inputs`` names what the kernel
refuses). ``fused_csgu.launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_KERNEL_SIZE = 127  # keeps an f32 block's staged rows under the H100's 227 KB
TIME_TILE = 32  # output rows of a cluster: the kernel's register accumulators
CHANNEL_TILE = 256  # channels of a block, one a thread
_MAX_CHANNELS = 8 * CHANNEL_TILE  # a cluster of at most 8 blocks

LN_EPS = 1e-6


def fused_csgu_plain(
    x: torch.Tensor,  # (B, T, U): the channel_proj1 + GELU output
    gamma: torch.Tensor,  # (U/2,) LN scale
    beta: torch.Tensor,  # (U/2,) LN bias
    conv_w: torch.Tensor,  # (k, 1, U/2) depthwise kernel, JAX layout
    conv_b: torch.Tensor,  # (U/2,)
) -> torch.Tensor:
    """The fused kernel's arithmetic in plain PyTorch -> (B, T, U/2)."""
    c = x.shape[-1] // 2
    k = conv_w.shape[0]
    x_r, x_g = x[..., :c].float(), x[..., c:].float()
    ln = F.layer_norm(x_g, (c,), gamma.float(), beta.float(), LN_EPS)
    w = conv_w.float().permute(2, 1, 0)  # (C, 1, k)
    gate = F.conv1d(ln.transpose(1, 2), w, conv_b.float(), padding=(k - 1) // 2, groups=c)
    return (x_r * gate.transpose(1, 2)).to(x.dtype)


def check_inputs(x, gamma, beta, conv_w, conv_b) -> None:
    """Raise on inputs the kernel does not take: a type other than f32 /
    bf16, an even kernel size or one above ``_MAX_KERNEL_SIZE``, a gate
    width C that is no multiple of 8 (the rows move in 16-byte copies) or
    above ``_MAX_CHANNELS`` (a cluster holds at most 8 blocks of 256
    channels), x not 16-byte aligned, or parameters of another shape, type
    or layout."""
    if x.dim() != 3 or x.shape[-1] % 2:
        raise ValueError(f"fused_csgu: x must be (B, T, U) with even U, got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_csgu kernel takes float32 or bfloat16, got {x.dtype}")
    b, t, u = x.shape
    c, k = u // 2, conv_w.shape[0]
    if k % 2 == 0 or k > _MAX_KERNEL_SIZE:
        raise ValueError(f"fused_csgu kernel takes an odd kernel size <= {_MAX_KERNEL_SIZE}, got {k}")
    if c % 8 or c > _MAX_CHANNELS:
        raise ValueError(f"fused_csgu kernel takes a gate width U/2 that is a multiple of 8 and at most "
                         f"{_MAX_CHANNELS}, got {c}")
    if t < 1 or b > 65535:
        raise ValueError(f"fused_csgu kernel: unsupported shape {tuple(x.shape)}")
    check_kernel_input(x, "x", (b, t, u), x.dtype)
    for name, p in (("gamma", gamma), ("beta", beta), ("conv_b", conv_b)):
        check_kernel_input(p, name, (c,), x.dtype)
    check_kernel_input(conv_w, "conv_w", (k, 1, c), x.dtype)
    if x.data_ptr() % 16:
        raise ValueError("fused_csgu kernel: x must be 16-byte aligned")


def fused_csgu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    conv_w: torch.Tensor,
    conv_b: torch.Tensor,
) -> torch.Tensor:
    """K3: (B, T, U) -> (B, T, U/2) gated output, identity gate activation."""
    if not use_kernel(x, gamma, beta, conv_w, conv_b):
        return fused_csgu_plain(x, gamma, beta, conv_w, conv_b)
    from tailored_avsr_tpu_torch.kernels import build

    check_inputs(x, gamma, beta, conv_w, conv_b)
    b, t, u = x.shape
    c, k = u // 2, conv_w.shape[0]
    out = torch.empty(b, t, c, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load().avsr_fused_csgu(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), conv_w.data_ptr(),
            conv_b.data_ptr(), out.data_ptr(), b, t, c, k, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_fused_csgu failed: CUDA error {err}")
    fused_csgu.launches += 1
    return out


fused_csgu.launches = 0
