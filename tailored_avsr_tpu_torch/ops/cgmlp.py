"""Convolutional Gating MLP: the Branchformer "local" branch
(counterpart of ``tailored_avsr_tpu/ops/cgmlp.py``).

Linear(d -> units) + GELU -> CSGU -> Linear(units/2 -> d). The CSGU splits
the channels in half, LayerNorms and depthwise-convolves the gate half
(SAME padding), applies the gate activation and multiplies by the other
half. With ``use_fused`` outside training, an identity gate and no linear
after the conv, the gate runs through the fused kernel (K3,
``ops/fused_csgu.py``), as at ``tailored_avsr_tpu/ops/cgmlp.py:72-81``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.ops.feedforward import get_activation
from tailored_avsr_tpu_torch.ops.fused_csgu import LN_EPS, fused_csgu


class ConvolutionalSpatialGatingUnit(nn.Module):
    def __init__(
        self,
        size: int,
        kernel_size: int = 31,
        dropout_rate: float = 0.0,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        use_fused: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"cgMLP conv kernel must be odd for SAME padding, got {kernel_size}")
        kw = {"device": device, "dtype": dtype}
        half = size // 2
        self.norm = nn.LayerNorm(half, eps=LN_EPS, **kw)
        self.conv = nn.Conv1d(half, half, kernel_size, padding=(kernel_size - 1) // 2, groups=half, **kw)
        self.linear = nn.Linear(half, half, **kw) if use_linear_after_conv else None
        self.gate_activation = gate_activation
        self.act = get_activation(gate_activation)
        self.use_fused = use_fused
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused_ok = (
            self.use_fused
            and not self.training
            and self.linear is None
            and self.gate_activation == "identity"
        )
        if fused_ok:
            out = fused_csgu(
                x, self.norm.weight, self.norm.bias,
                self.conv.weight.permute(2, 1, 0).contiguous(), self.conv.bias,
            )
        else:
            half = x.shape[-1] // 2
            x_r, x_g = x[..., :half], x[..., half:]
            ln = F.layer_norm(
                x_g.float(), (half,), self.norm.weight.float(), self.norm.bias.float(), LN_EPS
            ).to(x_g.dtype)
            conv = self.conv(ln.transpose(1, 2)).transpose(1, 2)
            if self.linear is not None:
                conv = self.linear(conv)
            out = x_r * self.act(conv)
        return self.dropout(out)


class ConvolutionalGatingMLP(nn.Module):
    def __init__(
        self,
        size: int,
        linear_units: int = 2048,
        kernel_size: int = 31,
        dropout_rate: float = 0.0,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        use_fused: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.channel_proj1 = nn.Sequential(nn.Linear(size, linear_units, **kw), nn.GELU())
        self.csgu = ConvolutionalSpatialGatingUnit(
            linear_units, kernel_size, dropout_rate, use_linear_after_conv,
            gate_activation, use_fused, **kw,
        )
        self.channel_proj2 = nn.Linear(linear_units // 2, size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channel_proj2(self.csgu(self.channel_proj1(x)))
