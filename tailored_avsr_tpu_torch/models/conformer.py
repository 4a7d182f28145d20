"""Conformer encoder: macaron FFN, self-attention, convolution module, FFN
(counterpart of ``tailored_avsr_tpu/models/conformer.py``).

Layer flow (pre-norm, macaron): x += 1/2 FFN(LN(x)); x += MHA(LN(x));
x += Conv(LN(x)); x += 1/2 FFN(LN(x)); x = LN(x). The conv module is
pointwise (d -> 2d) + GLU (the first half the value) + depthwise conv (k,
SAME) + BatchNorm + SiLU + pointwise (d -> d). The attention is the rel-pos
MHA for the rel-pos types (K1 or K2 under ``use_flash``; the legacy shift
K2 only) and the absolute MHA for any other type, as in JAX.

Stochastic depth skips the layer (one coin, drawn on the CPU) and scales
all four kept residuals by 1 / (1 - rate), as espnet's Conformer does
(the Branchformer scales only its merge residual).

The BatchNorm is flax's (``models/frontends.FlaxBatchNorm1d``): in training
it normalises over every (B, T) position, padded frames included, and
moves its running statistics once a forward, a recomputed region under
``remat`` included; in eval it uses the running statistics.

``ConformerEncoder`` is the Branchformer encoder's scaffold (input layers,
positional encodings, interCTC taps and conditioning, ``after_norm``)
with Conformer layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder, attend, coin, self_attention
from tailored_avsr_tpu_torch.models.frontends import _BN_EPS, _BN_MOMENTUM, FlaxBatchNorm1d
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward

_LN_EPS = 1e-6  # flax LayerNorm default


class ConformerConvModule(nn.Module):
    """(B, T, d) -> (B, T, d): ``pointwise_conv1``, GLU, ``depthwise_conv``,
    ``norm``, SiLU, ``pointwise_conv2``."""

    def __init__(self, size: int, kernel_size: int = 31, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.pointwise_conv1 = nn.Linear(size, 2 * size, **kw)
        self.depthwise_conv = nn.Conv1d(size, size, kernel_size, padding="same", groups=size, **kw)
        self.norm = FlaxBatchNorm1d(size, eps=_BN_EPS, momentum=_BN_MOMENTUM, **kw)
        self.pointwise_conv2 = nn.Linear(size, size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        h = self.depthwise_conv((a * torch.sigmoid(b)).transpose(1, 2))  # (B, d, T)
        return self.pointwise_conv2(F.silu(self.norm(h)).transpose(1, 2))


class ConformerEncoderLayer(nn.Module):
    def __init__(
        self,
        size: int,
        attention_heads: int = 4,
        attention_layer_type: str = "rel_selfattn",
        attention_dropout_rate: float = 0.0,
        cnn_module_kernel: int = 31,
        linear_units: int = 2048,
        ffn_activation: str = "swish",
        macaron: bool = True,
        dropout_rate: float = 0.1,
        stochastic_depth_rate: float = 0.0,
        use_flash: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.stochastic_depth_rate = float(stochastic_depth_rate)
        self.ff_scale = 0.5 if macaron else 1.0
        self.feed_forward_macaron = None
        if macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
            self.norm_ff_macaron = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.self_attn = self_attention(attention_layer_type, size, attention_heads, attention_dropout_rate,
                                        use_flash, fast=False, **kw)
        self.norm_mha = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.conv_module = ConformerConvModule(size, cnn_module_kernel, **kw)
        self.norm_conv = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
        self.norm_ff = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm_final = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def coins(self, generator: Optional[torch.Generator]) -> Tuple[bool, bool]:
        """(skip the layer, False): the stochastic-depth coin; no branch drop."""
        return coin(self.stochastic_depth_rate, self.training, generator), False

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None, coins: Optional[Tuple[bool, bool]] = None):
        """Returns (x, {}); ``coins`` as ``BranchformerEncoderLayer.forward``."""
        skip, _ = self.coins(generator) if coins is None else coins
        if skip:
            return x, {}
        coeff = 1.0 / (1.0 - self.stochastic_depth_rate) if self.training else 1.0
        if self.feed_forward_macaron is not None:
            x = x + coeff * self.ff_scale * self.dropout(self.feed_forward_macaron(self.norm_ff_macaron(x)))
        x = x + coeff * self.dropout(attend(self.self_attn, self.norm_mha(x), pos_emb, mask))
        x = x + coeff * self.dropout(self.conv_module(self.norm_conv(x)))
        x = x + coeff * self.ff_scale * self.dropout(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x), {}


class ConformerEncoder(BranchformerEncoder):
    """The Branchformer encoder's arguments, and ``cnn_module_kernel``."""

    def __init__(self, *args, cnn_module_kernel: int = 31, **kwargs):
        self.cnn_module_kernel = cnn_module_kernel  # read by make_layer, inside the base constructor
        super().__init__(*args, **kwargs)

    def make_layer(self, i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw):
        c = conf
        return ConformerEncoderLayer(
            c["size"], c["heads"], c["att_type"], c["att_dropout"], self.cnn_module_kernel, c["linear_units"],
            c["ffn_activation"], True, c["dropout"], stochastic_depth_rate, c["use_flash"], **kw)
