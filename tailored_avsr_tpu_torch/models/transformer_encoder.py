"""Transformer encoder and its Longformer (local-window) variant
(counterpart of ``TransformerEncoder`` and ``LongformerEncoder`` in
``tailored_avsr_tpu/models/transformer_encoder.py``).

The layer is the pre-norm block x += MHA(LN(x)); x += FFN(LN(x)), with no
final LayerNorm of its own; stochastic depth scales both residuals. The
attention is the absolute MHA (``selfattn``, the registry's default with
``abs_pos`` and a ReLU FFN), or the rel-pos MHA for the rel-pos types.
Under a window (Longformer, ``attention_windows``) each layer attends
through the (B, T) key mask intersected with a band |i - j| <= max(1,
window // 2): a (B, T, T) mask, so its attention is always the plain path
(``use_flash`` off), as in JAX. Both encoders are the Branchformer
encoder's scaffold with these layers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder, attend, coin, self_attention
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward

_LN_EPS = 1e-6  # flax LayerNorm default


def window_mask(mask: Optional[torch.Tensor], t: int, window: int, device=None) -> Optional[torch.Tensor]:
    """The (B, T) key mask intersected with a band of half-width
    max(1, window // 2): (B, T, T); the mask itself for window <= 0."""
    if window <= 0:
        return mask
    idx = torch.arange(t, device=device if mask is None else mask.device)
    band = (idx[:, None] - idx[None, :]).abs() <= max(1, window // 2)
    if mask is None:
        return band[None]
    return (mask[:, None, :] if mask.dim() == 2 else mask) & band[None]


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self,
        size: int,
        attention_heads: int = 4,
        attention_layer_type: str = "selfattn",
        attention_dropout_rate: float = 0.0,
        linear_units: int = 2048,
        ffn_activation: str = "relu",
        dropout_rate: float = 0.1,
        stochastic_depth_rate: float = 0.0,
        attention_window: int = 0,  # > 0: Longformer's local window (total width)
        use_flash: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.stochastic_depth_rate = float(stochastic_depth_rate)
        self.attention_window = int(attention_window)
        self.self_attn = self_attention(attention_layer_type, size, attention_heads, attention_dropout_rate,
                                        use_flash, fast=False, **kw)
        self.norm_mha = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
        self.norm_ff = nn.LayerNorm(size, eps=_LN_EPS, **kw)
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
        attn_mask = window_mask(mask, x.shape[1], self.attention_window, x.device)
        x = x + coeff * self.dropout(attend(self.self_attn, self.norm_mha(x), pos_emb, attn_mask))
        x = x + coeff * self.dropout(self.feed_forward(self.norm_ff(x)))
        return x, {}


class TransformerEncoder(BranchformerEncoder):
    """espnet-style Transformer encoder on the Branchformer scaffold."""

    def make_layer(self, i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw):
        c = conf
        return TransformerEncoderLayer(
            c["size"], c["heads"], c["att_type"], c["att_dropout"], c["linear_units"], c["ffn_activation"],
            c["dropout"], stochastic_depth_rate, 0, c["use_flash"], **kw)


class LongformerEncoder(TransformerEncoder):
    """The Transformer encoder with a sliding-window self-attention in every
    layer: ``attention_windows``, one width for all or one per layer."""

    def __init__(self, *args, attention_windows: Union[int, Sequence[int]] = 100, **kwargs):
        self.attention_windows = attention_windows  # read by make_layer, inside the base constructor
        super().__init__(*args, **kwargs)

    def make_layer(self, i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw):
        c, w = conf, self.attention_windows
        if not isinstance(w, int) and len(w) != c["num_blocks"]:
            raise ValueError(f"attention_windows needs one entry per block, got {len(w)} for {c['num_blocks']}")
        # the banded (B, T, T) mask takes the plain attention path, as in JAX
        return TransformerEncoderLayer(
            c["size"], c["heads"], c["att_type"], c["att_dropout"], c["linear_units"], c["ffn_activation"],
            c["dropout"], stochastic_depth_rate, w if isinstance(w, int) else int(w[i]), False, **kw)
