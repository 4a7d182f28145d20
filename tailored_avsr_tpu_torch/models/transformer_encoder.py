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

``MultiSpeakerTransformerEncoder`` (espnet's ``transformer_multispkr``,
the PIT model's encoder) runs the shared layers, then ``num_inf``
speaker stacks of ``num_blocks_sd`` layers each (``sd{s}_layer_{i}``, no
stochastic depth), each stack's output through ``after_norm``: (B,
num_inf, T, D).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder, attend, coin, run_layer, self_attention
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask

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


class MultiSpeakerTransformerEncoder(TransformerEncoder):
    """Shared Transformer layers, then one stack of ``num_blocks_sd`` layers
    per inferred speaker."""

    def __init__(self, *args, num_inf: int = 2, num_blocks_sd: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_inf, self.num_blocks_sd = num_inf, num_blocks_sd
        c, kw = self._layer_conf
        for s in range(num_inf):
            for i in range(num_blocks_sd):
                setattr(self, f"sd{s}_layer_{i}", TransformerEncoderLayer(
                    c["size"], c["heads"], c["att_type"], c["att_dropout"], c["linear_units"], c["ffn_activation"],
                    c["dropout"], 0.0, 0, c["use_flash"], **kw))

    def make_layer(self, i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw):
        self._layer_conf = (conf, kw)  # the speaker stacks' settings too
        return super().make_layer(i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor, generator: Optional[torch.Generator] = None,
                ctc=None):
        """(B, T, F) features -> ((B, num_inf, T', D), lengths, aux with no
        taps and no branch weights)."""
        xs, ilens, pos_emb = self.embed_frames(xs, ilens)
        mask = make_valid_mask(ilens, xs.shape[1])
        for layer in self.encoders:
            xs, _ = run_layer(layer, generator, xs, pos_emb, mask)
        outs = []
        for s in range(self.num_inf):
            h = xs
            for i in range(self.num_blocks_sd):
                h, _ = run_layer(getattr(self, f"sd{s}_layer_{i}"), generator, h, pos_emb, mask)
            outs.append(self.tap(h))
        return torch.stack(outs, dim=1), ilens, {"intermediate_outs": [], "branch_weights": []}
