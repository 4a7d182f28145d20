"""AVSR embedding layers with the split embed / pos-enc API
(counterpart of ``tailored_avsr_tpu/models/embedding.py``).

Audio uses Conv2dSubsampling (x4 in time) without pos-enc; video uses
Linear(512 -> d) + LayerNorm + Dropout. ``apply_embed_layer`` runs before
the temporal alignment of the two streams and ``apply_pos_enc`` after it, so
both streams share one positional index space. The positional encoding is
``rel_pos`` (``legacy_rel_pos`` under ``rel_pos_type: legacy``),
``legacy_rel_pos``, ``abs_pos`` or ``scaled_abs_pos``; the absolute ones
give no table (``pos_emb`` None).
"""

from __future__ import annotations

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.posenc import RELATIVE, positional_encoding
from tailored_avsr_tpu_torch.ops.subsampling import Conv2dSubsampling, subsampled_length

_LN_EPS = 1e-6  # flax LayerNorm default


class DefaultEmbeddingLayerForAVSR(nn.Module):
    def __init__(
        self,
        input_size: int,
        output_size: int = 256,
        input_layer: str = "conv2d",
        pos_enc_layer_type: str = "rel_pos",
        rel_pos_type: str = "latest",
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.input_layer = input_layer
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, 4, **kw)
        elif input_layer == "linear":
            self.embed = nn.Sequential(
                nn.Linear(input_size, output_size, **kw),
                nn.LayerNorm(output_size, eps=_LN_EPS, **kw),
                nn.Dropout(dropout_rate),
            )
        else:
            raise ValueError(f"unknown input_layer: {input_layer}")
        if rel_pos_type == "legacy" and pos_enc_layer_type == "rel_pos":
            pos_enc_layer_type = "legacy_rel_pos"
        self.relative = pos_enc_layer_type in RELATIVE
        self.pos_enc = positional_encoding(pos_enc_layer_type, positional_dropout_rate, **kw)

    def apply_embed_layer(self, x: torch.Tensor, lengths: torch.Tensor):
        """Project a stream to d_model before temporal alignment."""
        x = self.embed(x)
        if self.input_layer == "conv2d":
            lengths = subsampled_length(lengths, 4)
        return x, lengths

    def apply_pos_enc(self, x: torch.Tensor):
        """Positional encoding after alignment: (x, pos_emb or None)."""
        return self.pos_enc(x) if self.relative else (self.pos_enc(x), None)
