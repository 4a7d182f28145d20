"""Contextual-block streaming encoder with Transformer or Conformer layers
(counterpart of ``tailored_avsr_tpu/models/contextual_block.py``), espnet's
``contextual_block_transformer`` / ``contextual_block_conformer``.

The embedded, position-encoded frames are unfolded into blocks of
``block_size`` frames every ``hop_size`` (the tail ``block_size -
hop_size`` frames of a block are its look-ahead). Each block carries a
context token, first the average of its valid frames (``init_average``,
else its first frame). Every layer runs over (B * n_blocks, block + 2, D):
[the previous block's context token; the block's frames; its own context
token], all blocks at once; between layers each block takes the context
token its left neighbour produced, so information crosses block
boundaries only through those tokens. Output frame j is block j // hop's
position j % hop; ``after_norm`` follows, and padded frames are zero.

The layers run plain self-attention (``selfattn``, the absolute MHA, no
flash-attention kernel, as the JAX package runs it): the unfold breaks the
relative positions, so a rel-pos config or another attention type raises
``ValueError``, as in JAX. ``decode/streaming.py`` runs the same layers one
block at a time.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder, run_layer
from tailored_avsr_tpu_torch.models.conformer import ConformerEncoderLayer
from tailored_avsr_tpu_torch.models.transformer_encoder import TransformerEncoderLayer


def block_average(frames: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., blk, D) frames, (..., blk) validity -> the mean of the valid
    frames (..., D) (a block with none gives 0): a context token's start."""
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1)
    return (frames * mask[..., None]).sum(-2) / denom


class ContextualBlockEncoder(BranchformerEncoder):
    """The Branchformer scaffold (input layer, positional encoding,
    ``after_norm``) with per-block layers: ``block_layer`` ``transformer``
    (MHA + FFN) or ``conformer`` (macaron FFN, MHA, conv module, FFN)."""

    def __init__(self, *args, block_size: int = 40, hop_size: int = 16, look_ahead: int = 16,
                 init_average: bool = True, block_layer: str = "transformer", cnn_module_kernel: int = 31, **kwargs):
        # read by make_layer, inside the base constructor
        self.block_size, self.hop_size, self.look_ahead = block_size, hop_size, look_ahead
        self.init_average, self.block_layer, self.cnn_module_kernel = init_average, block_layer, cnn_module_kernel
        self.pos_enc_layer_type = kwargs.get("pos_enc_layer_type", "rel_pos")
        self.attention_layer_type = kwargs.get("attention_layer_type", "rel_selfattn")
        super().__init__(*args, **kwargs)

    def make_layer(self, i, conf, cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate, kw):
        if self.pos_enc_layer_type not in ("abs_pos", "scaled_abs_pos"):
            raise ValueError("contextual_block encoders require pos_enc_layer_type 'abs_pos' or 'scaled_abs_pos' "
                             f"(block processing discards relative tables); got {self.pos_enc_layer_type!r}")
        if self.attention_layer_type != "selfattn":
            raise ValueError("contextual_block encoders run plain self-attention within blocks; got "
                             f"attention_layer_type {self.attention_layer_type!r}")
        c = conf
        if self.block_layer == "conformer":
            return ConformerEncoderLayer(
                c["size"], c["heads"], "selfattn", c["att_dropout"], self.cnn_module_kernel, c["linear_units"],
                c["ffn_activation"], True, c["dropout"], stochastic_depth_rate, False, **kw)
        return TransformerEncoderLayer(
            c["size"], c["heads"], "selfattn", c["att_dropout"], c["linear_units"], c["ffn_activation"],
            c["dropout"], stochastic_depth_rate, 0, False, **kw)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor, generator: Optional[torch.Generator] = None,
                ctc=None):
        """(B, T, F) features -> (encoder_out (B, T', D), lengths, aux with
        no interCTC taps and no branch weights)."""
        xs, ilens, _ = self.embed_frames(xs, ilens)
        b, t, d = xs.shape
        hop, blk = self.hop_size, self.block_size
        n = max(1, -(-t // hop))  # every frame in some block's hop region
        t_pad = (n - 1) * hop + blk
        dev = xs.device
        xs = F.pad(xs, (0, 0, 0, t_pad - t))
        valid = torch.arange(t_pad, device=dev)[None, :] < ilens.to(dev)[:, None]  # (B, Tp)
        idx = (torch.arange(n, device=dev) * hop)[:, None] + torch.arange(blk, device=dev)[None, :]  # (n, blk)
        blocks, bmask = xs[:, idx], valid[:, idx]  # (B, n, blk, D), (B, n, blk)
        ctx = block_average(blocks, bmask) if self.init_average else blocks[:, :, 0]
        has_prev = (torch.arange(n, device=dev) > 0)[None, :, None].expand(b, n, 1)
        smask = torch.cat([has_prev, bmask, torch.ones((b, n, 1), dtype=torch.bool, device=dev)], dim=2)
        smask = smask.reshape(b * n, blk + 2)
        for layer in self.encoders:
            prev_ctx = F.pad(ctx, (0, 0, 1, 0))[:, :-1]  # block i reads block i - 1's token
            seq = torch.cat([prev_ctx[:, :, None], blocks, ctx[:, :, None]], dim=2)
            out, _ = run_layer(layer, generator, seq.reshape(b * n, blk + 2, d), None, smask)
            out = out.reshape(b, n, blk + 2, d)
            blocks, ctx = out[:, :, 1:-1], out[:, :, -1]
        y = blocks[:, :, :hop].reshape(b, n * hop, d)[:, :t]
        if self.after_norm is not None:
            y = self.after_norm(y)
        y = torch.where(valid[:, :t, None], y, torch.zeros((), dtype=y.dtype, device=dev))
        return y, ilens, {"intermediate_outs": [], "branch_weights": []}
