"""The audio-only Branchformer (``task: asr``, ``encoder: branchformer``),
in plain PyTorch and float32, from the layers of ``model.py``.

- the Branchformer encoder: conv2d subsampling, x sqrt(d), 12 layers of a
  macaron FFN, an attention and a cgMLP branch merged by their learned
  average, a FFN and a final norm;
- the CTC head and the Transformer decoder.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from . import ops
from .model import (FFN, CgMLP, Conv2dSubsampling, CTCHead, Decoder, RelPosMHA, dequantize_audio, layer_norm, logmel,
                    pooled_weight, rel_pos_table, sub4, utterance_mvn)


class BranchformerLayer(nn.Module):
    def __init__(self, d, h, units, cg_units, cg_kernel):
        super().__init__()
        self.feed_forward_macaron = FFN(d, units)
        self.norm_ff_macaron = nn.LayerNorm(d)
        self.attn = RelPosMHA(d, h)
        self.norm_mha = nn.LayerNorm(d)
        self.cgmlp = CgMLP(d, cg_units, cg_kernel)
        self.norm_mlp = nn.LayerNorm(d)
        self.feed_forward = FFN(d, units)
        self.norm_ff = nn.LayerNorm(d)
        self.norm_final = nn.LayerNorm(d)
        self.merge_proj = nn.Linear(d, d)
        for name in ("pooling_proj1", "pooling_proj2", "weight_proj1", "weight_proj2"):
            setattr(self, name, nn.Linear(d, 1))

    def forward(self, x, pos, mask):
        x = x + 0.5 * self.feed_forward_macaron(layer_norm(x, self.norm_ff_macaron))
        x1 = self.attn(layer_norm(x, self.norm_mha), pos, mask)
        x2 = self.cgmlp(layer_norm(x, self.norm_mlp))
        w = torch.softmax(torch.cat([pooled_weight(x1, mask, self.pooling_proj1, self.weight_proj1),
                                     pooled_weight(x2, mask, self.pooling_proj2, self.weight_proj2)], -1), -1)
        x = x + ops.linear(w[:, 0, None, None] * x1 + w[:, 1, None, None] * x2, self.merge_proj)
        return layer_norm(x + 0.5 * self.feed_forward(layer_norm(x, self.norm_ff)), self.norm_final)


class BranchformerASR(nn.Module):
    """The audio-only Branchformer (``task: asr``, ``encoder: branchformer``)."""

    def __init__(self, cfg: Dict, vocab: int):
        super().__init__()
        enc = cfg["encoder_conf"]
        d, h = enc["output_size"], enc["attention_heads"]
        self.d = d
        self.encoder = nn.Module()
        self.encoder.embed = Conv2dSubsampling(d, out_seq=True)
        self.encoder.encoders = nn.ModuleList([
            BranchformerLayer(d, h, enc["linear_units"], enc["cgmlp_linear_units"], enc["cgmlp_conv_kernel"])
            for _ in range(enc["num_blocks"])])
        self.encoder.after_norm = nn.LayerNorm(d)
        self.ctc = CTCHead(d, vocab)
        dec = cfg["decoder_conf"]
        self.decoder = Decoder(vocab, d, dec["attention_heads"], dec["linear_units"], dec["num_blocks"])

    def encode(self, speech, speech_lengths):
        x, lens = logmel(speech, speech_lengths)
        x = self.encoder.embed(utterance_mvn(x, lens)) * math.sqrt(self.d)
        lens = sub4(lens)
        t = x.shape[1]
        mask = torch.arange(t, device=x.device)[None] < lens[:, None]
        pos = rel_pos_table(t, self.d, x.device)
        for layer in self.encoder.encoders:
            x = layer(x, pos, mask)
        return layer_norm(x, self.encoder.after_norm), lens

    def inputs(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return dequantize_audio(batch["speech"], batch["speech_lengths"]), batch["speech_lengths"]
