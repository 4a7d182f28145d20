"""The tailored audio-visual model (``task: avsr``, ``encoder: tailored``),
in plain PyTorch and float32, from the layers of ``model.py``.

- the tailored encoder: both streams padded to one length with -1, scaled
  by sqrt(d), a modality embedding added, 12 layers of a shared macaron
  FFN, a per-modality branch (rel-pos MHA or cgMLP), a shared FFN and a
  shared final norm; the learned-average adaptive fusion;
- the CTC head and the Transformer decoder.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .model import (FFN, CgMLP, Conv2dSubsampling, CTCHead, Decoder, RelPosMHA, VisualFrontend, dequantize_audio,
                    dequantize_video, layer_norm, logmel, pooled_weight, rel_pos_table, sub4, utterance_mvn)

IGNORE_ID = -1.0  # the pad of both streams before the encoder


class TailoredLayer(nn.Module):
    def __init__(self, d, h, units, cg_units, cg_kernel, acoustic_attn: bool, visual_attn: bool):
        super().__init__()
        self.use_attn = {"acoustic": acoustic_attn, "visual": visual_attn}
        self.feed_forward = FFN(d, units)
        self.feed_forward_macaron = FFN(d, units)
        self.norm_ff = nn.LayerNorm(d)
        self.norm_ff_macaron = nn.LayerNorm(d)
        self.norm_final = nn.LayerNorm(d)
        for mod, attn in self.use_attn.items():
            if attn:
                setattr(self, f"{mod}_attn", RelPosMHA(d, h))
                setattr(self, f"{mod}_norm_mha", nn.LayerNorm(d))
            else:
                setattr(self, f"{mod}_cgmlp", CgMLP(d, cg_units, cg_kernel))
                setattr(self, f"{mod}_norm_cgmlp", nn.LayerNorm(d))

    def stream(self, x, pos, mask, mod):
        x = x + 0.5 * self.feed_forward_macaron(layer_norm(x, self.norm_ff_macaron))
        if self.use_attn[mod]:
            x = x + getattr(self, f"{mod}_attn")(layer_norm(x, getattr(self, f"{mod}_norm_mha")), pos, mask)
        else:
            x = x + getattr(self, f"{mod}_cgmlp")(layer_norm(x, getattr(self, f"{mod}_norm_cgmlp")))
        return layer_norm(x + 0.5 * self.feed_forward(layer_norm(x, self.norm_ff)), self.norm_final)


class TailoredAVSR(nn.Module):
    """The tailored audio-visual model (``task: avsr``, ``encoder: tailored``)."""

    def __init__(self, cfg: Dict, vocab: int):
        super().__init__()
        enc = cfg["encoder_conf"]
        d, h = enc["output_size"], enc["attention_heads"]
        self.d = d
        self.visual_frontend = VisualFrontend()
        self.acoustic_embed = nn.Module()
        self.acoustic_embed.embed = Conv2dSubsampling(d)
        self.visual_embed = nn.Module()
        self.visual_embed.embed = nn.Sequential(nn.Linear(512, d), nn.LayerNorm(d))
        self.encoder = nn.Module()
        self.encoder.modality_encoding = nn.Embedding(2, d)
        self.encoder.encoders = nn.ModuleList([
            TailoredLayer(d, h, enc["linear_units"], enc["cgmlp_linear_units"], enc["cgmlp_conv_kernel"], aa, va)
            for aa, va in zip(enc["acoustic_use_attn"], enc["visual_use_attn"])])
        self.encoder.after_norm = nn.LayerNorm(d)
        fus = cfg["audiovisual_fusion_conf"]
        self.audiovisual_fusion = nn.Module()
        self.audiovisual_fusion.audiovisual_layer = FFN(d, fus["hidden_units"])
        for name in ("acoustic_pooling_proj", "visual_pooling_proj", "acoustic_weight_proj", "visual_weight_proj"):
            setattr(self.audiovisual_fusion, name, nn.Linear(d, 1))
        self.audiovisual_fusion.norm_final = nn.LayerNorm(d)
        self.ctc = CTCHead(d, vocab)
        dec = cfg["decoder_conf"]
        self.decoder = Decoder(vocab, d, dec["attention_heads"], dec["linear_units"], dec["num_blocks"])

    def encode(self, audio, audio_lengths, video, video_lengths):
        """Dequantised (B, S) audio and (B, T, 88, 88) video -> (enc (B, T, D), lengths (B,))."""
        a, a_lens = logmel(audio, audio_lengths)
        a = self.acoustic_embed.embed(utterance_mvn(a, a_lens))
        a_lens = sub4(a_lens)
        v = self.visual_embed.embed
        v = layer_norm(ops.linear(self.visual_frontend(video), v[0]), v[1])
        t = max(a.shape[1], v.shape[1])
        dev = a.device
        a_mask = torch.arange(t, device=dev)[None] < a_lens[:, None]
        v_mask = torch.arange(t, device=dev)[None] < video_lengths[:, None]
        a = F.pad(a, (0, 0, 0, t - a.shape[1]), value=IGNORE_ID)
        v = F.pad(v, (0, 0, 0, t - v.shape[1]), value=IGNORE_ID)
        pos = rel_pos_table(t, self.d, dev)
        mod = self.encoder.modality_encoding.weight
        a, v = a * math.sqrt(self.d) + mod[0], v * math.sqrt(self.d) + mod[1]
        for layer in self.encoder.encoders:
            a, v = layer.stream(a, pos, a_mask, "acoustic"), layer.stream(v, pos, v_mask, "visual")
        a, v = layer_norm(a, self.encoder.after_norm), layer_norm(v, self.encoder.after_norm)
        fus = self.audiovisual_fusion
        w = torch.softmax(torch.cat([pooled_weight(a, a_mask, fus.acoustic_pooling_proj, fus.acoustic_weight_proj),
                                     pooled_weight(v, v_mask, fus.visual_pooling_proj, fus.visual_weight_proj)], -1), -1)
        av = layer_norm(fus.audiovisual_layer(w[:, 0, None, None] * a + w[:, 1, None, None] * v), fus.norm_final)
        return av, (a_mask | v_mask).sum(-1)

    def inputs(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (dequantize_audio(batch["audio"], batch["audio_lengths"]), batch["audio_lengths"],
                dequantize_video(batch["video"], batch["video_lengths"]), batch["video_lengths"])
