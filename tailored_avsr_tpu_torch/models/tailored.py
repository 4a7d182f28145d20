"""Tailored unified audio-visual encoder
(counterpart of ``tailored_avsr_tpu/models/tailored.py``).

A learned modality embedding is added to each stream; each of the N layers
runs both streams through a per-modality single branch (rel-pos MHA if
``*_use_attn[l]`` else cgMLP), with macaron-FFN and FFN weights shared across
the modalities; per layer and modality: macaron-FFN -> branch -> FFN ->
LayerNorm. When the streams have the same shape, the shared FFNs run on the
stacked [audio; video] batch (one GEMM of twice the rows).

Ported for serving: no stochastic depth and no interCTC taps (the flagship
uses neither).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.attention import RelPositionMultiHeadedAttention
from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalGatingMLP
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward

_LN_EPS = 1e-6  # flax LayerNorm default


class TailoredEncoderLayer(nn.Module):
    def __init__(
        self,
        size: int,
        acoustic_use_attn: bool,
        visual_use_attn: bool,
        attention_heads: int = 4,
        attention_dropout_rate: float = 0.0,
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        linear_units: int = 2048,
        ffn_activation: str = "swish",
        macaron: bool = True,
        dropout_rate: float = 0.1,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.macaron = macaron
        if macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, dropout_rate, ffn_activation, **kw)
            self.norm_ff_macaron = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
        self.norm_ff = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm_final = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)
        self.use_attn = {"acoustic": bool(acoustic_use_attn), "visual": bool(visual_use_attn)}
        for prefix, attn in self.use_attn.items():
            # attribute names follow the reference keys: <m>_attn + <m>_norm_mha,
            # or <m>_cgmlp + <m>_norm_cgmlp
            if attn:
                branch = RelPositionMultiHeadedAttention(
                    size, attention_heads, attention_dropout_rate, use_flash, **kw)
            else:
                branch = ConvolutionalGatingMLP(
                    size, cgmlp_linear_units, cgmlp_conv_kernel, dropout_rate,
                    use_linear_after_conv, gate_activation, use_fused_csgu, **kw)
            kind = "attn" if attn else "cgmlp"
            setattr(self, f"{prefix}_{kind}", branch)
            setattr(self, f"{prefix}_norm_{'mha' if attn else 'cgmlp'}",
                    nn.LayerNorm(size, eps=_LN_EPS, **kw))

    def _branch(self, prefix: str, x, pos_emb, mask):
        attn = self.use_attn[prefix]
        norm = getattr(self, f"{prefix}_norm_{'mha' if attn else 'cgmlp'}")
        h = norm(x)
        if attn:
            h = getattr(self, f"{prefix}_attn")(h, h, h, pos_emb, mask)
        else:
            h = getattr(self, f"{prefix}_cgmlp")(h)
        return x + self.dropout(h)

    def _ffn(self, ffn, norm, x):
        return x + 0.5 * self.dropout(ffn(norm(x)))

    def forward(self, audio, audio_pos_emb, audio_mask, video, video_pos_emb, video_mask):
        stack = audio.shape == video.shape
        b = audio.shape[0]
        a, v = audio, video
        if self.macaron:
            if stack:
                a, v = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron,
                                 torch.cat([a, v], 0)).split(b)
            else:
                a = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron, a)
                v = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron, v)
        a = self._branch("acoustic", a, audio_pos_emb, audio_mask)
        v = self._branch("visual", v, video_pos_emb, video_mask)
        if stack:
            av = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, torch.cat([a, v], 0)))
            a, v = av.split(b)
        else:
            a = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, a))
            v = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, v))
        return a, v


class TailoredEncoder(nn.Module):
    def __init__(
        self,
        output_size: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 12,
        dropout_rate: float = 0.1,
        attention_dropout_rate: float = 0.1,
        ffn_activation_type: str = "swish",
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        gate_activation: str = "identity",
        use_linear_after_conv: bool = False,
        acoustic_use_attn: Sequence[bool] = (True,) * 12,
        visual_use_attn: Sequence[bool] = (False,) * 12,
        macaron: bool = True,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        if len(acoustic_use_attn) != num_blocks or len(visual_use_attn) != num_blocks:
            raise ValueError("acoustic_use_attn / visual_use_attn need one entry per block")
        self.modality_encoding = nn.Embedding(2, output_size, **kw)
        self.encoders = nn.ModuleList(
            TailoredEncoderLayer(
                output_size, acoustic_use_attn[i], visual_use_attn[i], attention_heads,
                attention_dropout_rate, cgmlp_linear_units, cgmlp_conv_kernel,
                use_linear_after_conv, gate_activation, linear_units, ffn_activation_type,
                macaron, dropout_rate, use_flash, use_fused_csgu, **kw,
            )
            for i in range(num_blocks)
        )
        self.after_norm = nn.LayerNorm(output_size, eps=_LN_EPS, **kw)

    def forward(
        self,
        audio: torch.Tensor,
        audio_pos_emb: torch.Tensor,
        audio_mask: Optional[torch.Tensor],
        video: torch.Tensor,
        video_pos_emb: torch.Tensor,
        video_mask: Optional[torch.Tensor],
    ):
        """Returns (audio, audio_mask, video, video_mask), both after ``after_norm``."""
        mod = self.modality_encoding.weight
        audio = audio + mod[0].to(audio.dtype)
        video = video + mod[1].to(video.dtype)
        for layer in self.encoders:
            audio, video = layer(audio, audio_pos_emb, audio_mask, video, video_pos_emb, video_mask)
        return self.after_norm(audio), audio_mask, self.after_norm(video), video_mask
