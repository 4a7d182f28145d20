"""Adaptive audio-visual fusion with learned per-utterance modality weights
(counterpart of ``tailored_avsr_tpu/models/fusion.py``).

Merge methods: ``concat``, ``learned_ave`` (attention-pooled per-modality
scalar logits, softmax over the two modalities) and ``fixed_ave``; the merged
stream goes through an "upsampling" position-wise FFN (d -> hidden -> d) and
a final LayerNorm. The output mask is audio OR video. In training, with
``acoustic_branch_drop_rate`` > 0, one coin per step (drawn on the CPU from
the generator passed in) sets the learned weights to (0, 1) for the whole
batch: the acoustic branch is dropped (``tailored_avsr_tpu/models/fusion.py:89-90``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import attention_pooled_weight, coin
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward

_LN_EPS = 1e-6  # flax LayerNorm default


class AdaptiveAudioVisualFusion(nn.Module):
    def __init__(
        self,
        output_size: int = 256,
        hidden_units: int = 2048,
        audiovisual_layer_type: str = "upsampling_positionwise",
        merge_method: str = "learned_ave",
        activation_type: str = "swish",
        acoustic_weight: float = 0.5,
        dropout_rate: float = 0.1,
        acoustic_branch_drop_rate: float = 0.0,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.acoustic_branch_drop_rate = float(acoustic_branch_drop_rate)
        if audiovisual_layer_type != "upsampling_positionwise":
            raise ValueError("only upsampling_positionwise fusion is supported")
        if merge_method not in ("concat", "learned_ave", "fixed_ave"):
            raise ValueError(merge_method)
        self.merge_method = merge_method
        self.acoustic_weight = acoustic_weight
        in_size = 2 * output_size if merge_method == "concat" else output_size
        self.audiovisual_layer = PositionwiseFeedForward(
            in_size, hidden_units, dropout_rate, activation_type, output_size=output_size, **kw)
        if merge_method == "learned_ave":
            self.acoustic_pooling_proj = nn.Linear(output_size, 1, **kw)
            self.visual_pooling_proj = nn.Linear(output_size, 1, **kw)
            self.acoustic_weight_proj = nn.Linear(output_size, 1, **kw)
            self.visual_weight_proj = nn.Linear(output_size, 1, **kw)
        self.norm_final = nn.LayerNorm(output_size, eps=_LN_EPS, **kw)

    def forward(self, audio, audio_mask, video, video_mask, generator: Optional[torch.Generator] = None):
        """Returns (audiovisual (B, T, D), av_mask (B, T) or None, weights dict)."""
        aux = {}
        if self.merge_method == "concat":
            av = self.audiovisual_layer(torch.cat([audio, video], dim=-1))
        elif self.merge_method == "learned_ave":
            d = audio.shape[-1]
            wa = attention_pooled_weight(
                audio, audio_mask, self.acoustic_pooling_proj, self.acoustic_weight_proj, d)
            wv = attention_pooled_weight(
                video, video_mask, self.visual_pooling_proj, self.visual_weight_proj, d)
            w = torch.softmax(torch.cat([wa, wv], dim=-1).float(), dim=-1).to(audio.dtype)
            if coin(self.acoustic_branch_drop_rate, self.training, generator):
                w = torch.tensor([0.0, 1.0], dtype=w.dtype, device=w.device).expand_as(w)
            aux["acoustic_weight"], aux["visual_weight"] = w[:, 0], w[:, 1]
            av = self.audiovisual_layer(w[:, 0, None, None] * audio + w[:, 1, None, None] * video)
        else:
            av = self.audiovisual_layer(
                self.acoustic_weight * audio + (1.0 - self.acoustic_weight) * video)
        av = self.norm_final(av)
        if audio_mask is None and video_mask is None:
            return av, None, aux
        ones = torch.ones(av.shape[:2], dtype=torch.bool, device=av.device)
        am = audio_mask if audio_mask is not None else ones
        vm = video_mask if video_mask is not None else ones
        return av, am | vm, aux
