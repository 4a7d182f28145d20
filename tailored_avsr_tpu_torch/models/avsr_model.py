"""Audio-visual speech recognition model, serving part
(counterpart of ``tailored_avsr_tpu/models/avsr_model.py``: ``_align``,
``encode`` and ``ctc_greedy``).

encode: per-modality frontends, utterance MVN on the audio, embed layers,
alignment of the two streams by padding the shorter one (pad value =
ignore_id), per-modality pos-enc, the tailored encoder, adaptive fusion.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.ops.masking import make_valid_mask, mask_lengths


class AVSRModel(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        encoder: nn.Module,
        audiovisual_fusion: nn.Module,
        ctc: nn.Module,
        acoustic_embed: nn.Module,
        visual_embed: nn.Module,
        acoustic_frontend: Optional[nn.Module] = None,
        visual_frontend: Optional[nn.Module] = None,
        normalize: Optional[nn.Module] = None,
        ignore_id: int = -1,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.acoustic_frontend = acoustic_frontend
        self.visual_frontend = visual_frontend
        self.normalize = normalize
        self.acoustic_embed = acoustic_embed
        self.visual_embed = visual_embed
        self.encoder = encoder
        self.audiovisual_fusion = audiovisual_fusion
        self.ctc = ctc
        self.ignore_id = ignore_id

    @staticmethod
    def _align(a, a_mask, v, v_mask, pad_value: float):
        """Pad the shorter stream (buffer-wise) to the longer with ``pad_value``;
        per-utterance validity stays in the masks."""
        la, lv = a.shape[1], v.shape[1]
        if la < lv:
            a = F.pad(a, (0, 0, 0, lv - la), value=pad_value)
            a_mask = F.pad(a_mask, (0, lv - la), value=False)
        elif lv < la:
            v = F.pad(v, (0, 0, 0, la - lv), value=pad_value)
            v_mask = F.pad(v_mask, (0, la - lv), value=False)
        return a, a_mask, v, v_mask

    def encode(self, audio, audio_lengths, video, video_lengths):
        """Returns (encoder_out (B, T, D), encoder_out_lens (B,) int32, fusion weights)."""
        a_feats, a_lens = audio, audio_lengths
        if self.acoustic_frontend is not None:
            a_feats, a_lens = self.acoustic_frontend(audio, audio_lengths)
        v_feats, v_lens = video, video_lengths
        if self.visual_frontend is not None:
            v_feats, v_lens = self.visual_frontend(video, video_lengths)
        if self.normalize is not None:
            a_feats, a_lens = self.normalize(a_feats, a_lens)

        a_feats, a_lens = self.acoustic_embed.apply_embed_layer(a_feats, a_lens)
        v_feats, v_lens = self.visual_embed.apply_embed_layer(v_feats, v_lens)
        a_mask = make_valid_mask(a_lens, a_feats.shape[1])
        v_mask = make_valid_mask(v_lens, v_feats.shape[1])
        a_feats, a_mask, v_feats, v_mask = self._align(
            a_feats, a_mask, v_feats, v_mask, float(self.ignore_id))
        a_feats, a_pos = self.acoustic_embed.apply_pos_enc(a_feats)
        v_feats, v_pos = self.visual_embed.apply_pos_enc(v_feats)

        a_out, a_mask, v_out, v_mask = self.encoder(a_feats, a_pos, a_mask, v_feats, v_pos, v_mask)
        enc_out, av_mask, fusion_weights = self.audiovisual_fusion(a_out, a_mask, v_out, v_mask)
        enc_lens = mask_lengths(av_mask)
        return enc_out, enc_lens, fusion_weights

    def ctc_greedy(self, audio, audio_lengths, video, video_lengths):
        """Best-path CTC ids (B, T) and encoder lengths (B,)."""
        enc_out, enc_lens, _ = self.encode(audio, audio_lengths, video, video_lengths)
        return self.ctc.argmax(enc_out), enc_lens
