"""Audio-visual speech recognition model
(counterpart of ``tailored_avsr_tpu/models/avsr_model.py``).

encode: per-modality frontends, SpecAug on the audio features (training
only), utterance MVN on the audio, embed layers, alignment of the two
streams by padding the shorter one (pad value = ignore_id), per-modality
pos-enc, the tailored encoder, adaptive fusion.

``forward`` is the hybrid CTC/attention loss of
``tailored_avsr_tpu/models/avsr_model.py:155-237`` with the attention loss
of ``models/asr_model.py:104-115``: ``(loss, stats)`` with ``loss``,
``loss_ctc``, ``loss_att``, ``acc`` and, with ``return_ctc_argmax``,
``ctc_argmax`` / ``ctc_argmax_lens``. ``model.train()`` is the JAX
``deterministic=False`` (dropout, SpecAug, stochastic depth, branch drop,
BatchNorm batch statistics), ``model.eval()`` is ``deterministic=True``.
The host-side draws (SpecAug, the stochastic-depth and branch-drop coins)
come from the CPU ``generator`` passed to ``forward`` / ``encode``;
dropout draws from torch's generator of the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.ops.losses import add_sos_eos, label_smoothing_loss, token_accuracy
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
        decoder: Optional[nn.Module] = None,
        specaug: Optional[nn.Module] = None,
        ctc_weight: float = 0.5,
        lsm_weight: float = 0.0,
        length_normalized_loss: bool = False,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.acoustic_frontend = acoustic_frontend
        self.visual_frontend = visual_frontend
        self.specaug = specaug
        self.normalize = normalize
        self.acoustic_embed = acoustic_embed
        self.visual_embed = visual_embed
        self.encoder = encoder
        self.audiovisual_fusion = audiovisual_fusion
        self.ctc = ctc
        self.decoder = decoder  # None for a CTC-only model (ctc_weight 1.0)
        self.ignore_id = ignore_id
        self.ctc_weight = float(ctc_weight)
        self.lsm_weight = float(lsm_weight)
        self.length_normalized_loss = bool(length_normalized_loss)

    @property
    def sos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

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

    def encode(self, audio, audio_lengths, video, video_lengths,
               generator: Optional[torch.Generator] = None):
        """Returns (encoder_out (B, T, D), encoder_out_lens (B,) int32, fusion weights)."""
        a_feats, a_lens = audio, audio_lengths
        if self.acoustic_frontend is not None:
            a_feats, a_lens = self.acoustic_frontend(audio, audio_lengths)
        v_feats, v_lens = video, video_lengths
        if self.visual_frontend is not None:
            v_feats, v_lens = self.visual_frontend(video, video_lengths)
        if self.specaug is not None and self.training:
            a_feats, a_lens = self.specaug(a_feats, a_lens, generator)
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

        a_out, a_mask, v_out, v_mask = self.encoder(
            a_feats, a_pos, a_mask, v_feats, v_pos, v_mask, generator)
        enc_out, av_mask, fusion_weights = self.audiovisual_fusion(
            a_out, a_mask, v_out, v_mask, generator)
        enc_lens = mask_lengths(av_mask)
        return enc_out, enc_lens, fusion_weights

    def _calc_att_loss(self, enc_out, enc_lens, text, text_lengths):
        ys_in, ys_out = add_sos_eos(text, self.sos, self.eos, self.ignore_id)
        memory_mask = make_valid_mask(enc_lens, enc_out.shape[1])
        logits = self.decoder(enc_out, memory_mask, ys_in, text_lengths + 1)
        loss_att = label_smoothing_loss(
            logits, ys_out, self.lsm_weight, self.ignore_id, self.length_normalized_loss)
        return loss_att, token_accuracy(logits, ys_out, self.ignore_id)

    def forward(
        self,
        audio: torch.Tensor,
        audio_lengths: torch.Tensor,
        video: torch.Tensor,
        video_lengths: torch.Tensor,
        text: torch.Tensor,
        text_lengths: torch.Tensor,
        return_ctc_argmax: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Hybrid loss ``ctc_weight * ctc + (1 - ctc_weight) * att`` (f32) and
        its stats. ``text`` is (B, L) padded with ``ignore_id``."""
        enc_out, enc_lens, fusion_weights = self.encode(
            audio, audio_lengths, video, video_lengths, generator)
        stats: Dict[str, Any] = {}
        loss_ctc = None
        if self.ctc_weight != 0.0:
            loss_ctc = self.ctc.loss(enc_out, enc_lens, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
        if self.ctc_weight == 1.0 or self.decoder is None:
            loss = loss_ctc
        else:
            loss_att, acc = self._calc_att_loss(enc_out, enc_lens, text, text_lengths)
            stats["loss_att"], stats["acc"] = loss_att, acc
            if loss_ctc is None:
                loss = loss_att
            else:
                loss = self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att
        stats["loss"] = loss
        if return_ctc_argmax:
            stats["ctc_argmax"] = self.ctc.argmax(enc_out)
            stats["ctc_argmax_lens"] = enc_lens
        if fusion_weights:
            stats["fusion_weights"] = fusion_weights
        return loss, stats

    def ctc_greedy(self, audio, audio_lengths, video, video_lengths):
        """Best-path CTC ids (B, T) and encoder lengths (B,)."""
        enc_out, enc_lens, _ = self.encode(audio, audio_lengths, video, video_lengths)
        return self.ctc.argmax(enc_out), enc_lens
