"""Audio-visual speech recognition model
(counterpart of ``tailored_avsr_tpu/models/avsr_model.py``).

encode: per-modality frontends, SpecAug on the audio features (training
only), normalisation of the audio, per-modality pre-encoders, embed
layers, alignment of the two streams by padding the shorter one (pad
value = ignore_id), per-modality pos-enc, the tailored or the
conventional encoder, adaptive fusion, the post-encoder.

With interCTC taps in the encoder, the model's fusion module goes into it
(each tap is the fused pair of stream taps) and, with
``interctc_use_conditioning``, its CTC head.

``forward`` is the hybrid CTC/attention loss of
``tailored_avsr_tpu/models/avsr_model.py:155-237`` (``models/asr_model.py``
``hybrid_loss``, shared with the ASR model, interCTC included): ``(loss,
stats)`` with ``loss``, ``loss_ctc``, ``loss_att``, ``acc`` and, with ``return_ctc_argmax``,
``ctc_argmax`` / ``ctc_argmax_lens``; a transducer branch or a Mask-CTC
model (``models/maskctc.py``) as in ``hybrid_loss``. ``model.train()`` is the JAX
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

from tailored_avsr_tpu_torch.models.asr_model import hybrid_loss, nll, sos_eos_targets
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
        joint_network: Optional[nn.Module] = None,
        prediction_network: Optional[nn.Module] = None,
        transducer_multi_blank_durations: Tuple[int, ...] = (),
        transducer_multi_blank_sigma: float = 0.05,
        interctc_weight: float = 0.0,
        acoustic_preencoder: Optional[nn.Module] = None,
        visual_preencoder: Optional[nn.Module] = None,
        postencoder: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.acoustic_frontend = acoustic_frontend
        self.visual_frontend = visual_frontend
        self.acoustic_preencoder = acoustic_preencoder
        self.visual_preencoder = visual_preencoder
        self.postencoder = postencoder
        self.specaug = specaug
        self.normalize = normalize
        self.acoustic_embed = acoustic_embed
        self.visual_embed = visual_embed
        self.encoder = encoder
        self.audiovisual_fusion = audiovisual_fusion
        self.ctc = ctc
        # the attention decoder, or the transducer's prediction network
        # (``decoder.*`` keys in both cases); None for a CTC-only model
        self.decoder = prediction_network if joint_network is not None else decoder
        self.joint_network = joint_network
        self.transducer_multi_blank_durations = tuple(int(d) for d in transducer_multi_blank_durations)
        self.transducer_multi_blank_sigma = float(transducer_multi_blank_sigma)
        self.ignore_id = ignore_id
        self.ctc_weight = float(ctc_weight)
        self.interctc_weight = float(interctc_weight)
        self.lsm_weight = float(lsm_weight)
        self.length_normalized_loss = bool(length_normalized_loss)

    is_maskctc = False
    attention_targets = sos_eos_targets

    @property
    def prediction_network(self) -> Optional[nn.Module]:
        return self.decoder if self.joint_network is not None else None

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
        """Returns (encoder_out (B, T, D), encoder_out_lens (B,) int32, aux):
        aux holds ``fusion_weights`` and, for the conventional encoder, its
        ``branch_weights``."""
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
        if self.acoustic_preencoder is not None:
            a_feats, a_lens = self.acoustic_preencoder(a_feats, a_lens)
        if self.visual_preencoder is not None:
            v_feats, v_lens = self.visual_preencoder(v_feats, v_lens)

        a_feats, a_lens = self.acoustic_embed.apply_embed_layer(a_feats, a_lens)
        v_feats, v_lens = self.visual_embed.apply_embed_layer(v_feats, v_lens)
        a_mask = make_valid_mask(a_lens, a_feats.shape[1])
        v_mask = make_valid_mask(v_lens, v_feats.shape[1])
        a_feats, a_mask, v_feats, v_mask = self._align(
            a_feats, a_mask, v_feats, v_mask, float(self.ignore_id))
        a_feats, a_pos = self.acoustic_embed.apply_pos_enc(a_feats)
        v_feats, v_pos = self.visual_embed.apply_pos_enc(v_feats)

        a_out, a_mask, v_out, v_mask, enc_aux = self.encoder(
            a_feats, a_pos, a_mask, v_feats, v_pos, v_mask, generator,
            ctc=self.ctc if self.encoder.conditioning_layer is not None else None,
            audiovisual_fusion=self.audiovisual_fusion if self.encoder.interctc_layers else None)
        enc_out, av_mask, fusion_weights = self.audiovisual_fusion(
            a_out, a_mask, v_out, v_mask, generator)
        enc_lens = mask_lengths(av_mask)
        if self.postencoder is not None:  # the interCTC taps keep the encoder's lengths
            enc_out, enc_lens = self.postencoder(enc_out, enc_lens)
        return enc_out, enc_lens, dict(enc_aux, fusion_weights=fusion_weights)

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
        its stats (``models/asr_model.hybrid_loss``). ``text`` is (B, L)
        padded with ``ignore_id``."""
        enc_out, enc_lens, enc_aux = self.encode(audio, audio_lengths, video, video_lengths, generator)
        loss, stats = hybrid_loss(self, enc_out, enc_lens, text, text_lengths, return_ctc_argmax, generator,
                                  enc_aux["intermediate_outs"])
        if enc_aux["fusion_weights"]:
            stats["fusion_weights"] = enc_aux["fusion_weights"]
        return loss, stats

    def ctc_greedy(self, audio, audio_lengths, video, video_lengths):
        """Best-path CTC ids (B, T) and encoder lengths (B,)."""
        enc_out, enc_lens, _ = self.encode(audio, audio_lengths, video, video_lengths)
        return self.ctc.argmax(enc_out), enc_lens

    def decoder_score_step(self, memory, memory_mask, ys, pos):
        """The full-prefix decoder step (``TransformerDecoder.score_step``)."""
        return self.decoder.score_step(memory, memory_mask, ys, pos)

    nll = nll
