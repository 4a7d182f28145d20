"""Hybrid CTC/attention model for ASR (audio) and VSR (video)
(counterpart of ``ASRModel`` in ``tailored_avsr_tpu/models/asr_model.py``).

encode: frontend (log-mel, sliding window, fused, or the Conv3D +
ResNet-18 lip frontend) -> SpecAug (training only) -> normalisation ->
pre-encoder -> encoder (the CTC head goes in for interCTC conditioning)
-> post-encoder. ``forward`` is the hybrid loss ``ctc_weight *
ctc + (1 - ctc_weight) * att`` with its stats (``loss``, ``loss_ctc``,
``loss_att``, ``acc``, with ``return_ctc_argmax`` the greedy ids, and the
encoder's ``branch_weights``); with ``interctc_weight`` and interCTC taps
the CTC term is ``(1 - w) * ctc + w * mean of the taps' CTC losses``
(``loss_interctc_layer{l}`` each), or the taps' mean alone when
``ctc_weight`` is 0, which then mixes with the attention loss by ``w``.
``hybrid_loss`` computes it for this model and for ``AVSRModel``. With a
transducer branch (``joint_network``; the prediction network is the
``decoder`` module, as in the reference's key grammar) the loss is
``rnnt + ctc_weight * ctc`` (``loss_transducer``), multi-blank when
``transducer_multi_blank_durations`` is set; a Mask-CTC model
(``models/maskctc.py``) takes the MLM loss over uniformly masked targets
in place of the attention loss (``loss_att``, also under ``loss_mlm``).
``model.train()`` is the JAX ``deterministic=False`` (dropout, SpecAug, the
coins, BatchNorm batch statistics), ``model.eval()`` is
``deterministic=True``. The host-side draws come from the CPU
``generator`` passed to ``forward`` / ``encode``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.losses import add_sos_eos, label_smoothing_loss, token_accuracy
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.ops.rnnt import multiblank_rnnt_loss, rnnt_loss


def transducer_loss(model: nn.Module, enc_out, enc_lens, text, text_lengths) -> torch.Tensor:
    """The RNN-T loss of ``model``'s joint and prediction networks
    (``tailored_avsr_tpu/models/asr_model.py:200-215``): multi-blank, with
    the blank at ``len(durations)`` and the big blanks before it, when the
    model has durations."""
    g = model.prediction_network(text)
    logits = model.joint_network(enc_out[:, :, None, :], g[:, None, :, :])
    durs = model.transducer_multi_blank_durations
    if durs:
        return multiblank_rnnt_loss(logits, enc_lens, text, text_lengths, blank_id=len(durs), durations=durs,
                                    sigma=model.transducer_multi_blank_sigma)
    return rnnt_loss(logits, enc_lens, text, text_lengths)


def sos_eos_targets(model: nn.Module, text, text_lengths, generator=None):
    """The attention branch's (ys_in, ys_out): sos/eos packing."""
    return add_sos_eos(text, model.sos, model.eos, model.ignore_id)


def nll(model: nn.Module, enc_out: torch.Tensor, enc_lens: torch.Tensor, ys_pad: torch.Tensor,
        ys_lens: torch.Tensor) -> torch.Tensor:
    """Per-sequence negative log-likelihood (B,) of ``ys_pad`` (padded with
    ``ignore_id`` past ``ys_lens``) under the attention decoder, sos / eos
    added (``tailored_avsr_tpu/models/asr_model.py:232``): the rescoring
    pass of the time-synchronous beam. Bound as ``ASRModel.nll`` and
    ``AVSRModel.nll``."""
    ys_in, ys_out = add_sos_eos(ys_pad, model.sos, model.eos, model.ignore_id)
    memory_mask = make_valid_mask(enc_lens, enc_out.shape[1])
    logp = torch.log_softmax(model.decoder(enc_out, memory_mask, ys_in, ys_lens + 1).float(), dim=-1)
    valid = ys_out != model.ignore_id
    tok_ll = torch.gather(logp, -1, torch.where(valid, ys_out, 0)[..., None].long())[..., 0]
    return -(tok_ll * valid).sum(dim=-1)


def hybrid_loss(model: nn.Module, enc_out, enc_lens, text, text_lengths, return_ctc_argmax: bool = False,
                generator: Optional[torch.Generator] = None,
                intermediate_outs=()) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``model``'s loss over its encoder output (f32) and its stats
    (``tailored_avsr_tpu/models/asr_model.py:117-198``): the CTC term with
    the interCTC taps ``intermediate_outs`` ``[(layer, out)]`` mixed in by
    ``interctc_weight``, then the transducer's ``rnnt + ctc_weight * ctc``,
    or the hybrid CTC/attention loss, whose targets come from
    ``model.attention_targets`` (the Mask-CTC draws from ``generator``).
    ``text`` is (B, L) padded with ``ignore_id``."""
    stats: Dict[str, Any] = {}
    loss_ctc = None
    if model.ctc_weight != 0.0:
        loss_ctc = model.ctc.loss(enc_out, enc_lens, text, text_lengths)
        stats["loss_ctc"] = loss_ctc
    if model.interctc_weight != 0.0 and intermediate_outs:
        loss_inter = 0.0
        for layer, out in intermediate_outs:  # the taps keep the encoder's lengths
            stats[f"loss_interctc_layer{layer}"] = loss_ic = model.ctc.loss(out, enc_lens, text, text_lengths)
            loss_inter = loss_inter + loss_ic
        loss_inter = loss_inter / len(intermediate_outs)
        w = model.interctc_weight
        loss_ctc = loss_inter if loss_ctc is None else (1 - w) * loss_ctc + w * loss_inter
    if model.joint_network is not None:
        loss_tr = transducer_loss(model, enc_out, enc_lens, text, text_lengths)
        stats["loss_transducer"] = loss_tr
        loss = loss_tr if loss_ctc is None else loss_tr + model.ctc_weight * loss_ctc
    elif model.ctc_weight == 1.0 or model.decoder is None:
        loss = loss_ctc
    else:
        ys_in, ys_out = model.attention_targets(text, text_lengths, generator)
        logits = model.decoder(enc_out, make_valid_mask(enc_lens, enc_out.shape[1]), ys_in, text_lengths + 1)
        loss_att = label_smoothing_loss(
            logits, ys_out, model.lsm_weight, model.ignore_id, model.length_normalized_loss)
        stats["loss_att"], stats["acc"] = loss_att, token_accuracy(logits, ys_out, model.ignore_id)
        if model.is_maskctc:
            stats["loss_mlm"] = loss_att
        if loss_ctc is None:
            loss = loss_att
        elif model.ctc_weight == 0.0:  # the interCTC term alone: mixed by its weight
            loss = (1 - model.interctc_weight) * loss_att + model.interctc_weight * loss_ctc
        else:
            loss = model.ctc_weight * loss_ctc + (1 - model.ctc_weight) * loss_att
    stats["loss"] = loss
    if return_ctc_argmax:
        stats["ctc_argmax"] = model.ctc.argmax(enc_out)
        stats["ctc_argmax_lens"] = enc_lens
    return loss, stats


class ASRModel(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        encoder: nn.Module,
        ctc: nn.Module,
        decoder: Optional[nn.Module] = None,
        frontend: Optional[nn.Module] = None,
        specaug: Optional[nn.Module] = None,
        normalize: Optional[nn.Module] = None,
        ctc_weight: float = 0.5,
        ignore_id: int = -1,
        lsm_weight: float = 0.0,
        length_normalized_loss: bool = False,
        joint_network: Optional[nn.Module] = None,
        prediction_network: Optional[nn.Module] = None,
        transducer_multi_blank_durations: Tuple[int, ...] = (),
        transducer_multi_blank_sigma: float = 0.05,
        interctc_weight: float = 0.0,
        preencoder: Optional[nn.Module] = None,
        postencoder: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.frontend = frontend
        self.specaug = specaug
        self.normalize = normalize
        self.preencoder = preencoder
        self.encoder = encoder
        self.postencoder = postencoder
        # the attention decoder, or the transducer's prediction network
        # (``decoder.*`` keys in both cases); None for a CTC-only model
        self.decoder = prediction_network if joint_network is not None else decoder
        self.joint_network = joint_network
        self.transducer_multi_blank_durations = tuple(int(d) for d in transducer_multi_blank_durations)
        self.transducer_multi_blank_sigma = float(transducer_multi_blank_sigma)
        self.ctc = ctc
        self.ctc_weight = float(ctc_weight)
        self.interctc_weight = float(interctc_weight)
        self.ignore_id = ignore_id
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

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """Returns (encoder_out (B, T, D), encoder_out_lens (B,), aux with
        the encoder's ``branch_weights`` and ``intermediate_outs``)."""
        feats, lens = speech, speech_lengths
        if self.frontend is not None:  # the lip frontend's BatchNorm follows the train flag
            feats, lens = self.frontend(speech, speech_lengths)
        if self.specaug is not None and self.training:
            feats, lens = self.specaug(feats, lens, generator)
        if self.normalize is not None:
            feats, lens = self.normalize(feats, lens)
        if self.preencoder is not None:
            feats, lens = self.preencoder(feats, lens)
        enc_out, enc_lens, aux = self.encoder(feats, lens, generator,
                                              ctc=self.ctc if self.encoder.conditioning_layer is not None else None)
        if self.postencoder is not None:  # the interCTC taps keep the encoder's lengths (a linear one's too)
            enc_out, enc_lens = self.postencoder(enc_out, enc_lens)
        return enc_out, enc_lens, aux

    def forward(
        self,
        speech: torch.Tensor,
        speech_lengths: torch.Tensor,
        text: torch.Tensor,
        text_lengths: torch.Tensor,
        return_ctc_argmax: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        enc_out, enc_lens, enc_aux = self.encode(speech, speech_lengths, generator)
        loss, stats = hybrid_loss(self, enc_out, enc_lens, text, text_lengths, return_ctc_argmax, generator,
                                  enc_aux["intermediate_outs"])
        if enc_aux.get("branch_weights"):
            stats["branch_weights"] = enc_aux["branch_weights"]
        return loss, stats

    def ctc_greedy(self, speech, speech_lengths):
        """Best-path CTC ids (B, T) and encoder lengths (B,)."""
        enc_out, enc_lens, _ = self.encode(speech, speech_lengths)
        return self.ctc.argmax(enc_out), enc_lens

    def ctc_logprobs(self, speech, speech_lengths):
        """f32 CTC log-probs (B, T, V) and encoder lengths (B,)."""
        enc_out, enc_lens, _ = self.encode(speech, speech_lengths)
        return self.ctc.log_softmax(enc_out), enc_lens

    def decoder_score_step(self, memory, memory_mask, ys, pos):
        """The full-prefix decoder step (``TransformerDecoder.score_step``)."""
        return self.decoder.score_step(memory, memory_mask, ys, pos)

    nll = nll
