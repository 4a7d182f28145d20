"""Permutation-invariant training of a multi-speaker ASR model, espnet's
``pit_espnet`` choice (counterpart of ``PITASRModel`` in
``tailored_avsr_tpu/models/pit_model.py``).

The encoder (``MultiSpeakerTransformerEncoder``) gives one encoding per
inferred speaker, (B, num_inf, T, D). The CTC loss of every (inferred,
reference) speaker pair, per utterance (S_inf, S_ref, B), gives each
permutation's speaker-mean loss; each utterance takes its argmin (the
first on ties), the CTC loss is the batch mean of those minima, and the
references are gathered into that order. The attention loss then runs
over the speakers folded into the batch. Targets: ``text`` (B, num_ref,
L) padded with ``ignore_id``, ``text_lengths`` (B, num_ref).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Tuple

import torch

from tailored_avsr_tpu_torch.models.asr_model import ASRModel
from tailored_avsr_tpu_torch.ops.losses import add_sos_eos, label_smoothing_loss, token_accuracy
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.parallel.host_data import global_rows


class PITASRModel(ASRModel):
    def __init__(self, *args, num_inf: int = 2, num_ref: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_inf, self.num_ref = num_inf, num_ref

    def forward(
        self,
        speech: torch.Tensor,
        speech_lengths: torch.Tensor,
        text: torch.Tensor,  # (B, num_ref, L)
        text_lengths: torch.Tensor,  # (B, num_ref)
        return_ctc_argmax: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.num_inf != self.num_ref:
            raise ValueError("PIT requires num_inf == num_ref")
        enc_out, enc_lens, _ = self.encode(speech, speech_lengths, generator)  # (B, S, T, D)
        b, s, t = enc_out.shape[:3]
        if s != self.num_inf:
            raise ValueError(f"the encoder gave {s} speakers, the model infers {self.num_inf}")
        loss_mat = torch.stack([torch.stack([
            self.ctc.loss(enc_out[:, i], enc_lens, text[:, j], text_lengths[:, j], reduce=False)
            for j in range(self.num_ref)]) for i in range(self.num_inf)])  # (S_inf, S_ref, B)
        perms = list(itertools.permutations(range(self.num_ref)))
        perm_losses = torch.stack([sum(loss_mat[i, p[i]] for i in range(self.num_inf)) for p in perms])
        perm_losses = perm_losses / self.num_inf  # (P, B)
        best = torch.argmin(perm_losses, dim=0)  # (B,)
        loss_ctc = perm_losses.amin(dim=0).sum() / global_rows(b)
        best_perm = torch.tensor(perms, dtype=torch.long, device=best.device)[best]  # (B, S)
        text_perm = torch.gather(text, 1, best_perm[:, :, None].expand(-1, -1, text.shape[2]))
        tlen_perm = torch.gather(text_lengths, 1, best_perm)
        enc_flat = enc_out.reshape((b * s,) + enc_out.shape[2:])
        lens_flat = enc_lens.repeat_interleave(s)
        text_flat, tlen_flat = text_perm.reshape(b * s, -1), tlen_perm.reshape(b * s)

        stats: Dict[str, Any] = {"loss_ctc": loss_ctc}
        if self.ctc_weight == 1.0 or self.decoder is None:
            loss = loss_ctc
        else:
            ys_in, ys_out = add_sos_eos(text_flat, self.sos, self.eos, self.ignore_id)
            logits = self.decoder(enc_flat, make_valid_mask(lens_flat, t), ys_in, tlen_flat + 1)
            loss_att = label_smoothing_loss(logits, ys_out, self.lsm_weight, self.ignore_id,
                                            self.length_normalized_loss)
            stats["loss_att"], stats["acc"] = loss_att, token_accuracy(logits, ys_out, self.ignore_id)
            loss = loss_att if self.ctc_weight == 0.0 else (
                self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att)
        stats["loss"] = loss
        if return_ctc_argmax:
            stats["ctc_argmax"] = self.ctc.argmax(enc_flat).reshape(b, s, -1)
            stats["ctc_argmax_lens"] = enc_lens
        return loss, stats
