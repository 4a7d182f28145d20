"""CTC head: encoder features -> vocabulary logits, and its loss
(counterpart of ``tailored_avsr_tpu/models/ctc.py``): input dropout, then
``ops/losses.ctc_loss``; posteriors for interCTC conditioning, f32
log-probs and best-path ids for decoding. The projection runs in the
wider of the features' and the weights' types, as a flax Dense promotes
(an RNN encoder's f32 output under bf16 weights gives f32 logits)."""

from __future__ import annotations

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.ops.losses import ctc_loss


class CTCHead(nn.Module):
    def __init__(self, encoder_size: int, vocab_size: int, dropout_rate: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)
        self.ctc_lo = nn.Linear(encoder_size, vocab_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, V) logits."""
        return promoted_linear(self.ctc_lo, self.dropout(x))

    def loss(self, x: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        return ctc_loss(self(x), lengths, labels, label_lengths, reduce=reduce)

    def softmax(self, x: torch.Tensor) -> torch.Tensor:
        """Posteriors in the logits' dtype (interCTC conditioning), as the
        JAX head's ``jax.nn.softmax``."""
        return torch.softmax(self(x), dim=-1)

    def log_softmax(self, x: torch.Tensor) -> torch.Tensor:
        # f32 log-probs even in a bf16 graph, as in the JAX head
        return torch.log_softmax(self(x).float(), dim=-1)

    def argmax(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self(x), dim=-1)
