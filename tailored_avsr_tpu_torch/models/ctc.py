"""CTC head: encoder features -> vocabulary logits
(counterpart of ``tailored_avsr_tpu/models/ctc.py``, serving part: no loss)."""

from __future__ import annotations

import torch
from torch import nn


class CTCHead(nn.Module):
    def __init__(self, encoder_size: int, vocab_size: int, dropout_rate: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate)
        self.ctc_lo = nn.Linear(encoder_size, vocab_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, V) logits."""
        return self.ctc_lo(self.dropout(x))

    def log_softmax(self, x: torch.Tensor) -> torch.Tensor:
        # f32 log-probs even in a bf16 graph, as in the JAX head
        return torch.log_softmax(self(x).float(), dim=-1)

    def argmax(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self(x), dim=-1)
