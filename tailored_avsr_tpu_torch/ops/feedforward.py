"""Position-wise feed-forward and activations
(counterpart of ``tailored_avsr_tpu/ops/feedforward.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact erf form, as the JAX package uses
    "swish": F.silu,
    "silu": F.silu,
    "selu": F.selu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "sigmoid": torch.sigmoid,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {name}")
    return _ACTIVATIONS[name]


class PositionwiseFeedForward(nn.Module):
    """d_model -> hidden -> activation -> dropout -> d_out (``w_1``, ``w_2``)."""

    def __init__(
        self,
        input_size: int,
        hidden_units: int,
        dropout_rate: float = 0.1,
        activation: str = "relu",
        output_size: Optional[int] = None,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w_1 = nn.Linear(input_size, hidden_units, **kw)
        self.w_2 = nn.Linear(hidden_units, output_size or input_size, **kw)
        self.activation = get_activation(activation)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(self.activation(self.w_1(x))))
