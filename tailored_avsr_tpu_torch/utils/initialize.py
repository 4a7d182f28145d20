"""Seeded parameter initialisation from a ``torch.Generator``.

Every parameter and buffer of the port's model is drawn here, on the CPU,
from one generator, so a seed gives the same weights on any device. The
scheme follows flax's defaults, which the JAX package initialises with:
kernels LeCun-normal (std 1/sqrt(fan_in)), biases 0, norm scales 1 and
shifts 0, BatchNorm running statistics 0 / 1, the modality embedding
normal with std 1/sqrt(d), and the rel-pos u/v biases Xavier-uniform.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tailored_avsr_tpu_torch.ops.attention import RelPositionMultiHeadedAttention

_NORMS = (nn.LayerNorm, nn.BatchNorm2d, nn.BatchNorm3d)
_KERNELS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * std


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``model`` in place; raises if one is
    left that this scheme does not know (its memory could be garbage after
    ``to_empty``)."""
    done = set()

    def put(t: torch.Tensor, value: torch.Tensor) -> None:
        t.copy_(value)
        done.add(id(t))

    for module in model.modules():
        if isinstance(module, _KERNELS):
            w = module.weight
            fan_in = w[0].numel()  # in_features (x kernel taps) per output unit
            put(w, _normal(w.shape, 1.0 / math.sqrt(fan_in), generator))
            if module.bias is not None:
                put(module.bias, torch.zeros(module.bias.shape))
        elif isinstance(module, _NORMS):
            put(module.weight, torch.ones(module.weight.shape))
            put(module.bias, torch.zeros(module.bias.shape))
            if isinstance(module, (nn.BatchNorm2d, nn.BatchNorm3d)):
                put(module.running_mean, torch.zeros(module.running_mean.shape))
                put(module.running_var, torch.ones(module.running_var.shape))
                put(module.num_batches_tracked, torch.zeros((), dtype=torch.long))
        elif isinstance(module, nn.Embedding):
            w = module.weight
            put(w, _normal(w.shape, 1.0 / math.sqrt(w.shape[1]), generator))
        elif isinstance(module, RelPositionMultiHeadedAttention):
            for p in (module.pos_bias_u, module.pos_bias_v):
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                put(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    left = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if id(t) not in done]
    if left:
        raise RuntimeError(f"init_params_: no initialiser for {left[:5]}")
    return model
