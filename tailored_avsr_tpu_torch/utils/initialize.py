"""Seeded parameter initialisation from a ``torch.Generator``.

Every parameter and buffer of the port's model is drawn here, on the CPU,
from one generator, so a seed gives the same weights on any device. The
scheme follows flax's defaults, which the JAX package initialises with:
kernels LeCun-normal (std 1/sqrt(fan_in)), biases 0, norm scales 1 and
shifts 0, BatchNorm running statistics 0 / 1, global MVN statistics 0 / 1
(mean / std), the modality embedding
normal with std 1/sqrt(d), the rel-pos u/v biases Xavier-uniform, the
scaled positional encoding's alpha 1, an
LSTM layer as flax's ``OptimizedLSTMCell``: each gate's input kernel
LeCun-normal, its recurrent kernel orthogonal, biases 0; a conv decoder
layer's ``conv_weight`` (wshare, taps) LeCun-normal over its wshare fan-in
and ``conv_bias`` 0; an S4D layer's six leaves as the JAX layer draws
them (``models/s4_decoder.s4_initial_values``).

``initialize`` is a config's ``init`` scheme
(``tailored_avsr_tpu/utils/initialize.py``), applied after that init:
every flax ``kernel`` of ndim >= 2 redrawn by ``xavier_uniform``,
``xavier_normal``, ``kaiming_uniform`` or ``kaiming_normal`` with flax's
variance-scaling fans (a depthwise conv's receptive field its taps),
every ``bias`` 0, every ``scale`` 1; embeddings, the rel-pos biases, the
positional ``alpha``, the BatchNorm statistics, the conv decoders'
``conv_weight`` / ``conv_bias`` and the S4D leaves kept (their flax names
are not ``kernel``, ``bias`` or ``scale``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.decoder import ConvDecoderLayer
from tailored_avsr_tpu_torch.models.s4_decoder import S4DLayer, s4_initial_values
from tailored_avsr_tpu_torch.ops.attention import RelPositionMultiHeadedAttention
from tailored_avsr_tpu_torch.ops.normalize import GlobalMVN
from tailored_avsr_tpu_torch.ops.posenc import ScaledPositionalEncoding
from tailored_avsr_tpu_torch.ops.rnnt import LSTMLayer

_BATCH_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)
_NORMS = (nn.LayerNorm, *_BATCH_NORMS)
_KERNELS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * std


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """An (n, n) orthogonal matrix: Q of a Gaussian's QR, signs fixed by R's diagonal."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator))
    return q * torch.sign(torch.diagonal(r))[None, :]


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
            if isinstance(module, _BATCH_NORMS):
                put(module.running_mean, torch.zeros(module.running_mean.shape))
                put(module.running_var, torch.ones(module.running_var.shape))
                put(module.num_batches_tracked, torch.zeros((), dtype=torch.long))
        elif isinstance(module, nn.Embedding):
            w = module.weight
            put(w, _normal(w.shape, 1.0 / math.sqrt(w.shape[1]), generator))
        elif isinstance(module, LSTMLayer):  # gates i, f, g, o stacked along the rows
            h, fan_in = module.hidden_size, module.weight_ih_l0.shape[1]
            put(module.weight_ih_l0, _normal(module.weight_ih_l0.shape, 1.0 / math.sqrt(fan_in), generator))
            put(module.weight_hh_l0, torch.cat([_orthogonal(h, generator) for _ in range(4)]))
            put(module.bias_ih_l0, torch.zeros(module.bias_ih_l0.shape))
            put(module.bias_hh_l0, torch.zeros(module.bias_hh_l0.shape))
        elif isinstance(module, RelPositionMultiHeadedAttention):
            for p in (module.pos_bias_u, module.pos_bias_v):
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                put(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(module, ScaledPositionalEncoding):
            put(module.alpha, torch.ones(module.alpha.shape))
        elif isinstance(module, ConvDecoderLayer):
            if not module.dynamic:  # a dynamic layer's weight_proj is a Linear
                w = module.conv_weight
                put(w, _normal(w.shape, 1.0 / math.sqrt(w.shape[0]), generator))
            if module.conv_bias is not None:
                put(module.conv_bias, torch.zeros(module.conv_bias.shape))
        elif isinstance(module, GlobalMVN):
            put(module.mean, torch.zeros(module.mean.shape))
            put(module.std, torch.ones(module.std.shape))
        elif isinstance(module, S4DLayer):
            for name, value in s4_initial_values(module, generator).items():
                put(getattr(module, name), value)
    left = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if id(t) not in done]
    if left:
        raise RuntimeError(f"init_params_: no initialiser for {left[:5]}")
    return model


# flax's variance scaling: (scale, fan mode, distribution)
_SCHEMES = {
    "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
    "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "kaiming_normal": (2.0, "fan_in", "truncated_normal"),
}
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def scheme_std(scheme: str, fan_in: int, fan_out: int) -> float:
    """The standard deviation ``scheme`` gives a kernel of these fans."""
    scale, mode, _ = _SCHEMES[scheme]
    fan = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2.0
    return math.sqrt(scale / fan)


def _kernels(model: nn.Module):
    """(weight, fan_in, fan_out) of every flax kernel: a Linear's (out, in)
    is flax's (in, out); a conv's (out, in / groups, *k) is flax's (*k,
    in / groups, out), its taps the receptive field; an LSTM's stacked (4H,
    in) holds four flax (in, H) kernels."""
    for m in model.modules():
        if isinstance(m, _KERNELS):
            w = m.weight
            rf = w[0, 0].numel()
            yield w, w.shape[1] * rf, w.shape[0] * rf
        elif isinstance(m, LSTMLayer):
            for w in (m.weight_ih_l0, m.weight_hh_l0):
                yield w, w.shape[1], m.hidden_size


@torch.no_grad()
def initialize(model: nn.Module, scheme: str, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s kernels by ``scheme`` from ``generator`` (CPU), zero
    its biases and set its norm scales to 1, in place; ValueError for an
    unknown scheme, as the JAX package raises."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown init: {scheme} (choices: {sorted(_SCHEMES)})")
    for w, fan_in, fan_out in _kernels(model):
        std = scheme_std(scheme, fan_in, fan_out)
        if _SCHEMES[scheme][2] == "uniform":
            bound = math.sqrt(3.0) * std
            value = (torch.rand(w.shape, generator=generator) * 2 - 1) * bound
        else:
            s = std / _TRUNC_STD
            value = nn.init.trunc_normal_(torch.empty(w.shape), 0.0, s, -2 * s, 2 * s, generator=generator)
        w.copy_(value)
    for m in model.modules():
        if isinstance(m, (*_KERNELS, *_NORMS)) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, _NORMS):
            m.weight.fill_(1.0)
        elif isinstance(m, LSTMLayer):
            m.bias_hh_l0.zero_()
    return model
