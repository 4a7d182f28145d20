"""Weight-only quantisation for decoding (counterpart of
``tailored_avsr_tpu/utils/quantize.py``).

``quantize_model`` stores each weight that the JAX package's
``_should_quantize`` picks (a flax ``kernel`` or ``embedding`` leaf with
ndim >= 2, f32 or bf16, of at least ``min_size`` elements) in a
quantised form on the model's device, and every access of the weight
dequantises it (a ``torch.nn.utils.parametrize`` parametrization), so
each forward reads the quantised payload: ``qint8`` stores an int8
payload with one symmetric scale a flax output channel (the max of |w|
over every axis but the flax leaf's last, / 127, floored at 1e-12; the
scale in the weight's dtype), and dequantises as the JAX package does
(payload x scale in f32, cast to the scale's dtype); ``float16`` and
``bfloat16`` both store bf16, as in the JAX package, and a kernel then
computes in the model's dtype (the bf16 values upcast exactly, as flax
promotes), an embedding and an LSTM layer's kernels in bf16 (flax's
embedding keeps its table's dtype, and its LSTM cell promotes each
product on its own).

Which torch axis carries the scale follows the layout the key grammar
gives each leaf (``utils/torch_compat.torch_axis_of_flax_last``): axis 0
of a Linear or conv weight (the flax kernel's last axis is its output
features), axis 1 of an embedding. An LSTM's packed ``weight_ih_l0`` /
``weight_hh_l0`` hold one flax kernel a gate, each quantised on its own
(``min_size`` counts a gate's elements), so their rows take the scales.
The payloads and scales equal the JAX package's bit for bit after the
export's transpose.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn.utils import parametrize

from tailored_avsr_tpu_torch.ops.rnnt import LSTMLayer
from tailored_avsr_tpu_torch.utils.torch_compat import torch_axis_of_flax_last

_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)
_FLOATS = (torch.float32, torch.bfloat16)


def quantize_weight(w: torch.Tensor, axis: int, dtype: str = "qint8"):
    """-> (payload, scale): int8 and the per-``axis`` scale (kept
    dimensions) in w's dtype for ``qint8``; bf16 and a bf16 one for
    ``float16`` / ``bfloat16``."""
    if dtype == "qint8":
        wf = w.float()
        others = tuple(d for d in range(w.dim()) if d != axis)
        s = torch.clamp(wf.abs().amax(dim=others, keepdim=True) / 127.0, min=1e-12)
        return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), s.to(w.dtype)
    if dtype in ("float16", "bfloat16"):
        return w.to(torch.bfloat16), torch.ones((), dtype=torch.bfloat16, device=w.device)
    raise ValueError(f"unknown quantize_dtype: {dtype}")


class Dequantize(nn.Module):
    """The parametrization: (payload, scale) -> the weight in ``out_dtype``
    (an int8 payload: in the scale's dtype)."""

    def __init__(self, axis: int, dtype: str, out_dtype: torch.dtype):
        super().__init__()
        self.axis, self.dtype, self.out_dtype = axis, dtype, out_dtype

    def forward(self, payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        if payload.dtype == torch.int8:
            return (payload.float() * scale.float()).to(scale.dtype)
        return payload.to(self.out_dtype)

    def right_inverse(self, w: torch.Tensor):
        return quantize_weight(w, self.axis, self.dtype)


def _leaves(model: nn.Module):
    """(module, parameter name, flax leaf kind, gates) of every weight that
    comes from a flax kernel or embedding of ndim >= 2."""
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            yield m, "weight", "embedding", 1
        elif isinstance(m, _KERNEL_MODULES):
            yield m, "weight", "kernel", 1
        elif isinstance(m, LSTMLayer):
            yield m, "weight_ih_l0", "kernel", 4
            yield m, "weight_hh_l0", "kernel", 4


def quantize_model(model: nn.Module, dtype: str = "qint8", min_size: int = 4096) -> Dict[str, int]:
    """Quantise ``model``'s picked weights in place -> {parameter key: its
    elements}. Already quantised weights are left as they are."""
    if dtype not in ("qint8", "float16", "bfloat16"):
        raise ValueError(f"unknown quantize_dtype: {dtype}")
    names = {m: n for n, m in model.named_modules()}
    done = {}
    for m, name, kind, gates in _leaves(model):
        if parametrize.is_parametrized(m, name):
            continue
        w = getattr(m, name)
        if w.dim() < 2 or w.dtype not in _FLOATS or w.numel() // gates < min_size:
            continue
        # flax keeps a bf16 table's and an LSTM cell's kernels in bf16 and
        # promotes per product (``ops/rnnt.LSTMLayer.cell``); a Linear or conv
        # computes in the model's dtype
        out_dtype = torch.bfloat16 if kind == "embedding" or gates == 4 else w.dtype
        w.requires_grad_(False)
        parametrize.register_parametrization(
            m, name, Dequantize(torch_axis_of_flax_last(kind, w.dim()), dtype, out_dtype), unsafe=True)
        done[f"{names[m]}.{name}".lstrip(".")] = w.numel()
    return done


def quantized_payloads(model: nn.Module) -> Dict[str, tuple]:
    """{parameter key: (payload, scale)} of a quantised model."""
    names = {m: n for n, m in model.named_modules()}
    out = {}
    for m, name, _, _ in _leaves(model):
        if parametrize.is_parametrized(m, name):
            orig = m.parametrizations[name]
            out[f"{names[m]}.{name}".lstrip(".")] = (orig.original0, orig.original1)
    return out
