"""Seeded weights, made on the device in a few large calls and handed to
the program and the reference alike.

The template is the reference's state dict (names and shapes, on the meta
device). One normal draw from a device ``torch.Generator`` fills every
float tensor; each tensor then gets its scale and offset by one
element-wise pass:
- weights of two or more dims: N(0, 1) / sqrt(fan in), and a quarter of
  that for the projections that end an encoder layer's residual branches
  (feed-forward ``w_2``, attention ``linear_out``, cgMLP
  ``channel_proj2``, the Branchformer ``merge_proj``), so that the
  residual stream keeps its frames apart through 12 random layers (at
  full scale they wash each frame into the sequence's mean, and every
  frame reads one token); embeddings N(0, 1);
- LayerNorm and BatchNorm scales 1 + 0.1 N, biases 0.05 N, the rel-pos
  biases and the modality embedding 0.1 N;
- BatchNorm running means 0.1 N, running variances 1 + 0.2 |N|.
The draw is rounded once to the type the configuration serves in, so both
sides get the same values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EMBEDDINGS = ("embed.0.weight", "lm.embed.weight")
RESIDUAL_OUT = ("w_2.weight", "linear_out.weight", "channel_proj2.weight", "merge_proj.weight")
RESIDUAL_GAIN = 0.25
SMALL = ("pos_bias_u", "pos_bias_v", "modality_encoding.weight")


def _law(name: str, shape: Tuple[int, ...]) -> Tuple[float, float, bool]:
    """(scale, offset, absolute) of ``name``'s entries."""
    if name.endswith("running_var"):
        return 0.2, 1.0, True
    if name.endswith("running_mean") or name.endswith(SMALL):
        return 0.1, 0.0, False
    if name.endswith(EMBEDDINGS):
        return 1.0, 0.0, False
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        gain = RESIDUAL_GAIN if name.startswith("encoder.encoders.") and name.endswith(RESIDUAL_OUT) else 1.0
        return gain * fan_in ** -0.5, 0.0, False
    if name.endswith("bias"):
        return 0.05, 0.0, False
    return 0.1, 1.0, False  # a norm's scale


def seeded_state(template: Dict[str, torch.Tensor], seed: int, device, dtype: torch.dtype,
                 generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
    """``template``'s names and shapes filled from ``seed`` on ``device``,
    float entries in ``dtype``; integer entries (BatchNorm's counters) 0.
    ``generator`` continues a stream (the LM after its model)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    floats = [(k, v.shape) for k, v in template.items() if v.dtype.is_floating_point]
    sizes = [int(torch.Size(s).numel()) for _, s in floats]
    laws = [_law(k, tuple(s)) for k, s in floats]
    n = torch.randn(sum(sizes), generator=generator, device=device)
    reps = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor([l[0] for l in laws], device=device), reps)
    offset = torch.repeat_interleave(torch.tensor([l[1] for l in laws], device=device), reps)
    absolute = torch.repeat_interleave(torch.tensor([l[2] for l in laws], device=device), reps)
    flat = (torch.where(absolute, n.abs(), n) * scale + offset).to(dtype)
    out = dict(zip((k for k, _ in floats), (t.view(s) for t, (_, s) in zip(flat.split(sizes), floats))))
    for k, v in template.items():
        if not v.dtype.is_floating_point:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return {k: out[k] for k in template}


def template_of(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return dict(module.state_dict())
