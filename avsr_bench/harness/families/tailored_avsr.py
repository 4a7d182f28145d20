"""The tailored audio-visual model (``task: avsr``, ``encoder: tailored``):
the visual frontend and the conv2d audio frontend, the tailored encoder
and the adaptive fusion, the CTC head and the Transformer decoder
(``reference/tailored_avsr.py``)."""

from __future__ import annotations

import os
from typing import Dict

import torch

from reference import tailored_avsr as ref

from .. import flops
from ..manifest import ROOT

ROWS = 4  # utterances a block of the reference


def build(cfg: Dict, vocab: int, device="meta") -> torch.nn.Module:
    with torch.device(device):
        return ref.TailoredAVSR(cfg, vocab).eval()


def encoder_frames(cfg: Dict, samples: int, frames: int) -> int:
    """Both streams are padded to the longer."""
    return max(flops.audio_frames(samples), frames)


def encoder_flops(cfg: Dict, b: int, t: int) -> float:
    """The encoder layers, the fusion and the CTC head over (b, t)."""
    enc = cfg["encoder_conf"]
    d, h, units = enc["output_size"], enc["attention_heads"], enc["linear_units"]
    cg, k = enc["cgmlp_linear_units"], enc["cgmlp_conv_kernel"]
    total = 2.0 * b * t * d * cfg["vocab"]  # CTC
    for aa, va in zip(enc["acoustic_use_attn"], enc["visual_use_attn"]):
        for attn in (aa, va):
            total += 2 * flops.ffn_flops(b, t, d, units)
            total += flops.attention_flops(b, t, d, h) if attn else flops.cgmlp_flops(b, t, d, cg, k)
    hidden = cfg["audiovisual_fusion_conf"]["hidden_units"]
    return total + 2 * flops.pooled_weight_flops(b, t, d) + flops.ffn_flops(b, t, d, hidden)


def encode_flops(cfg: Dict, b: int, samples: int, frames: int) -> float:
    """FLOPs of one encode of a (b, samples, frames) batch."""
    d = cfg["encoder_conf"]["output_size"]
    total = flops.audio_frontend_flops(b, samples, d) + encoder_flops(cfg, b, encoder_frames(cfg, samples, frames))
    total += flops.visual_frontend_flops(b, frames) + 2.0 * b * frames * 512 * d  # and the visual embed
    return total


def tiny(model: Dict) -> Dict:
    """``configs/tests/avsr_tiny.yaml`` with the configuration's tokens, type and decoding."""
    import yaml

    with open(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml"), encoding="utf-8") as f:
        out = yaml.safe_load(f)
    out.update(token_list=model["token_list"], dtype=model["dtype"], inference_conf=dict(model["inference_conf"]))
    return out
