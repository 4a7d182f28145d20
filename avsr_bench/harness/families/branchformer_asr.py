"""The audio-only Branchformer (``task: asr``, ``encoder: branchformer``):
the conv2d audio frontend, the Branchformer encoder, the CTC head and the
Transformer decoder (``reference/branchformer_asr.py``)."""

from __future__ import annotations

import copy
from typing import Dict

import torch

from reference import branchformer_asr as ref

from .. import flops

ROWS = 16  # utterances a block of the reference
TINY_ENCODER = {"output_size": 32, "linear_units": 48, "cgmlp_linear_units": 48, "cgmlp_conv_kernel": 7,
                "num_blocks": 2}


def build(cfg: Dict, vocab: int, device="meta") -> torch.nn.Module:
    with torch.device(device):
        return ref.BranchformerASR(cfg, vocab).eval()


def encoder_frames(cfg: Dict, samples: int, frames: int) -> int:
    return flops.audio_frames(samples)


def encoder_flops(cfg: Dict, b: int, t: int) -> float:
    """The encoder layers and the CTC head over (b, t)."""
    enc = cfg["encoder_conf"]
    d, h, units = enc["output_size"], enc["attention_heads"], enc["linear_units"]
    cg, k = enc["cgmlp_linear_units"], enc["cgmlp_conv_kernel"]
    total = 2.0 * b * t * d * cfg["vocab"]  # CTC
    for _ in range(enc["num_blocks"]):
        total += (2 * flops.ffn_flops(b, t, d, units) + flops.attention_flops(b, t, d, h)
                  + flops.cgmlp_flops(b, t, d, cg, k))
        total += 2 * flops.pooled_weight_flops(b, t, d) + 2.0 * b * t * d * d  # the merge
    return total


def encode_flops(cfg: Dict, b: int, samples: int, frames: int) -> float:
    """FLOPs of one encode of a (b, samples) batch."""
    d = cfg["encoder_conf"]["output_size"]
    return flops.audio_frontend_flops(b, samples, d) + encoder_flops(cfg, b, encoder_frames(cfg, samples, frames))


def tiny(model: Dict) -> Dict:
    model = copy.deepcopy(model)
    model["encoder_conf"].update(TINY_ENCODER)
    model["decoder_conf"].update(linear_units=48, num_blocks=1)
    return model
