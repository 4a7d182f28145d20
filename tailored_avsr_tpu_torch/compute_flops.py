#!/usr/bin/env python
"""Parameter count and encode FLOPs of a configured model (the port of
``scripts/compute_flops.py``).

    python -m tailored_avsr_tpu_torch.compute_flops --config-file CFG \\
        [--seconds 4.0] [--batch-size 1] [--yaml-overrides ...] [--device cuda|cpu]

Prints ``parameters: N M`` (the trained parameters; the JAX script counts
the same ``params`` leaves) and the FLOPs of one ``encode`` of a batch of
``--batch-size`` utterances of ``--seconds`` seconds (25 video frames and
16,000 audio samples a second), counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain path: the
flash attention and cgMLP-gate kernels are switched off for the count,
because ctypes-bound kernels are invisible to the counter. The two
packages' numbers differ by design: the counter counts matmuls and
convolutions only, every kernel tap at every output position, whereas
XLA's cost analysis (the JAX script's number) also counts the elementwise
work and counts only the taps of a padded convolution that fall inside its
input (the visual frontend's small feature maps make that the larger
term: on the tiny test model the port reads about 1.17x XLA's number).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.tasks.common import build_model, resolve_device, set_kernels, task_of
from tailored_avsr_tpu_torch.utils.config import load_config


def encode_inputs(task: str, seconds: float, batch: int, device) -> tuple:
    """The encoder's inputs of the JAX script (numpy ``RandomState(0)``)."""
    frames = int(seconds * 25)
    samples = frames * 640
    rng = np.random.RandomState(0)
    rng.randint(3, 20, (batch, 10))  # the JAX script's text draw, unused by encode
    audio = (torch.from_numpy(rng.randn(batch, samples).astype(np.float32)), torch.full((batch,), samples))
    video = (torch.from_numpy(rng.randn(batch, frames, 88, 88).astype(np.float32)), torch.full((batch,), frames))
    args = {"avsr": audio + video, "vsr": video, "asr": audio}[task]
    return tuple(a.to(device) for a in args)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True)
    p.add_argument("--seconds", type=float, default=4.0, help="utterance length")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*")
    p.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")
    args = p.parse_args(argv)

    config = load_config(args.config_file, args.yaml_overrides)
    device = resolve_device(args.device, "tailored_avsr_tpu_torch.compute_flops")
    _, converter = get_tokenizer_converter(config)
    model = set_kernels(build_model(config, converter.token_list, device=device, dtype=torch.float32), False).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"parameters: {n_params / 1e6:.2f}M")
    inputs = encode_inputs(task_of(config), args.seconds, args.batch_size, device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.encode(*inputs)
    flops = counter.get_total_flops()
    print(f"encode FLOPs ({args.seconds:.1f}s x batch {args.batch_size}): {flops / 1e9:.2f} G")
    return {"parameters": n_params, "flops": flops}


if __name__ == "__main__":
    main()
