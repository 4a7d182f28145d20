#!/usr/bin/env python
"""Per-utterance adaptive-fusion weights of an AVSR model (the port of
``scripts/study_adaptive_fusion.py``; the paper's adaptive fusion).

    python -m tailored_avsr_tpu_torch.study_adaptive_fusion --config-file CFG \\
        --load-checkpoint MODEL.pth --dataset SPLIT.csv --output-dir DIR \\
        [--mask none|audio|video] [--yaml-overrides ...] [--device cuda|cpu]

Runs the eval forward of the encoder (``AVSRModel.encode``, whose aux holds
the fusion's learned ``acoustic_weight`` / ``visual_weight``) over the split
in batches of 4, with the audio or the video zeroed by ``--mask``, and
writes ``fusion_weights_{mask}.csv`` (``sample_id``, ``acoustic_weight``,
``visual_weight``), then prints the mean acoustic weight. The model is
built in the config's ``dtype`` on the card (``--device cpu`` for the
CPU), where its flash attention (K1 / K2) and cgMLP gate (K3) run.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Iterable, List

import numpy as np
import torch

from tailored_avsr_tpu_torch.data.dataloader import AVSRDataLoader
from tailored_avsr_tpu_torch.data.dataset import AVSRDataset
from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.data.transforms_video import CenterCrop, Compose, Normalise
from tailored_avsr_tpu_torch.tasks.common import build_model, resolve_device
from tailored_avsr_tpu_torch.train.checkpoint import load_model
from tailored_avsr_tpu_torch.utils.config import load_config

COLUMNS = ["sample_id", "acoustic_weight", "visual_weight"]


def masked(batch: Dict, mask: str) -> Dict:
    """The batch with its audio or video zeroed (``mask`` none|audio|video)."""
    if mask in ("audio", "video"):
        batch = dict(batch, **{mask: batch[mask] * 0.0})
    return batch


@torch.no_grad()
def fusion_weights(model, audio, audio_lengths, video, video_lengths) -> Dict[str, torch.Tensor]:
    """The fusion's per-utterance weights of one batch of model inputs on
    the device (the eval forward of the encoder) -> {acoustic_weight,
    visual_weight}, (B,) each."""
    model.eval()
    _, _, aux = model.encode(audio, audio_lengths, video, video_lengths)
    return aux["fusion_weights"]


def fusion_rows(model, batches: Iterable[Dict], mask: str, device: torch.device) -> List[Dict]:
    """One row a sample of the loader's ``batches`` (float streams, cast to
    the model's dtype), ``mask`` applied."""
    dtype = next(model.parameters()).dtype
    rows = []
    for batch in batches:
        batch = masked(batch, mask)
        args = [torch.as_tensor(np.asarray(batch[k]), device=device)
                for k in ("audio", "audio_lengths", "video", "video_lengths")]
        fw = fusion_weights(model, args[0].to(dtype), args[1], args[2].to(dtype), args[3])
        wa, wv = (fw[k].float().cpu().numpy() for k in ("acoustic_weight", "visual_weight"))
        rows += [{"sample_id": sid, "acoustic_weight": float(a), "visual_weight": float(v)}
                 for sid, a, v in zip(batch["sample_id"], wa, wv)]
    return rows


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True)
    p.add_argument("--load-checkpoint", default="")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mask", default="none", choices=["none", "audio", "video"])
    p.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*")
    p.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")
    args = p.parse_args(argv)

    config = load_config(args.config_file, args.yaml_overrides)
    device = resolve_device(args.device, "tailored_avsr_tpu_torch.study_adaptive_fusion")
    tokenizer, converter = get_tokenizer_converter(config)
    bf16 = str(getattr(config, "dtype", "float32")) in ("bfloat16", "bf16")
    model = build_model(config, converter.token_list, device=device,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    if args.load_checkpoint:
        load_model(model, args.load_checkpoint)
    loader = AVSRDataLoader(
        AVSRDataset(args.dataset, task="avsr", is_training=False), 4, task="avsr",
        video_transforms=Compose([Normalise(0.0, 250.0), Normalise(0.421, 0.165), CenterCrop((88, 88))]),
        tokenizer=tokenizer, converter=converter, is_training=False)
    rows = fusion_rows(model, loader, args.mask, device)

    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, f"fusion_weights_{args.mask}.csv")
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out}; mean acoustic weight = {np.mean([r['acoustic_weight'] for r in rows]):.3f}")
    return rows


if __name__ == "__main__":
    main()
