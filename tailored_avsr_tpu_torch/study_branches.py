#!/usr/bin/env python
"""Per-layer learned branch-merge weights of a Branchformer ASR / VSR model:
the tailoring signal (counterpart of ``scripts/study_branches.py``).

    python -m tailored_avsr_tpu_torch.study_branches --config-file CONFIG \\
        --load-checkpoint MODEL.pth --dataset SPLIT.csv --output-dir DIR

Runs up to ``--max-batches`` batches of 4 through the model (eval mode),
collects each ``learned_ave`` layer's attention-branch weight per utterance
(``weight_global`` of the encoder's ``branch_weights``) and writes
``DIR/branch_scores.csv`` with the columns ``layer``, ``mean_attn_weight``,
``std_attn_weight`` and ``use_attn`` (mean > 0.5), plus
``branch_scores.png`` when matplotlib imports. The ``use_attn`` list it
prints is what a tailored model's ``acoustic_use_attn`` (from an ASR model)
or ``visual_use_attn`` (from a VSR model) takes. Without a checkpoint the
weights are the seeded initialisation. An encoder with no ``learned_ave``
layer exits with the JAX script's message. The model runs on the CUDA card
unless ``--device cpu`` is given.
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
from tailored_avsr_tpu_torch.data.transforms_audio import Compose
from tailored_avsr_tpu_torch.data.transforms_video import CenterCrop, Normalise
from tailored_avsr_tpu_torch.tasks.asr import build_model
from tailored_avsr_tpu_torch.tasks.common import resolve_device, task_of
from tailored_avsr_tpu_torch.train.checkpoint import load_model
from tailored_avsr_tpu_torch.utils.config import load_config

NO_SCORES = ("no learned_ave branch weights found — the encoder's merge_method must be 'learned_ave' "
             "(concat/fixed_ave and conformer layers expose no branch scores)")


@torch.no_grad()
def branch_scores(model: torch.nn.Module, batches: Iterable[Dict], device: torch.device) -> List[Dict]:
    """One row a ``learned_ave`` layer over every utterance of ``batches``
    (``speech`` / ``text`` batch dicts): ``layer`` (from 1),
    ``mean_attn_weight``, ``std_attn_weight``, ``use_attn``."""
    model.eval()
    weights: Dict[int, list] = {}
    for batch in batches:
        args = [torch.as_tensor(np.asarray(batch[k])).to(device)
                for k in ("speech", "speech_lengths", "text", "text_lengths")]
        args[0] = args[0].to(next(model.parameters()).dtype)
        _, stats = model(*args)
        for layer, aux in stats.get("branch_weights", []):
            weights.setdefault(int(layer), []).append(aux["weight_global"].float().cpu().numpy())
    rows = []
    for layer in sorted(weights):
        w = np.concatenate(weights[layer])
        rows.append({"layer": layer, "mean_attn_weight": float(w.mean()), "std_attn_weight": float(w.std()),
                     "use_attn": bool(w.mean() > 0.5)})
    return rows


def write_scores(rows: List[Dict], output_dir: str) -> str:
    """``branch_scores.csv`` (and the heatmap when matplotlib imports);
    exits with the JAX script's message when there is no row."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "branch_scores.csv")
    with open(path, "w", newline="") as f:
        if not rows:
            raise SystemExit(NO_SCORES)
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {path}")
    print("use_attn mask:", [r["use_attn"] for r in rows])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"(no heatmap: {e})")
        return path
    fig, ax = plt.subplots(figsize=(8, 3))
    data = np.asarray([[r["mean_attn_weight"] for r in rows], [1 - r["mean_attn_weight"] for r in rows]])
    im = ax.imshow(data, aspect="auto", vmin=0, vmax=1, cmap="viridis")
    ax.set_yticks([0, 1], ["attention", "cgMLP"])
    ax.set_xticks(range(len(rows)), [str(r["layer"]) for r in rows])
    ax.set_xlabel("encoder layer")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "branch_scores.png"), dpi=120)
    plt.close(fig)
    print("wrote branch_scores.png")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Per-layer learned branch weights of a Branchformer ASR / VSR model.")
    p.add_argument("--config-file", required=True)
    p.add_argument("--load-checkpoint", default="")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--max-batches", type=int, default=50)
    p.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*",
                   help="as the training CLI's: the config the checkpoint was trained with")
    p.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")
    args = p.parse_args(argv)

    config = load_config(args.config_file, args.yaml_overrides)
    task = task_of(config)
    if task == "avsr":
        raise ValueError("study_branches reads an ASR or VSR model (task: asr | vsr)")
    device = resolve_device(args.device, "tailored_avsr_tpu_torch.study_branches")
    tokenizer, converter = get_tokenizer_converter(config)
    model = build_model(config, converter.token_list, device=device)
    if args.load_checkpoint:
        load_model(model, args.load_checkpoint)
    video_tf = (Compose([Normalise(0.0, 250.0), Normalise(0.421, 0.165), CenterCrop((88, 88))])
                if task == "vsr" else None)
    loader = AVSRDataLoader(AVSRDataset(args.dataset, task=task, is_training=False), 4, task=task,
                            video_transforms=video_tf, tokenizer=tokenizer, converter=converter,
                            is_training=False)
    batches = (b for _, b in zip(range(args.max_batches), loader))
    return write_scores(branch_scores(model, batches, device), args.output_dir)


if __name__ == "__main__":
    main()
