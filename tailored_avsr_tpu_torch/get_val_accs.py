#!/usr/bin/env python
"""Decode the validation split with every epoch checkpoint of an experiment
and rank them by decoded error rate (the port of ``scripts/get_val_accs.py``).

    python -m tailored_avsr_tpu_torch.get_val_accs --config-file CFG \\
        --validation-dataset VAL.csv --exp-dir EXP --output-dir DIR \\
        [--checkpoints A.pth ...] [--mask none|audio|video] [--yaml-overrides ...] \\
        [--device cuda|cpu]

Each ``EXP/models/model_NNN.pth`` (``model_average.pth`` left out) and each
explicit checkpoint decodes the split through ``Speech2Text.stream`` with
the config's ``inference_conf``, in any family ``Speech2Text`` serves.
Writes ``DIR/inferences/val_NNN.inf`` (``ref#hyp``) and ``.wer``, and
``DIR/val_accs.csv`` (``model_check_path,epoch,wer,cer``), best first,
which ``average_model --val-accs`` averages.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
from typing import Dict, List

from tailored_avsr_tpu_torch.data.dataloader import AVSRDataLoader
from tailored_avsr_tpu_torch.data.dataset import AVSRDataset
from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.data.transforms_video import CenterCrop, Compose, Normalise
from tailored_avsr_tpu_torch.evaluation.wer import compute_bootstrap_wer, write_inf_file
from tailored_avsr_tpu_torch.inference import Speech2Text
from tailored_avsr_tpu_torch.tasks.common import resolve_device, task_of
from tailored_avsr_tpu_torch.utils.config import load_config


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True, help="model config yaml (the experiment's architecture)")
    p.add_argument("--validation-dataset", required=True)
    p.add_argument("--exp-dir", default="", help="experiment dir: decodes every models/model_*.pth")
    p.add_argument("--checkpoints", nargs="*", default=[], help="explicit checkpoint paths")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mask", default="none", choices=["none", "audio", "video"])
    p.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*")
    p.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")
    args = p.parse_args(argv)

    ckpts = list(args.checkpoints)
    if args.exp_dir:
        ckpts += sorted(glob.glob(os.path.join(args.exp_dir, "models", "model_*.pth")))
    ckpts = [c for c in ckpts if not c.endswith("model_average.pth")]
    if not ckpts:
        raise SystemExit("no checkpoints given (--exp-dir or --checkpoints)")

    config = load_config(args.config_file, args.yaml_overrides)
    device = resolve_device(args.device, "tailored_avsr_tpu_torch.get_val_accs")
    task = task_of(config)
    tokenizer, converter = get_tokenizer_converter(config)
    ds = AVSRDataset(args.validation_dataset, task=task, is_training=False)
    batch_size = int((getattr(config, "inference_conf", {}) or {}).get("batch_size", 1))
    video_tf = Compose([Normalise(0.0, 250.0), Normalise(0.421, 0.165), CenterCrop((88, 88))])

    inf_dir = os.path.join(args.output_dir, "inferences")
    os.makedirs(inf_dir, exist_ok=True)
    rows = []
    for ckpt in ckpts:
        m = re.search(r"model_(\d+)\.pth$", os.path.basename(ckpt))
        epoch = int(m.group(1)) if m else -1
        s2t = Speech2Text(config, ckpt_path=ckpt, device=device)
        loader = AVSRDataLoader(ds, batch_size, task=task, video_transforms=video_tf, tokenizer=tokenizer,
                                converter=converter, is_training=False)

        def batches():
            for batch in loader:
                if task == "avsr" and args.mask in ("audio", "video"):
                    batch[args.mask] = batch[args.mask] * 0.0
                yield batch

        pairs = []
        for batch, results in s2t.stream(batches()):
            pairs += [(ref, hyp[0]) for ref, hyp in zip(batch["refs"], results)]
        inf_path = os.path.join(inf_dir, f"val_{epoch:03d}.inf")
        write_inf_file(inf_path, pairs)
        wer, cer, ci_w, ci_c = compute_bootstrap_wer(inf_path)
        with open(inf_path[:-len(".inf")] + ".wer", "w") as f:
            f.write(f"WER: {wer:.2f} +- {ci_w:.2f}\nCER: {cer:.2f} +- {ci_c:.2f}\n")
        print(f"epoch {epoch}: WER {wer:.2f} CER {cer:.2f} ({ckpt})")
        rows.append({"model_check_path": ckpt, "epoch": epoch, "wer": round(wer, 4), "cer": round(cer, 4)})

    rows.sort(key=lambda r: (r["wer"], r["cer"]))
    out_csv = os.path.join(args.output_dir, "val_accs.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["model_check_path", "epoch", "wer", "cer"])
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_csv} ({len(rows)} checkpoints, best first)")
    return rows


if __name__ == "__main__":
    main()
