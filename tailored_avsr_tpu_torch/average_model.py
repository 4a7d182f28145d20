#!/usr/bin/env python
"""Offline checkpoint averaging, the uniform mean of ``.pth`` state dicts
(the port of ``scripts/average_model.py``).

    python -m tailored_avsr_tpu_torch.average_model --output AVG.pth \\
        [--checkpoints A.pth B.pth ...] \\
        [--exp-dir EXP --top-k K --metric cer]   # top-K of EXP/val_stats.csv, lowest first
        [--val-accs val_accs.csv --top-k K]       # get_val_accs' ranking: by (wer, cer)

The sources add up: explicit paths, then the ``--val-accs`` rows, then the
``--exp-dir`` epochs (``EXP/models/model_NNN.pth``). The mean is taken in
f64 and cast back to each tensor's dtype (``train/checkpoint.average_models``).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List

import torch

from tailored_avsr_tpu_torch.train.checkpoint import average_models, top_k_epochs


def _rows(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def main(argv=None) -> List[str]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoints", nargs="*", default=[])
    p.add_argument("--exp-dir", default="", help="experiment dir with val_stats.csv")
    p.add_argument("--val-accs", default="", help="val_accs.csv of get_val_accs: sorted by (wer, cer)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--metric", default="cer")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    paths = list(args.checkpoints)
    if args.val_accs:
        rows = sorted(_rows(args.val_accs), key=lambda r: (float(r["wer"]), float(r["cer"])))
        paths += [r["model_check_path"] for r in rows[:args.top_k]]
    if args.exp_dir:
        stats = [{"epoch": int(r["epoch"]), "cer": float(r[args.metric])}
                 for r in _rows(os.path.join(args.exp_dir, "val_stats.csv"))]
        paths += [os.path.join(args.exp_dir, "models", f"model_{e:03d}.pth") for e in top_k_epochs(stats, args.top_k)]
    if not paths:
        raise SystemExit("no checkpoints given (--checkpoints, --exp-dir or --val-accs)")
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    torch.save(average_models(paths), args.output)
    print(f"averaged {len(paths)} checkpoints -> {args.output}")
    return paths


if __name__ == "__main__":
    main()
