"""Corpus-level log-mel statistics for ``GlobalMVN`` (counterpart of
``scripts/compute_global_mvn_stats.py``).

    python -m tailored_avsr_tpu_torch.compute_global_mvn_stats --dataset SPLIT.csv \\
        --output stats.npz [--n-mels 80] [--device cuda|cpu]

Streams the ``wav_path`` column of a split CSV through the log-mel
frontend on the device (the card by default), sums each utterance's
valid frames in f64 on the host, and writes ``mean`` and ``std`` (f32
arrays of ``n_mels``; std = sqrt(max(E[x^2] - mean^2, 1e-20))) to an
``.npz``, the arrays of the JAX script. The CSV is read with ``csv``, as
the port's dataset reads it. The statistics go into a ``GlobalMVN``'s
``mean`` / ``std`` buffers by the caller (neither package loads them
into a model itself).
"""

from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

from tailored_avsr_tpu_torch.data.dataset import load_wav
from tailored_avsr_tpu_torch.ops.frontend_audio import LogMelFrontend
from tailored_avsr_tpu_torch.tasks.common import resolve_device


def corpus_stats(paths, n_mels: int, device) -> tuple:
    """(mean, std, frames) of the log-mel frames of the WAV files ``paths``."""
    fe = LogMelFrontend(n_mels=n_mels)
    n, s, ss = 0, 0.0, 0.0
    with torch.no_grad():
        for path in paths:
            wav = torch.from_numpy(load_wav(path)).to(device)
            feats, lens = fe(wav[None], torch.tensor([wav.shape[0]], device=device))
            f = feats[0, :int(lens[0])].cpu().numpy().astype(np.float64)
            n += f.shape[0]
            s = s + f.sum(axis=0)
            ss = ss + np.square(f).sum(axis=0)
    mean = s / n
    return mean, np.sqrt(np.maximum(ss / n - mean ** 2, 1e-20)), n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True, help=".npz with mean/std")
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "compute_global_mvn_stats")
    with open(args.dataset, newline="") as f:
        paths = [row["wav_path"] for row in csv.DictReader(f)]
    mean, std, n = corpus_stats(paths, args.n_mels, device)
    np.savez(args.output, mean=mean.astype(np.float32), std=std.astype(np.float32))
    print(f"wrote {args.output}: mean[:3]={mean[:3]}, std[:3]={std[:3]}, frames={n}")


if __name__ == "__main__":
    main()
