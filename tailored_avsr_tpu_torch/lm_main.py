#!/usr/bin/env python
"""Transformer-LM trainer of the port (counterpart of the root ``lm_main.py``):
the same arguments, dataset modes, batches, loss, Noam optimizer,
validation perplexity and top-K averaging, plus ``--device`` (``cuda`` by
default; it raises on a host without one, ``--device cpu`` runs on the
CPU). Training is f32, as in the JAX trainer.

    python -m tailored_avsr_tpu_torch.lm_main --config-file configs/LM/lm-spanish.yaml \\
        --training-dataset TRAIN.csv|TRAIN.txt --validation-dataset VAL.csv|VAL.txt \\
        --output-dir EXP

Per epoch: one optimizer step a batch of ``batch_size`` sentences (the
loss is the summed NLL over the summed token count, sos/eos included),
the validation perplexity ``exp(sum nll / sum count)``, and a checkpoint
``models/model_NNN.pth`` in the reference key grammar (``lm.``-prefixed,
as ``Speech2Text(lm_ckpt_path=...)`` and the JAX ``load_model`` read it).
At the end ``val_stats.csv`` (``epoch,ppl``) and
``models/model_average.pth``, the mean of the ``average_epochs`` epochs
of lowest perplexity.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import time
from typing import Callable, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from tailored_avsr_tpu_torch.data.dataloader import pad_batch, round_up
from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.tasks import lm as lm_task
from tailored_avsr_tpu_torch.tasks.common import resolve_device
from tailored_avsr_tpu_torch.train.checkpoint import average_models, save_val_stats, top_k_epochs
from tailored_avsr_tpu_torch.train.optim import Optimizer, set_optimizer
from tailored_avsr_tpu_torch.utils.config import load_config
from tailored_avsr_tpu_torch.utils.convert import LM_PREFIX


class LMTextDataset:
    """The LM's sentences as token ids, from either of the two sources the
    JAX trainer reads:

    - a path containing ``.csv`` is a dataset split: each row's
      ``transcription_path`` file holds the sentence on its first line;
    - any other path is a text file of one sentence a line.

    A sentence is stripped, uppercased and stripped of ``{`` / ``}``;
    empty ones are left out."""

    def __init__(self, path: str, tokenizer, converter):
        if ".csv" in path:
            lines = []
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    with open(row["transcription_path"], "r", encoding="utf-8") as t:
                        lines.append(t.readlines()[0].strip())
        else:
            with open(path, "r", encoding="utf-8") as f:
                lines = [line.strip() for line in f]
        lines = [line.upper().replace("{", "").replace("}", "") for line in lines]
        self.ids = [np.asarray(converter.tokens2ids(tokenizer.text2tokens(line)), np.int32)
                    for line in lines if line]

    def __len__(self) -> int:
        return len(self.ids)


def lm_batches(ds: LMTextDataset, batch_size: int, shuffle: bool, rng: np.random.RandomState,
               bucket: int = 8) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(tokens (B, L) int32 padded with -1 to a multiple of ``bucket``,
    lengths (B,) int32) on the CPU; ``shuffle`` permutes the sentences with
    ``rng`` first (the JAX trainer's batches, draw for draw)."""
    idx = np.arange(len(ds))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx), batch_size):
        chunk = [ds.ids[j] for j in idx[i:i + batch_size]]
        lmax = round_up(max(len(c) for c in chunk), bucket)
        toks = pad_batch(chunk, -1, lmax)
        lens = np.asarray([len(c) for c in chunk], np.int32)
        yield torch.from_numpy(toks), torch.from_numpy(lens)


def make_lm_train_step(lm: nn.Module, optimizer: Optimizer, generator: torch.Generator) -> Callable:
    """``step(tokens, lengths) -> loss`` (0-dim, on the device): the LM in
    training mode, ``sum(nll) / max(sum(count), 1)``, backward, one
    ``optimizer.step()``. Dropout draws from torch's generators reseeded
    each step from ``generator`` (CPU), so a seed gives the same run."""
    device = next(lm.parameters()).device

    def step(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        lm.train()
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            nll, counts = lm.nll(tokens, lengths)
            loss = nll.sum() / counts.sum().clamp(min=1)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def lm_eval_sums(lm: nn.Module, tokens: torch.Tensor, lengths: torch.Tensor) -> Tuple[float, int]:
    """(sum nll, sum count) of one batch, the LM in eval mode."""
    lm.eval()
    nll, counts = lm.nll(tokens, lengths)
    return float(nll.sum()), int(counts.sum())


def save_lm(lm: nn.Module, path: str) -> None:
    """The LM's state dict in the reference key grammar (``lm.`` prefix)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({LM_PREFIX + k: v.detach().to("cpu", copy=True) for k, v in lm.state_dict().items()}, path)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transformer LM trainer: the PyTorch/CUDA port.")
    p.add_argument("--training-dataset", default="", type=str)
    p.add_argument("--validation-dataset", default="", type=str)
    p.add_argument("--config-file", required=True, type=str)
    p.add_argument("--output-dir", required=True, type=str)
    p.add_argument("--mode", default="training", type=str)
    p.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*")
    p.add_argument("--device", default="cuda", type=str, help="'cuda' (the card; raises without one) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """Trains, validates and averages; returns {"losses": mean train loss
    an epoch, "ppl": validation perplexity an epoch, "average": path}."""
    args = get_parser().parse_args(argv)
    config = load_config(args.config_file, args.yaml_overrides)
    device = resolve_device(args.device, "tailored_avsr_tpu_torch.lm_main")
    tokenizer, converter = get_tokenizer_converter(config)
    ts = config.training_settings
    seed = int(ts.get("seed", 0))
    lm = lm_task.build_model(config, converter.token_list, generator=torch.Generator().manual_seed(seed),
                             device=device, dtype=torch.float32)

    train_ds = LMTextDataset(args.training_dataset, tokenizer, converter)
    val_ds = LMTextDataset(args.validation_dataset or args.training_dataset, tokenizer, converter)
    nprng = np.random.RandomState(0)
    steps = (len(train_ds) + ts["batch_size"] - 1) // ts["batch_size"]
    optimizer, _ = set_optimizer(ts, model_size=lm.att_unit, steps_per_epoch=steps,
                                 named_params=lm.named_parameters())
    train_step = make_lm_train_step(lm, optimizer, torch.Generator().manual_seed(seed))

    models_dir = os.path.join(args.output_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    val_stats, losses, ppls = [], [], []
    for epoch in range(1, ts["epochs"] + 1):
        t0, tot, n = time.time(), 0.0, 0
        for toks, lens in lm_batches(train_ds, ts["batch_size"], True, nprng):
            tot += float(train_step(toks.to(device), lens.to(device)))
            n += 1
        nll_sum, count = 0.0, 0
        for toks, lens in lm_batches(val_ds, ts["batch_size"], False, nprng):
            s, c = lm_eval_sums(lm, toks.to(device), lens.to(device))
            nll_sum += s
            count += c
        ppl = math.exp(nll_sum / max(count, 1))
        losses.append(tot / max(n, 1))
        ppls.append(ppl)
        print(f"Epoch {epoch}: TRAIN LOSS={losses[-1]:.3f} | VAL PPL={ppl:.2f} | {time.time() - t0:.1f}s")
        ckpt = os.path.join(models_dir, f"model_{epoch:03d}.pth")
        save_lm(lm, ckpt)
        val_stats.append({"epoch": epoch, "ppl": ppl, "path": ckpt})

    save_val_stats(os.path.join(args.output_dir, "val_stats.csv"),
                   [{"epoch": r["epoch"], "ppl": r["ppl"]} for r in val_stats])
    best = top_k_epochs(val_stats, ts.get("average_epochs", 1), key="ppl")
    paths = [os.path.join(models_dir, f"model_{e:03d}.pth") for e in best]
    average = os.path.join(models_dir, "model_average.pth")
    torch.save(average_models(paths), average)
    print(f"averaged top-{len(paths)} checkpoints -> model_average.pth")
    return {"losses": losses, "ppl": ppls, "average": average}


if __name__ == "__main__":
    main()
