"""Checkpoints: save/load, top-K averaging, per-module load and freeze, exact
resume, validation statistics (counterpart of
``tailored_avsr_tpu/train/checkpoint.py``).

A model checkpoint is a ``.pth``: the model's state dict (CPU tensors) in
the reference's PyTorch key grammar, the one
``utils/torch_compat.export_torch_state_dict`` writes. So the JAX package's
``load_model`` reads a port checkpoint (it translates ``.pth`` files), and
the port's ``Speech2Text`` serves one. A train state adds the optimizer's
moments and counters, the generator's state, the step and the epoch.
Under tensor parallelism both have the single-process layout: the model's
state dict gathers its shards (``parallel/tensor_parallel.py``), and so do
the moments here, so every rank takes part in a save and ``write`` says
which one writes the file.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from tailored_avsr_tpu_torch.utils.convert import filter_state_dict

MODULE_KEYS = {
    "frontend": ("frontend", "acoustic_frontend", "visual_frontend"),
    "encoder": ("encoder",),
    "decoder": ("decoder",),
    "ctc": ("ctc",),
    "fusion": ("audiovisual_fusion",),
    "embed": ("acoustic_embed", "visual_embed"),
}


def _makedirs_for(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _cpu_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_model(model: nn.Module, path: str, write: bool = True) -> None:
    state = _cpu_state(model)
    if write:
        _makedirs_for(path)
        torch.save(state, path)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A PyTorch state dict (``.pth`` / ``.pt``; a ``{"model": ...}``
    wrapper is unwrapped) on the CPU."""
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: only PyTorch state dicts load into the port; convert a JAX "
            "checkpoint with tailored_avsr_tpu_torch.utils.convert first"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return sd


def load_model(model: nn.Module, path: str) -> List[str]:
    """Strict load of a ``.pth`` into ``model``; keys the model has no module
    for (the decoder of a CTC-only model) are dropped and returned."""
    kept, dropped = filter_state_dict(model, read_state_dict(path))
    model.load_state_dict(kept, strict=True)
    return dropped


def average_models(paths: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Uniform mean of checkpoints' state dicts, taken in f64 and cast back
    to each tensor's dtype (top-K averaging)."""
    if not paths:
        raise ValueError("average_models needs at least one checkpoint")
    acc: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for p in paths:
        for k, v in read_state_dict(p).items():
            dtypes[k] = v.dtype
            acc[k] = acc[k] + v.double() if k in acc else v.double()
    return {k: (v / len(paths)).to(dtypes[k]) for k, v in acc.items()}


def _wanted(modules: Optional[Sequence[str]]) -> set:
    wanted = set()
    for m in modules or []:
        wanted.update(MODULE_KEYS.get(m, (m,)))
    return wanted


def load_e2e(model: nn.Module, ckpt_path: str, modules: Optional[Sequence[str]] = None) -> nn.Module:
    """Load a checkpoint fully, or only the named top-level modules
    (frontend / encoder / decoder / ctc / fusion / embed, or a module's own
    name); keys the checkpoint lacks keep their current values."""
    if not modules or list(modules) == ["entire-e2e"]:
        load_model(model, ckpt_path)
        return model
    wanted = _wanted(modules)
    loaded = read_state_dict(ckpt_path)
    state = model.state_dict()
    for k in state:
        if k.split(".")[0] in wanted and k in loaded:
            state[k] = loaded[k]
    model.load_state_dict(state, strict=True)
    return model


def freeze_mask(model: nn.Module, modules: Optional[Sequence[str]]) -> List[str]:
    """Names of the parameters that belong to a frozen module."""
    wanted = _wanted(modules)
    return [n for n, _ in model.named_parameters() if n.split(".")[0] in wanted]


def save_train_state(state, epoch: int, path: str, write: bool = True) -> None:
    """Everything an exact resume needs: step, epoch, model (parameters and
    BatchNorm statistics), optimizer moments and counters, generator."""
    opt = state.optimizer.state_dict()
    full = state.tp.full_named if state.tp is not None else (lambda d: d)
    to_cpu = lambda d: None if d is None else {k: v.to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "model": _cpu_state(state.model),
        "optimizer": {**opt, **{k: to_cpu(full(opt[k])) for k in ("mu", "nu", "acc")}},
        "generator": state.generator.get_state(),
    }
    if write:
        _makedirs_for(path)
        torch.save(payload, path)


def load_train_state(state, path: str):
    """Restore (state, epoch) from ``save_train_state``; ``state`` is a fresh
    one of the same model and optimizer settings, restored in place."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    opt = payload["optimizer"]
    if state.tp is not None:
        opt = {**opt, **{k: state.tp.split_named(opt[k]) for k in ("mu", "nu", "acc")}}
    state.optimizer.load_state_dict(opt)
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


def save_val_stats(path: str, rows: List[Dict[str, Any]]) -> None:
    _makedirs_for(path)
    if not rows:
        return
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def top_k_epochs(rows: List[Dict[str, Any]], k: int, key: str = "cer") -> List[int]:
    """Epoch numbers of the K best (lowest) validation scores."""
    return [int(r["epoch"]) for r in sorted(rows, key=lambda r: r[key])[:k]]


def prune_checkpoints(rows: List[Dict[str, Any]], keep: int, key: str = "cer") -> List[str]:
    """Delete the per-epoch checkpoints that are neither among the ``keep``
    best by validation score nor the newest epoch; returns the paths removed."""
    if keep <= 0 or len(rows) <= keep:
        return []
    latest = max(int(r["epoch"]) for r in rows)
    keep_epochs = set(top_k_epochs(rows, keep, key=key)) | {latest}
    removed = []
    for r in rows:
        p = r.get("path")
        if int(r["epoch"]) not in keep_epochs and p and os.path.exists(p):
            os.remove(p)
            removed.append(p)
    return removed
