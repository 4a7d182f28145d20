"""The ranks of ``tests/test_torch_port_parallel.py``: each is a process of a
gloo group on the CPU (``torch.multiprocessing`` spawn, a ``file://``
store), and runs every scenario of the port once. Imports no JAX: the JAX
sides run in the test process, and the weights and batches come from it in
``payload.pt``. Rank 0 writes the results to ``results.pt``."""

from __future__ import annotations

import hashlib
import os
import random
import shutil

import numpy as np
import torch
import torch.distributed as dist

from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.parallel import host_data
from tailored_avsr_tpu_torch.parallel.mesh import all_gather_objects, make_grid
from tailored_avsr_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
from tailored_avsr_tpu_torch.tasks.common import build_model
from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
from tailored_avsr_tpu_torch.train.optim import set_optimizer

TRAIN_SETTINGS = {"optimizer": "adam", "scheduler": "noam", "warmup_steps": 10, "grad_clip": 1.0,
                  "accum_grad": 1, "epochs": 1}


def _digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_micro_step(cfg, tokens, weights, batch, grid, specaug: bool = False) -> dict:
    """One micro-step of the model on ``weights`` over ``grid`` (None: one
    process): the gradient the optimizer consumed (the single-process
    names and shapes), the BatchNorm statistics after it, the stats, and
    whether every replica holds the same parameters afterwards."""
    cfg = type(cfg)(**vars(cfg))
    if not specaug:
        cfg.specaug = None
    model = build_model(cfg, tokens, device="cpu")
    model.load_state_dict(weights, strict=True)
    tp = None
    if grid is not None and grid.model > 1:
        tp = apply_tensor_parallel(model, grid.model, grid.model_rank, grid.model_group)
    optimizer, _ = set_optimizer(TRAIN_SETTINGS, 64, 10, model.named_parameters())
    if tp is not None:
        optimizer.set_tensor_parallel(tp.is_split, grid.model_group)
    state = create_train_state(model, optimizer, seed=5, tp=tp)
    grads = {}
    real = optimizer.step

    def capture():
        for name, p in zip(optimizer.trainable, optimizer.params):
            grads[name] = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        return real()

    optimizer.step = capture
    state, stats = make_train_step(grid=grid)(state, tuple(torch.as_tensor(a) for a in batch))
    if tp is not None:
        grads = tp.full_named(grads)
    sd = model.state_dict()
    digests = all_gather_objects(_digest(model)) if grid is not None else [None]
    return {"grads": {k: v.numpy() for k, v in grads.items()},
            "batch_stats": {k: v.numpy() for k, v in sd.items() if "running_" in k},
            "stats": {k: float(v) for k, v in stats.items()},
            "replicas_equal": len(set(digests)) == 1}


def specaug_rows(grid) -> bool:
    """The rows ``rand_rows`` gives each rank are the global draw's rows."""
    b, rows = 5, host_data.process_batch_slice(5, grid.data_rank, grid.data)
    want = torch.rand((b, 7), generator=torch.Generator().manual_seed(11))[rows]
    shard = host_data.DataShard(grid.data_group, rows.start, rows.stop - rows.start, b)
    gen = torch.Generator().manual_seed(11)
    with host_data.data_shard(shard):
        got = host_data.rand_rows(rows.stop - rows.start, 7, generator=gen)
    after = torch.rand(3, generator=gen)  # the generator moved past the whole draw
    ref = torch.Generator().manual_seed(11)
    torch.rand((b, 7), generator=ref)
    return bool(torch.equal(got, want) and torch.equal(after, torch.rand(3, generator=ref)))


class _DropoutProbe(torch.nn.Module):
    """A dropout on replicated activations, then a feed-forward whose hidden
    units tensor parallelism splits (identity activation: a zero is a
    dropped unit); records each dropout's mask."""

    def __init__(self):
        super().__init__()
        self.drop = torch.nn.Dropout(0.5)
        self.ffn = PositionwiseFeedForward(8, 16, dropout_rate=0.5, activation="identity")
        self.masks = {}

    def forward(self, x, generator=None):
        y = self.drop(x)
        self.masks["replicated"] = (y == 0).numpy()
        return self.ffn(y).sum(), {}


def dropout_masks(grid) -> list:
    """Each rank's dropout masks in one train step of ``_DropoutProbe`` over
    ``grid`` (rate 0.5, a global batch of 4): its rows' mask, and its part
    of the feed-forward's hidden units' mask."""
    torch.manual_seed(0)
    model = _DropoutProbe()
    tp = None
    if grid.model > 1:
        tp = apply_tensor_parallel(model, grid.model, grid.model_rank, grid.model_group)
    model.ffn.dropout.register_forward_hook(lambda m, i, o: model.masks.__setitem__("hidden", (o == 0).numpy()))
    optimizer, _ = set_optimizer(TRAIN_SETTINGS, 8, 10, model.named_parameters())
    if tp is not None:
        optimizer.set_tensor_parallel(tp.is_split, grid.model_group)
    make_train_step(grid=grid)(create_train_state(model, optimizer, seed=5, tp=tp), (torch.ones(4, 3, 8),))
    return all_gather_objects(model.masks)


def serve(cfg, weights, requests) -> dict:
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = type(cfg)(**vars(cfg))
    cfg.inference_conf = dict(cfg.inference_conf, data_parallel=True)
    s2t = Speech2Text(cfg, device="cpu")
    s2t.model.load_state_dict(weights, strict=True)
    return {name: {"greedy": s2t.greedy(batch), "nbest": s2t.nbest(batch)} for name, batch in requests.items()}


def cli(args) -> None:
    from tailored_avsr_tpu_torch import avsr_main

    real = avsr_main.build_transforms

    def deterministic(a):  # the eval transforms: every rank and run sees the same batches
        t = real(a)
        return dict(t, train_audio=t["eval_audio"], train_video=t["eval_video"])

    avsr_main.build_transforms = deterministic
    try:
        np.random.seed(0)
        random.seed(0)
        avsr_main.main(args)
    finally:
        avsr_main.build_transforms = real


def rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world)
    try:
        p = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        grid = make_grid("cpu")
        out = {"grid": grid.shape()}
        for name, batch in p["train_batches"].items():
            out[f"dp_{name}"] = train_micro_step(p["train_cfg"], p["tokens"], p["train_weights"], batch, grid)
        out["dp_specaug"] = train_micro_step(p["train_cfg"], p["tokens"], p["train_weights"],
                                             p["train_batches"]["even"], grid, specaug=True)
        out["specaug_rows"] = all(all_gather_objects(specaug_rows(grid)))
        tp_grid = make_grid("cpu", model_parallel=2)
        out["tp_grid"] = tp_grid.shape()
        out["tp"] = train_micro_step(p["train_cfg"], p["tokens"], p["train_weights"],
                                     p["train_batches"]["even"], tp_grid)
        out["serve"] = serve(p["serve_cfg"], p["serve_weights"], p["requests"])
        out["dropout_dp"] = dropout_masks(grid)
        out["dropout_tp"] = dropout_masks(tp_grid)
        cli(p["cli_args"])
        if rank == 0:  # the two ranks' training state, resumed here under model_parallel 2 and by the test process
            for run in ("tp_resume", "one_resume"):
                shutil.copytree(os.path.join(tmp, "two_ranks", "models"), os.path.join(tmp, run, "models"))
            open(os.path.join(tmp, "resume_ready"), "w").close()
        dist.barrier()
        cli(p["tp_resume_args"])
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt"))
    finally:
        dist.destroy_process_group()
