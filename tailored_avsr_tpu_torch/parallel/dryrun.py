"""The multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` spawns ``n`` ranks joined in one process group:
NCCL, one card a rank (it raises when fewer than ``n`` cards are present),
or gloo on the CPU when ``device`` is ``cpu``; on a ``(data, model)`` grid
with ``model_parallel`` 2 when ``n`` is even and at least 4, as the JAX
dry run shapes its mesh. On the tiny
flagship each rank runs one data- and tensor-parallel train step, then
one greedy and one beam decode (``Speech2Text`` with ``data_parallel``)
with the stepped weights. Rank 0 then builds the full flagship on the
meta device, splits it as every rank of the model group would, and checks
each shard's shape against ``tp_param_spec``: the counterpart of the JAX
dry run's ``eval_shape`` pass over the full model.

    python -m tailored_avsr_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import math
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP = ROOT / "configs" / "AVSR" / "tailored_transformer+ctc_spanish.yaml"
TOKENS = ROOT / "tokenizers" / "char" / "spanish.txt"


def flagship_config(tiny: bool = False):
    """The flagship config, or its tiny cut (``__graft_entry__._flagship_cfg``'s)."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(str(FLAGSHIP))
    cfg.token_list = str(TOKENS)
    if tiny:
        cfg.encoder_conf = dict(cfg.encoder_conf, output_size=64, linear_units=96, cgmlp_linear_units=96,
                                cgmlp_conv_kernel=7, num_blocks=2, acoustic_use_attn=[False, True],
                                visual_use_attn=[True, True])
        cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, output_size=64, hidden_units=96)
        cfg.decoder_conf = dict(cfg.decoder_conf, linear_units=96, num_blocks=2)
    return cfg


def example_batch(frames: int, batch: int) -> tuple:
    """``__graft_entry__._example_batch``'s seeded batch, as torch tensors."""
    rng = np.random.RandomState(0)
    samples = frames * 640
    audio = rng.randn(batch, samples).astype(np.float32) * 0.1
    alens = [samples if i % 2 == 0 else samples // 2 for i in range(batch)]
    video = rng.randn(batch, frames, 88, 88).astype(np.float32)
    vlens = [frames if i % 2 == 0 else frames // 2 for i in range(batch)]
    text = rng.randint(3, 30, size=(batch, 8))
    return (torch.from_numpy(audio), torch.tensor(alens), torch.from_numpy(video), torch.tensor(vlens),
            torch.from_numpy(text), torch.full((batch,), 8))


def check_full_shards(model_parallel: int) -> int:
    """Split the full flagship (meta device) as each rank of a model group of
    ``model_parallel`` would; every split leaf's shard must have the shape
    ``tp_param_spec`` gives. Returns the number of split leaves."""
    from tailored_avsr_tpu_torch.parallel.mesh import tp_param_spec
    from tailored_avsr_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
    from tailored_avsr_tpu_torch.tasks.avsr import build_meta

    cfg = flagship_config()
    tokens = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
    full = {k: tuple(v.shape) for k, v in build_meta(cfg, tokens).named_parameters()}
    split = 0
    for rank in range(model_parallel):
        model = build_meta(cfg, tokens)
        tp = apply_tensor_parallel(model, model_parallel, rank)
        for name, p in model.named_parameters():
            key, dim = tp.names.get(name, (name, None))
            want = list(full[key])
            spec = tp_param_spec(key, full[key], model_parallel)
            if spec != dim:
                raise AssertionError(f"{key}: split along {dim}, tp_param_spec says {spec}")
            if dim is not None:
                want[dim] //= model_parallel
                split += rank == 0
            if tuple(p.shape) != tuple(want):
                raise AssertionError(f"{key} on model rank {rank}: shard {tuple(p.shape)}, want {tuple(want)}")
    return split


def _rank(rank: int, n: int, store: str, cuda: bool, model_parallel: int, out: str) -> None:
    torch.set_num_threads(1)
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{store}", rank=rank, world_size=n)
    try:
        result = _rank_work(rank, n, torch.device("cuda", rank) if cuda else torch.device("cpu"), model_parallel)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _rank_work(rank: int, n: int, device, model_parallel: int) -> dict:
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.parallel.mesh import make_grid, replicate
    from tailored_avsr_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    grid = make_grid(device, model_parallel)
    cfg = flagship_config(tiny=True)
    tokens = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
    model = replicate(build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device))
    tp = apply_tensor_parallel(model, grid.model, grid.model_rank, grid.model_group) if grid.model > 1 else None
    ts = {"optimizer": "adam", "scheduler": "noam", "learning_rate": 1e-3, "warmup_steps": 100,
          "noam_factor": 1.0, "accum_grad": 1, "epochs": 1, "grad_clip": 5.0}
    optimizer, _ = set_optimizer(ts, model_size=64, steps_per_epoch=10, named_params=model.named_parameters())
    if tp is not None:
        optimizer.set_tensor_parallel(tp.is_split, grid.model_group)
    state = create_train_state(model, optimizer, tp=tp)
    batch = tuple(t.to(device) for t in example_batch(8, max(2, n // model_parallel)))
    state, stats = make_train_step(grid=grid)(state, batch)
    loss = float(stats["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"rank {rank}: the multi-rank train step gave a non-finite loss {loss}")
    weights = model.state_dict()  # gathered: the single-process layout
    cfg.inference_conf = dict(cfg.inference_conf or {}, beam_size=2, ctc_weight=0.3, lm_weight=0.0,
                              nbest=1, data_parallel=True)
    s2t = Speech2Text(cfg, device=device)
    s2t.model.load_state_dict(weights)
    names = ("audio", "audio_lengths", "video", "video_lengths")
    request = {k: t.cpu().numpy() for k, t in zip(names, batch)}
    greedy = s2t.greedy(request)
    beam = s2t(request)
    if len(greedy) != len(beam) or len(beam) != batch[0].shape[0]:
        raise AssertionError(f"rank {rank}: {len(greedy)} greedy and {len(beam)} beam results for "
                             f"{batch[0].shape[0]} utterances")
    return {"grid": grid.shape(), "loss": loss, "greedy": greedy, "beam": [r[0] for r in beam]}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the dry run over ``n_devices`` ranks on ``device`` (``cuda``: one
    card a rank; ``cpu``); returns rank 0's readings (grid, loss,
    transcripts), the backend and device, and the number of the full
    flagship's split leaves."""
    cuda = torch.device(device).type == "cuda"
    if cuda and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"the dry run over {n_devices} ranks takes {n_devices} CUDA cards, and the host has "
                           f"{torch.cuda.device_count()}; pass device='cpu' (--device cpu) for gloo CPU ranks")
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank, args=(n_devices, os.path.join(tmp, "store"), cuda, model_parallel, out),
                           nprocs=n_devices, start_method="spawn")
        result = torch.load(out, weights_only=False)
    result["backend"], result["device"] = ("nccl", "cuda") if cuda else ("gloo", "cpu")
    result["full_split_leaves"] = check_full_shards(model_parallel) if model_parallel > 1 else 0
    return result


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="the multi-rank dry run on the tiny flagship")
    parser.add_argument("n", type=int, nargs="?", default=4, help="ranks (default 4)")
    parser.add_argument("--device", default="cuda", help="cuda (one card a rank, NCCL; default) or cpu (gloo)")
    a = parser.parse_args()
    print(dryrun_multichip(a.n, a.device))
