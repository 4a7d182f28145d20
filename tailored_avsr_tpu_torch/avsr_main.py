#!/usr/bin/env python
"""Training and inference CLI of the port (counterpart of ``avsr_main.py``):
the same arguments, modes, epoch loop, top-K checkpoint averaging,
resume and .inf / .wer outputs, plus ``--device`` (``cuda`` by default; it
raises on a host without one, ``--device cpu`` runs on the CPU).

    python -m tailored_avsr_tpu_torch.avsr_main --config-file CONFIG \\
        --training-dataset TRAIN.csv --validation-dataset VAL.csv \\
        --test-dataset TEST.csv --mode both --output-dir EXP --output-name NAME

``--mode training`` trains: one train step per batch (``accum_grad``
micro-steps per optimizer update), then per epoch the validation and test
loss and greedy-CTC CER (the eval step, where the kernels run), a
``models/model_NNN.pth`` checkpoint and ``models/train_state.pt`` for
``--resume``; at the end ``val_stats.csv`` and ``models/model_average.pth``
(the mean of the ``average_epochs`` best epochs by validation CER).
``--mode inference`` (and the second half of ``both``, on the average)
decodes the test set with ``Speech2Text`` and the config's
``inference_conf`` (``--ngram-file``: an ARPA n-gram for shallow fusion,
used when ``ngram_weight`` > 0) into ``inference/NAME.inf`` and
``NAME.wer``, through ``Speech2Text.stream``: each batch uploads while the
one before it decodes.
SIGTERM / SIGINT stop training at the next step; ``--resume`` re-trains the
interrupted epoch from the last completed one.

The config's ``task`` picks the model and the batch keys: ``avsr``
(audio + video), ``asr`` (audio) or ``vsr`` (video), each a ``speech``
stream. training_settings ``remat`` recomputes the activations in the
backward (``models/remat.py``); a config ``init`` scheme redraws the
seeded weights (``utils/initialize.initialize``).

On N cards: ``torchrun --nproc-per-node N -m tailored_avsr_tpu_torch.avsr_main
...`` (``--device cpu``: N CPU ranks over gloo). Each rank takes the process
group from the environment and its card, ``cuda:LOCAL_RANK``
(``parallel/mesh.init_from_env``). With training_settings
``data_parallel: true`` or ``model_parallel`` > 1 and more than one rank,
training runs over the ``(data, model)`` rank grid it prints (the JAX
CLI's ``training mesh``): every rank runs the same loader with the same
seed and takes its rows of each global batch (``train/loop.py``), the
tensor-parallel leaves are split over the model group
(``parallel/tensor_parallel.py``), and the validation loss and CER are the
global batch's, every rank's rows gathered. Every rank loads ``--resume``
and ``--load-checkpoint``; rank 0's weights are broadcast; only rank 0
writes checkpoints (gathered to the single-process layout), ``val_stats.csv``,
the ``.inf`` / ``.wer`` files and the log, while the others wait at a
barrier. Inference with ``inference_conf data_parallel: true`` decodes
each rank's rows of each batch (``Speech2Text``).
"""

from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from tailored_avsr_tpu_torch.data.dataloader import AVSRDataLoader
from tailored_avsr_tpu_torch.data.dataset import AVSRDataset, load_wav
from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.data.transforms_audio import AddNoise, Compose, SpeedRate
from tailored_avsr_tpu_torch.data.transforms_video import (
    CenterCrop,
    HorizontalFlip,
    Normalise,
    QuantizeUint8,
    RandomCrop,
)
from tailored_avsr_tpu_torch.data.transforms_video import TimeMasking as VideoTimeMasking
from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
from tailored_avsr_tpu_torch.evaluation.wer import cer_from_ids, compute_bootstrap_wer, write_inf_file
from tailored_avsr_tpu_torch.inference import Speech2Text
from tailored_avsr_tpu_torch.parallel import mesh as parallel_mesh
from tailored_avsr_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
from tailored_avsr_tpu_torch.tasks.common import build_model, resolve_device, task_of
from tailored_avsr_tpu_torch.train.checkpoint import (
    average_models,
    freeze_mask,
    load_e2e,
    load_train_state,
    prune_checkpoints,
    save_model,
    save_train_state,
    save_val_stats,
    top_k_epochs,
)
from tailored_avsr_tpu_torch.train.loop import create_train_state, make_eval_step, make_train_step
from tailored_avsr_tpu_torch.train.optim import set_optimizer
from tailored_avsr_tpu_torch.utils.config import load_config, security_checks
from tailored_avsr_tpu_torch.utils.initialize import initialize

BATCH_KEYS = {
    "asr": ("speech", "speech_lengths", "text", "text_lengths"),
    "vsr": ("speech", "speech_lengths", "text", "text_lengths"),
    "avsr": ("audio", "audio_lengths", "video", "video_lengths", "text", "text_lengths"),
}


def batch_tuple(batch: Dict, task: str, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The model's inputs of ``task`` on ``device``."""
    return tuple(torch.as_tensor(np.asarray(batch[k])).to(device) for k in BATCH_KEYS[task])


def collapse_refs(text, text_lengths) -> List[List[int]]:
    return [list(t[:l]) for t, l in zip(np.asarray(text), np.asarray(text_lengths))]


def compute_dtype_of(config) -> torch.dtype:
    """bf16 compute for a config ``dtype: bfloat16`` or training_settings
    ``use_amp: true``, else f32 (the JAX CLI's rule)."""
    ts = getattr(config, "training_settings", {}) or {}
    bf16 = str(getattr(config, "dtype", "float32")) in ("bfloat16", "bf16") or bool(ts.get("use_amp", False))
    return torch.bfloat16 if bf16 else torch.float32


def _is_writer() -> bool:
    return parallel_mesh.global_rank() == 0


def _log(*args, **kwargs) -> None:
    if _is_writer():
        print(*args, **kwargs)


def _any_rank(flag: bool, device) -> bool:
    """Whether any rank's ``flag`` is set (every rank stops together)."""
    if parallel_mesh.world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def training_grid(config, device):
    """The ``(data, model)`` grid of a data- or tensor-parallel run over more
    than one rank, else None (the JAX CLI builds its mesh only over more
    than one device)."""
    ts = config.training_settings
    model_par = int(ts.get("model_parallel", 1))
    if not (bool(ts.get("data_parallel", False)) or model_par > 1) or parallel_mesh.world_size() == 1:
        return None
    return parallel_mesh.make_grid(device, model_par)


def run_training(args, config, tokenizer, converter, transforms, device) -> bool:
    """The epoch loop; returns False when a signal stopped it early."""
    ts, task = config.training_settings, task_of(config)
    grid = training_grid(config, device)
    model = build_model(config, converter.token_list,
                        generator=torch.Generator().manual_seed(int(ts.get("seed", 0))),
                        device=device, dtype=torch.float32)  # f32 master weights
    init_scheme = getattr(config, "init", None)
    if init_scheme:
        initialize(model, init_scheme, torch.Generator().manual_seed(int(ts.get("seed", 0))))
        _log(f"re-initialized parameters with {init_scheme}")

    def loader(path, is_training, audio_tf, video_tf):
        ds = AVSRDataset(path, task=task, nframes_limit=ts.get("nframes") if is_training else None,
                         is_training=is_training)
        return AVSRDataLoader(ds, ts["batch_size"], task=task, audio_transforms=audio_tf,
                              video_transforms=video_tf, tokenizer=tokenizer, converter=converter,
                              is_training=is_training, workers=int(ts.get("num_workers", 0) or 0))

    train_loader = loader(args.training_dataset, True, transforms["train_audio"], transforms["train_video"])
    val_loader = loader(args.validation_dataset, False, transforms["eval_audio"], transforms["eval_video"])
    test_loader = loader(args.test_dataset, False, transforms["eval_audio"], transforms["eval_video"])
    _log(f"model parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")

    if args.load_checkpoint:
        load_e2e(model, args.load_checkpoint, args.load_modules)
    parallel_mesh.replicate(model)
    tp = None
    if grid is not None:
        if grid.model > 1:
            tp = apply_tensor_parallel(model, grid.model, grid.model_rank, grid.model_group)
        _log(f"training grid: {grid.shape()}")
    frozen = []
    if args.freeze_modules and args.freeze_modules != ["no-frozen"]:
        frozen = freeze_mask(model, args.freeze_modules)
        for name, p in model.named_parameters():
            if name in frozen:
                p.requires_grad_(False)
    optimizer, _ = set_optimizer(
        ts, model_size=int((getattr(config, "encoder_conf", {}) or {}).get("output_size", 256)),
        steps_per_epoch=len(train_loader), named_params=model.named_parameters(), frozen=frozen)
    if tp is not None:
        optimizer.set_tensor_parallel(tp.is_split, grid.model_group)
    state = create_train_state(model, optimizer, seed=int(ts.get("seed", 0)), tp=tp)
    train_step = make_train_step(compute_dtype_of(config), remat=bool(ts.get("remat", False)), grid=grid)
    eval_step = make_eval_step(grid)
    writer = _is_writer()

    def validation(loader):
        tot_loss, n, refs, hyps = 0.0, 0, [], []
        for batch in loader:
            out = eval_step(state, batch_tuple(batch, task, device))
            tot_loss += float(out["loss"])
            n += 1
            ids = ctc_greedy_collapse(out["ctc_argmax"].cpu().numpy(), out["ctc_argmax_lens"].cpu().numpy())
            if grid is not None:  # every rank's rows, in batch order
                parts = dict(parallel_mesh.all_gather_objects((out["rows"].start, ids), grid.data_group))
                ids = [h for start in sorted(parts) for h in parts[start]]
            hyps.extend(ids)
            refs.extend(collapse_refs(batch["text"], batch["text_lengths"]))
        return tot_loss / max(n, 1), cer_from_ids(refs, hyps)

    models_dir = os.path.join(args.output_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    ts_path = os.path.join(models_dir, "train_state.pt")
    start_epoch = 1
    if args.resume and os.path.exists(ts_path):
        # every rank reads the same single-process file; a split leaf keeps its own shard of it
        state, done_epoch = load_train_state(state, ts_path)
        start_epoch = done_epoch + 1
        _log(f"resumed training state after epoch {done_epoch} (step {state.step})")
    val_stats, all_val_rows = [], []
    save_every = max(1, int(ts.get("save_every", 1) or 1))
    save_state_every = max(1, int(ts.get("save_state_every", save_every) or 1))
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        if stop_requested["flag"] and signum == signal.SIGINT:
            raise KeyboardInterrupt  # a second Ctrl-C stops at once
        stop_requested["flag"] = True
        _log(f"\nsignal {signum}: finishing the current step, then exiting (the state through the "
             "last completed epoch is on disk; --resume re-trains the interrupted epoch)")

    old_handlers = {s: signal.signal(s, _on_term) for s in (signal.SIGTERM, signal.SIGINT)}
    _log("\nTRAINING PHASE\n")
    try:
        for epoch in range(start_epoch, ts["epochs"] + 1):
            t0 = time.time()
            sums: Dict[str, float] = {}
            n = 0
            for batch in train_loader:
                state, stats = train_step(state, batch_tuple(batch, task, device))
                for k in ("loss", "loss_att", "loss_ctc", "loss_transducer", "acc"):
                    if k in stats:
                        sums[k] = sums.get(k, 0.0) + float(stats[k])
                n += 1
                stop_requested["flag"] = _any_rank(stop_requested["flag"], device)
                if stop_requested["flag"]:
                    break
            if stop_requested["flag"]:
                _log(f"preempted during epoch {epoch} after {n} steps: abandoning the partial epoch; "
                     f"rerun with --resume (restarts at epoch {epoch})")
                return False
            train_loss = sums.get("loss", 0.0) / max(n, 1)
            val_loss, val_cer = validation(val_loader)
            test_loss, test_cer = validation(test_loader)
            detail = "".join(f" {k.removeprefix('loss_').upper()}={v / max(n, 1):.3f}"
                             for k, v in sorted(sums.items()) if k != "loss")
            _log(f"Epoch {epoch}: TRAIN LOSS={train_loss:.3f}{detail} || VAL LOSS={val_loss:.3f} "
                 f"| VAL CER={val_cer:.2f}% || TEST LOSS={test_loss:.3f} | TEST CER={test_cer:.2f}% "
                 f"|| {time.time() - t0:.1f}s")
            all_val_rows.append({"epoch": epoch, "cer": val_cer})
            last_epoch = epoch == ts["epochs"] or stop_requested["flag"]
            if epoch % save_every == 0 or last_epoch:
                ckpt = os.path.join(models_dir, f"model_{epoch:03d}.pth")
                save_model(state.model, ckpt, write=writer)
                val_stats.append({"epoch": epoch, "cer": val_cer, "path": ckpt})
                keep = int(ts.get("keep_checkpoints", 0) or 0)
                if keep and writer:  # never below what the final averaging needs
                    prune_checkpoints(val_stats, max(keep, ts["average_epochs"]))
            if epoch % save_state_every == 0 or last_epoch:
                save_train_state(state, epoch, ts_path, write=writer)
            parallel_mesh.barrier()
            stop_requested["flag"] = _any_rank(stop_requested["flag"], device)
            if stop_requested["flag"]:
                _log(f"preempted after epoch {epoch} completed: state saved; rerun with --resume to continue")
                return False
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)

    if writer:
        save_val_stats(os.path.join(args.output_dir, "val_stats.csv"),
                       [{"epoch": r["epoch"], "cer": r["cer"]} for r in all_val_rows])
        best = top_k_epochs(val_stats, ts["average_epochs"])
        paths = [os.path.join(models_dir, f"model_{e:03d}.pth") for e in best]
        torch.save(average_models(paths), os.path.join(models_dir, "model_average.pth"))
        print(f"averaged top-{len(paths)} checkpoints -> model_average.pth")
    parallel_mesh.barrier()
    return True


def run_inference(args, config, tokenizer, converter, transforms, device) -> None:
    """Decode the test set; under ``inference_conf data_parallel`` each rank
    decodes its rows of every batch and rank 0 writes the results."""
    _log("\nINFERENCE PHASE\n")
    task = task_of(config)
    lm_config = load_config(args.lm_config_file) if args.lm_config_file else None
    s2t = Speech2Text(config, ckpt_path=args.load_checkpoint or None, lm_config=lm_config,
                      lm_ckpt_path=args.load_lm or None, ngram_path=args.ngram_file or None, device=device)
    inf_conf = dict(getattr(config, "inference_conf", {}) or {})
    video_tf = transforms["eval_video"]
    if bool(inf_conf.get("device_normalize", False)):
        # uint8 video through the host pipeline (the crop commutes with the
        # affine normalisation), dequantised on the device
        video_tf = Compose([CenterCrop((88, 88)), QuantizeUint8()])
    loader = AVSRDataLoader(
        AVSRDataset(args.test_dataset, task=task, is_training=False),
        int(inf_conf.get("batch_size", 1)), task=task, audio_transforms=transforms["eval_audio"],
        video_transforms=video_tf, tokenizer=tokenizer, converter=converter, is_training=False,
        workers=int((getattr(config, "training_settings", {}) or {}).get("num_workers", 0) or 0))
    n_best = int(inf_conf.get("nbest", 1))
    pairs, nbest_rows = [], []
    t0 = time.time()
    profiler = None
    if args.profile_dir and _is_writer():  # a trace of the first batch (rank 0's)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    def masked_batches():
        for batch in loader:
            if task == "avsr" and args.mask in ("audio", "video"):
                batch[args.mask] = batch[args.mask] * 0.0
            yield batch

    for batch, results in s2t.stream(masked_batches(), nbest=n_best > 1):
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
            print(f"wrote profiler trace to {args.profile_dir}")
            profiler = None
        for ref, hyp in zip(batch["refs"], results):
            if n_best > 1:
                text = hyp[0][0]
                for rank, (htext, _, _, score) in enumerate(hyp):
                    nbest_rows.append((len(pairs), rank + 1, htext, score))
            else:
                text = hyp[0]
            pairs.append((ref, text))
            _log(f"REF: {ref}\nHYP: {text}\n")
    dt = time.time() - t0
    if not _is_writer():
        return
    inf_dir = os.path.join(args.output_dir, "inference")
    os.makedirs(inf_dir, exist_ok=True)
    inf_path = os.path.join(inf_dir, args.output_name + ".inf")
    write_inf_file(inf_path, pairs)
    for rank in range(1, n_best + 1) if n_best > 1 else ():
        # espnet-style n-best directories: <name>_nbest/<k>best_recog/{text,score}
        d = os.path.join(inf_dir, args.output_name + "_nbest", f"{rank}best_recog")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "text"), "w") as ft, open(os.path.join(d, "score"), "w") as fs:
            for idx, r, text, score in nbest_rows:
                if r == rank:
                    ft.write(f"utt{idx:06d} {text}\n")
                    fs.write(f"utt{idx:06d} {score:.4f}\n")
    wer, cer, ci_w, ci_c = compute_bootstrap_wer(inf_path)
    with open(os.path.join(inf_dir, args.output_name + ".wer"), "w") as f:
        f.write(f"WER: {wer:.2f} +- {ci_w:.2f}\nCER: {cer:.2f} +- {ci_c:.2f}\n")
    print(f"%WER {wer:.2f} ± {ci_w:.2f} | %CER {cer:.2f} ± {ci_c:.2f} | {dt:.1f}s")


def build_transforms(args) -> Dict[str, Compose]:
    mean, std = 0.421, 0.165
    if args.noise and not os.path.exists(args.noise):
        raise FileNotFoundError(f"--noise {args.noise!r} not found (shipped assets: assets/noise/)")
    noise = load_wav(args.noise) if args.noise else None
    return {
        "train_audio": Compose([SpeedRate(sample_rate=16000)]),
        "eval_audio": Compose([AddNoise(noise=noise, snr_target=args.snr_target)]),
        "train_video": Compose([Normalise(0.0, 250.0), Normalise(mean, std), VideoTimeMasking(),
                                RandomCrop((88, 88)), HorizontalFlip(0.5)]),
        "eval_video": Compose([Normalise(0.0, 250.0), Normalise(mean, std), CenterCrop((88, 88))]),
    }


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Audio-visual speech recognition: the PyTorch/CUDA port's training and inference.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--training-dataset", default="", type=str)
    parser.add_argument("--validation-dataset", default="", type=str)
    parser.add_argument("--test-dataset", default="", type=str)
    parser.add_argument("--mode", default="both", type=str, help="'training', 'inference' or 'both'")
    parser.add_argument("--mask", default="none", type=str, help="'audio', 'video' or 'none'")
    parser.add_argument("--snr-target", default=9999, type=int)
    parser.add_argument("--noise", default="", type=str)
    parser.add_argument("--config-file", required=True, type=str)
    parser.add_argument("--load-checkpoint", default="", type=str)
    parser.add_argument("--lm-config-file", default="", type=str)
    parser.add_argument("--load-lm", default="", type=str)
    parser.add_argument("--ngram-file", default="", type=str, help="ARPA n-gram LM for shallow fusion")
    parser.add_argument("--profile-dir", default="", type=str,
                        help="write a torch.profiler trace of the first inference batch to this directory")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <output-dir>/models/train_state.pt")
    parser.add_argument("--load-modules", nargs="+", default=["entire-e2e"], type=str)
    parser.add_argument("--freeze-modules", nargs="+", default=["no-frozen"], type=str)
    parser.add_argument("--yaml-overrides", metavar="CONF:KEY:VALUE", nargs="*")
    parser.add_argument("--output-dir", required=True, type=str)
    parser.add_argument("--output-name", required=True, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda' (the card; raises without one) or 'cpu'")
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    config = load_config(args.config_file, args.yaml_overrides)
    security_checks(config)
    task_of(config)  # avsr, asr or vsr
    if args.mode not in ("training", "inference", "both"):
        raise ValueError(f"--mode must be 'training', 'inference' or 'both', got {args.mode!r}")
    if parallel_mesh.world_size() > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = parallel_mesh.init_from_env(args.device)  # this rank's card, in the group
    else:
        device = resolve_device(args.device, "tailored_avsr_tpu_torch.avsr_main")
    tokenizer, converter = get_tokenizer_converter(config)
    transforms = build_transforms(args)
    if args.mode in ("training", "both"):
        if not run_training(args, config, tokenizer, converter, transforms, device):
            _log("training was preempted: skipping the inference phase")
            return
        if args.mode == "both" and not args.load_checkpoint:
            args.load_checkpoint = os.path.join(args.output_dir, "models", "model_average.pth")
    if args.mode in ("inference", "both"):
        run_inference(args, config, tokenizer, converter, transforms, device)


if __name__ == "__main__":
    main()
