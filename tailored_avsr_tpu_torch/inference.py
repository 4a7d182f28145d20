"""Speech2Text: config + weights -> batched greedy CTC serving on one device
(counterpart of ``tailored_avsr_tpu/inference.py:133``, greedy mode only).

The constructor takes the JAX engine's arguments plus ``device``; the
weights come from ``ckpt_path`` (a PyTorch state dict in the reference key
grammar, as ``utils/torch_compat.export_torch_state_dict`` writes it) or,
without one, from a ``torch.Generator`` seeded with ``rng_seed``.
``greedy(batch) -> List[str]`` follows ``inference.py:1051``, including the
dequantisation of uint8 video and int16 audio on the device
(``inference.py:247-255``). The label-synchronous beam search with LM
fusion (``__call__``), n-gram fusion, Mask-CTC, quantised weights and
mesh-parallel decoding are not ported yet and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
from tailored_avsr_tpu_torch.tasks.avsr import build_model
from tailored_avsr_tpu_torch.utils.convert import filter_state_dict

_SPACE = "<space>"


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tailored_avsr_tpu_torch yet "
        f"(ROADMAP.md 'Modules to port' item {item})"
    )


def load_token_list(token_list) -> List[str]:
    """A token-list file (one token per line) or a list of tokens."""
    if isinstance(token_list, str) and os.path.exists(token_list):
        with open(token_list, encoding="utf-8") as f:
            return [line.rstrip() for line in f if line.rstrip()]
    return list(token_list)


class Speech2Text:
    def __init__(
        self,
        config,
        ckpt_path: Optional[str] = None,
        lm_config=None,
        lm_ckpt_path: Optional[str] = None,
        ngram_path: Optional[str] = None,
        rng_seed: int = 0,
        mesh=None,
        *,
        device=None,
    ):
        if lm_config is not None or lm_ckpt_path:
            raise _not_ported("Transformer-LM shallow fusion", 5)
        if ngram_path:
            raise _not_ported("n-gram fusion", 7)
        if mesh is not None:
            raise _not_ported("mesh-parallel decoding", 9)
        task = getattr(config, "task", "avsr")
        if task != "avsr":
            raise _not_ported(f"task {task!r}", 8)
        token_type = getattr(config, "token_type", "char")
        if token_type != "char":
            raise _not_ported(f"token_type {token_type!r}", 8)
        inf = dict(getattr(config, "inference_conf", {}) or {})
        if inf.get("quantize_asr_model") or inf.get("data_parallel"):
            raise _not_ported("quantize_asr_model / data_parallel", 7)
        self.config = config
        self.token_list = load_token_list(config.token_list)
        self.device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
        self.dtype = (
            torch.bfloat16
            if str(getattr(config, "dtype", "float32")) in ("bfloat16", "bf16")
            else torch.float32
        )
        self.model = build_model(
            config, self.token_list, generator=torch.Generator().manual_seed(rng_seed),
            device=self.device, dtype=self.dtype,
        )
        if ckpt_path:
            self.load_checkpoint(ckpt_path)
        # quantised inputs: uint8 video / int16 audio (host transform chain
        # Normalise(0, 250) + Normalise(mean, std), as in the JAX engine)
        self.video_scale = float(inf.get("video_scale", 250.0))
        self.video_mean = float(inf.get("video_mean", 0.421))
        self.video_std = float(inf.get("video_std", 0.165))

    def load_checkpoint(self, path: str) -> List[str]:
        """Strict load of a PyTorch state dict (``.pth`` / ``.pt``); keys the
        serving model has no module for (the attention decoder) are dropped
        and returned."""
        if not path.endswith((".pth", ".pt")):
            raise NotImplementedError(
                f"{path}: only PyTorch state dicts load into the port; convert a JAX "
                "checkpoint with tailored_avsr_tpu_torch.utils.convert first"
            )
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]
        kept, dropped = filter_state_dict(self.model, sd)
        self.model.load_state_dict(kept, strict=True)
        return dropped

    def inputs(self, batch: Dict) -> Tuple[torch.Tensor, ...]:
        """(audio, audio_lengths, video, video_lengths) on the device, ready
        for the model: uint8 video -> (x / video_scale - video_mean) /
        video_std and int16 audio -> x / 32768, with -1 past each utterance's
        length (the pad value of the float path); every float stream in the
        model's dtype."""
        args = [
            torch.as_tensor(batch[k], device=self.device)
            for k in ("audio", "audio_lengths", "video", "video_lengths")
        ]
        for i, a in enumerate(args):
            if a.dim() < 2:
                continue  # length vectors
            if a.dtype == torch.uint8:
                x = (a.float() / self.video_scale - self.video_mean) / self.video_std
            elif a.dtype == torch.int16:
                x = a.float() / 32768.0
            else:
                args[i] = a.to(self.dtype)
                continue
            lengths = args[i + 1]  # (tensor, lengths) pairs by convention
            valid = torch.arange(x.shape[1], device=x.device) < lengths[:, None]
            x = torch.where(valid.reshape(valid.shape + (1,) * (x.dim() - 2)), x, -1.0)
            args[i] = x.to(self.dtype)
        return tuple(args)

    def __call__(self, batch: Dict):
        raise _not_ported("label-synchronous beam search (decode_mode label_sync)", 5)

    def nbest(self, batch: Dict):
        raise _not_ported("n-best beam decoding", 5)

    @torch.inference_mode()
    def greedy(self, batch: Dict) -> List[str]:
        """CTC greedy decoding: one transcript per utterance of the batch."""
        ids, lens = self.model.ctc_greedy(*self.inputs(batch))
        hyps = ctc_greedy_collapse(ids.cpu().numpy(), lens.cpu().numpy())
        return [
            "".join(" " if t == _SPACE else t for t in (self.token_list[i] for i in h))
            for h in hyps
        ]
