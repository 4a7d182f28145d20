"""Train and eval steps and the TrainState
(counterpart of ``tailored_avsr_tpu/train/loop.py``).

The train step runs the model in training mode (dropout, SpecAug,
stochastic depth, branch drop, BatchNorm batch statistics), backward, and
``Optimizer.step`` (which accumulates ``accum_grad`` micro-steps before it
moves the parameters). Mixed precision is ``torch.autocast`` to the compute
dtype over f32 master weights: matmuls and convolutions run in bf16,
LayerNorm, softmax and the losses in f32 (the port's LayerNorms and losses
upcast explicitly), gradients land in f32; bf16 has f32's exponent range,
so there is no loss scaling. The JAX loop instead casts every f32 parameter
and input to bf16 for the whole forward. ``remat`` is activation
recomputation (``models/remat.py``), as the JAX loop's ``jax.checkpoint``.

Randomness: each micro-step draws one seed from ``TrainState.generator``
(CPU). It seeds a CPU generator for the host-side draws (SpecAug, the
stochastic-depth and branch-drop coins, and a Mask-CTC model's MLM
masking, the JAX ``mlm`` stream) and, inside
``torch.random.fork_rng``, torch's generators for dropout; one seed gives
the same losses run after run, and a resumed run continues the stream.

The eval step is ``model.eval()`` under ``torch.no_grad``, the JAX
``deterministic=True``: the forward-only kernels (flash attention K1/K2 and
the cgMLP gate K3, where the config enables them) run on the card. The
train step never reaches them: the kernel routes test ``not self.training``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from tailored_avsr_tpu_torch.models import remat as remat_regions
from tailored_avsr_tpu_torch.train.optim import Optimizer, Schedule


@dataclass
class TrainState:
    step: int  # micro-steps taken
    model: nn.Module  # f32 master weights and BatchNorm statistics
    optimizer: Optimizer
    schedule: Schedule
    generator: torch.Generator  # CPU: one seed per micro-step


def create_train_state(model: nn.Module, optimizer: Optimizer, seed: int = 0) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer, schedule=optimizer.schedule,
                      generator=torch.Generator().manual_seed(int(seed)))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    if compute_dtype is None or compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _scalars(stats: Dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in stats.items() if torch.is_tensor(v) and v.dim() == 0}


def make_train_step(compute_dtype: Optional[torch.dtype] = None, remat: bool = False) -> Callable:
    """Returns ``step(state, batch) -> (state, scalar stats)``; ``batch`` is
    the model's inputs and targets on its device: (audio, audio_lengths,
    video, video_lengths, text, text_lengths) for the AVSR model, (speech,
    speech_lengths, text, text_lengths) for the ASR / VSR model. Stats
    stay on the device (0-dim tensors). ``remat`` recomputes each encoder
    layer, decoder layer and ResNet stage in the backward
    (``models/remat.py``): less memory, the same numbers."""

    def step(state: TrainState, batch: Tuple[torch.Tensor, ...]):
        model = state.model
        model.train()
        device = _device(model)
        seed = int(torch.randint(2 ** 62, (), generator=state.generator))
        host = torch.Generator().manual_seed(seed)
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            with _autocast(device, compute_dtype), remat_regions.enabled(remat):
                loss, stats = model(*batch, generator=host)
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, _scalars(stats)

    return step


def make_eval_step() -> Callable:
    """Returns ``step(state, batch) -> stats`` with the scalar losses and the
    greedy CTC ids (``ctc_argmax``, ``ctc_argmax_lens``)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Tuple[torch.Tensor, ...]) -> Dict:
        model = state.model
        model.eval()
        _, stats = model(*batch, return_ctc_argmax=True)
        out = _scalars(stats)
        out["ctc_argmax"], out["ctc_argmax_lens"] = stats["ctc_argmax"], stats["ctc_argmax_lens"]
        return out

    return step
