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

Data parallelism (``grid``, ``parallel/mesh.Grid``): each rank of a data
group takes its rows of the global batch (``parallel/host_data.local_rows``:
the remainder one row each to the first ranks; a batch smaller than the
group stays whole on every rank, as the JAX CLI replicates a batch it
cannot shard) and runs the forward inside ``data_shard``, where every loss
normaliser is the global batch's, BatchNorm takes the global batch's
statistics and the per-utterance draws are the global draw's rows; every
rank draws the same micro-step seed, so the stochastic-depth and
branch-drop coins agree, and seeds dropout's generator with it plus its
data rank, so each rank's rows draw their own masks, as the rows of one
process do (a batch kept whole draws the single-process masks on every
rank); the ranks of a model group draw alike, apart from the split
feed-forward's hidden units (``parallel/tensor_parallel.py``). The
gradients are then summed over the data group by one all-reduce of their
flattened concatenation, before the optimizer's global-norm clip (the JAX
step clips the global batch's gradient), once per micro-step: the sum is the global batch's gradient,
and every replica applies the same update. An explicit all-reduce, not
DDP: stochastic depth and branch drop leave some parameters without a
gradient on some steps, which DDP's reducer takes for an error (or walks
the graph each step to find), and the summation order is fixed. The
scalar stats are summed over the group the same way. Under tensor
parallelism (``grid.model`` > 1, ``parallel/tensor_parallel.py``) the
model's split leaves hold this rank's shards; the data group reduces each
shard's gradient, and the clip sums the split leaves' squares over the
model group.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tailored_avsr_tpu_torch.models import remat as remat_regions
from tailored_avsr_tpu_torch.parallel.host_data import data_shard, local_rows
from tailored_avsr_tpu_torch.parallel.mesh import Grid
from tailored_avsr_tpu_torch.train.optim import Optimizer, Schedule


@dataclass
class TrainState:
    step: int  # micro-steps taken
    model: nn.Module  # f32 master weights and BatchNorm statistics
    optimizer: Optimizer
    schedule: Schedule
    generator: torch.Generator  # CPU: one seed per micro-step
    tp: Optional[object] = None  # parallel/tensor_parallel.TensorParallel: the model's shards


def create_train_state(model: nn.Module, optimizer: Optimizer, seed: int = 0, tp=None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer, schedule=optimizer.schedule,
                      generator=torch.Generator().manual_seed(int(seed)), tp=tp)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    if compute_dtype is None or compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _scalars(stats: Dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in stats.items() if torch.is_tensor(v) and v.dim() == 0}


@torch.no_grad()
def all_reduce_gradients(params, group, scale: float = 1.0) -> None:
    """Sum ``params``' gradients (None counts as 0) over ``group`` in one
    all-reduce of their flattened concatenation, times ``scale``."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    for p, g in zip(params, _unflatten_dense_tensors(flat, grads)):
        p.grad = g


def _sum_stats(stats: Dict[str, torch.Tensor], group, scale: float) -> Dict[str, torch.Tensor]:
    if not stats:
        return stats
    keys = sorted(stats)
    flat = torch.stack([stats[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, (flat * scale).unbind(0)))


def make_train_step(compute_dtype: Optional[torch.dtype] = None, remat: bool = False,
                    grid: Optional[Grid] = None) -> Callable:
    """Returns ``step(state, batch) -> (state, scalar stats)``; ``batch`` is
    the model's inputs and targets on its device: (audio, audio_lengths,
    video, video_lengths, text, text_lengths) for the AVSR model, (speech,
    speech_lengths, text, text_lengths) for the ASR / VSR model. Stats
    stay on the device (0-dim tensors). ``remat`` recomputes each encoder
    layer, decoder layer and ResNet stage in the backward
    (``models/remat.py``): less memory, the same numbers. With a ``grid``
    whose data group is set, ``batch`` is the global batch and the step is
    data-parallel (see the module docstring); the stats are the global
    batch's."""
    group = grid.data_group if grid is not None else None

    def step(state: TrainState, batch: Tuple[torch.Tensor, ...]):
        model = state.model
        model.train()
        device = _device(model)
        seed = int(torch.randint(2 ** 62, (), generator=state.generator))
        host = torch.Generator().manual_seed(seed)
        shard = None
        if group is not None:
            batch, shard = local_rows(batch, grid)
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), data_shard(shard):
            # dropout's generator: each data rank's own rows draw their own masks
            torch.manual_seed(seed if shard is None else seed + grid.data_rank)
            with _autocast(device, compute_dtype), remat_regions.enabled(remat):
                loss, stats = model(*batch, generator=host)
            loss.backward()
        stats = _scalars(stats)
        if group is not None:  # a batch kept whole on every rank: each rank's sum is the group's
            scale = 1.0 if shard is not None else 1.0 / grid.data
            all_reduce_gradients(state.optimizer.params, group, scale)
            stats = _sum_stats(stats, group, scale)
        state.optimizer.step()
        state.step += 1
        return state, stats

    return step


def make_eval_step(grid: Optional[Grid] = None) -> Callable:
    """Returns ``step(state, batch) -> stats`` with the scalar losses and the
    greedy CTC ids (``ctc_argmax``, ``ctc_argmax_lens``). With a ``grid``
    whose data group is set, each rank evaluates its rows of the global
    batch: the losses are the global batch's, the ids this rank's rows
    (``rows``: their slice of the batch)."""
    group = grid.data_group if grid is not None else None

    @torch.no_grad()
    def step(state: TrainState, batch: Tuple[torch.Tensor, ...]) -> Dict:
        model = state.model
        model.eval()
        shard = None
        if group is not None:
            batch, shard = local_rows(batch, grid)
        with data_shard(shard):
            _, stats = model(*batch, return_ctc_argmax=True)
        out = _scalars(stats)
        if group is not None:
            out = _sum_stats(out, group, 1.0 if shard is not None else 1.0 / grid.data)
            out["rows"] = slice(0, batch[0].shape[0]) if shard is None else slice(
                shard.start, shard.start + shard.rows)
        out["ctc_argmax"], out["ctc_argmax_lens"] = stats["ctc_argmax"], stats["ctc_argmax_lens"]
        return out

    return step
