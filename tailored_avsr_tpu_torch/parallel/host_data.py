"""Each rank's rows of the global batch (counterpart of
``tailored_avsr_tpu/parallel/host_data.py``).

- ``process_batch_slice``: the slice of a global batch of ``n_utts``
  utterances that a rank loads; the remainder goes one utterance each to
  the first ranks, so every utterance is covered.
- ``DataShard`` (the counterpart of ``global_batch_from_local``): a rank
  keeps its rows local and knows the global batch they belong to. Inside
  ``data_shard(shard)`` every batch normaliser of the model is the global
  one (``global_rows``, ``global_count``), BatchNorm takes the global
  batch's statistics (``models/frontends.py``), and a random draw of one
  row per utterance (SpecAug, Mask-CTC's masking) draws the global batch's
  rows and keeps this rank's (``rand_rows``), so the data-parallel step
  equals the single-process step on the global batch, as a GSPMD step
  does. Outside the context each is the single-process form.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from tailored_avsr_tpu_torch.parallel import mesh


def process_batch_slice(n_utts: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """The slice of the global batch that rank ``rank`` of ``world`` holds
    (the process group's rank and size when not given); the remainder
    ``n_utts % world`` is spread one utterance each over the first ranks."""
    world = mesh.world_size() if world is None else world
    rank = mesh.global_rank() if rank is None else rank
    per, rem = divmod(n_utts, world)
    start = rank * per + min(rank, rem)
    return slice(start, start + per + (1 if rank < rem else 0))


@dataclass(frozen=True)
class DataShard:
    """Rows ``[start, start + rows)`` of a global batch of ``global_batch``
    utterances, split over ``group``."""

    group: Any
    start: int
    rows: int
    global_batch: int


_SHARD: contextvars.ContextVar[Optional[DataShard]] = contextvars.ContextVar("data_shard", default=None)


def current() -> Optional[DataShard]:
    return _SHARD.get()


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]):
    """Run the model's forward on this rank's rows of ``shard``'s batch
    (None: the whole batch, single-process)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def local_rows(batch: Sequence[torch.Tensor], grid: "mesh.Grid") -> Tuple[tuple, Optional[DataShard]]:
    """This rank's rows of a global batch of (B, ...) tensors and their
    ``DataShard``; a batch smaller than the data group stays whole on every
    rank (None), as the JAX CLI replicates a batch it cannot shard."""
    b = int(batch[0].shape[0])
    if grid.data_group is None or b < grid.data:
        return tuple(batch), None
    rows = process_batch_slice(b, grid.data_rank, grid.data)
    shard = DataShard(grid.data_group, rows.start, rows.stop - rows.start, b)
    return tuple(t[rows] for t in batch), shard


def global_rows(n: int) -> int:
    """A count of ``n`` items per local row (``n`` = rows x k) over the
    global batch."""
    shard = current()
    if shard is None:
        return n
    return n // shard.rows * shard.global_batch


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count the loss normalises by (valid tokens), summed over the data
    group."""
    shard = current()
    if shard is None:
        return count
    count = count.clone()
    torch.distributed.all_reduce(count, group=shard.group)
    return count


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the data group."""
    shard = current()
    return x if shard is None else mesh.all_reduce_sum(x, shard.group)


def rand_rows(b: int, *shape: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``torch.rand((b,) + shape)`` for this rank's ``b`` rows: the global
    batch's draw, then this rank's rows, so every rank draws the same
    numbers and leaves its generator in the same state."""
    shard = current()
    if shard is None:
        return torch.rand((b,) + shape, generator=generator)
    assert b == shard.rows, (b, shard)
    u = torch.rand((shard.global_batch,) + shape, generator=generator)
    return u[shard.start:shard.start + b]
