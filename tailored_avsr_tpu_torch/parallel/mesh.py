"""The rank grid and its rules (counterpart of ``tailored_avsr_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds a ``Mesh`` of
its devices, shaped ``('data', 'model')``, and GSPMD splits the work. The
port runs one process per card, started by ``torchrun`` (or
``torch.multiprocessing.spawn``), joined in one ``torch.distributed``
process group: NCCL for CUDA ranks, gloo for CPU ranks. ``Grid`` is the
mesh: ``world = data x model`` ranks laid out data-major, model-minor, as
``make_mesh`` lays out its devices, with one process group per data
column (the ranks that hold the same model shard) and one per model row
(the ranks that see the same batch rows). Outside a process group the
grid is one rank, the counterpart of a one-device mesh.

- ``init_from_env``: the process group from ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` (``torchrun``'s variables) and the rank's device,
  ``cuda:LOCAL_RANK`` unless the CPU is asked for. ``WORLD_SIZE`` > 1 with
  a group that fails to start raises.
- ``make_grid``: the grid over the current group.
- ``replicate``: every parameter and buffer broadcast from rank 0, as
  ``replicate`` places a tree on every device.
- ``tp_param_spec``: the tensor-parallel rule, leaf by leaf, on the port's
  parameter names (the reference's key grammar,
  ``utils/torch_compat.py``), which keep the flax names the JAX rule reads.
- ``all_gather_dim`` on any backend, and ``all_reduce_sum``, which autograd
  differentiates (backward: an all-reduce).

``data_parallel_jit`` has no counterpart: without ``jit`` the data-parallel
train step (``train/loop.py``) takes its place. ``shard_pallas_over_data``
exists for the TPU only: each rank launches its kernels on its own rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the JAX rule's leaf names (``tailored_avsr_tpu/parallel/mesh.py:71-86``)
COLUMN_PARALLEL = ("w_1", "channel_proj1", "linear_q", "linear_k", "linear_v", "linear_pos")
ROW_PARALLEL = ("w_2", "channel_proj2", "linear_out")
HEAD_PARALLEL = ("pos_bias_u", "pos_bias_v")


def tp_param_spec(name: str, shape: Tuple[int, ...], model_parallel: int) -> Optional[int]:
    """The dimension of the port's parameter ``name`` (shape ``shape``)
    that tensor parallelism splits over the model group, or None
    (replicated): the JAX rule, on the transposed layout. Column-parallel
    kernels (flax (in, out), split over out) are torch (out, in) weights
    split over dim 0; row-parallel ones over their input, torch dim 1;
    the per-head rel-pos biases (H, dk) over the heads. Each checks the
    divisibility the JAX rule checks."""
    if model_parallel <= 1 or len(shape) != 2:
        return None
    if any(k in name for k in COLUMN_PARALLEL) and shape[0] % model_parallel == 0:
        return 0
    if any(k in name for k in ROW_PARALLEL) and shape[1] % model_parallel == 0:
        return 1
    if any(k in name for k in HEAD_PARALLEL) and shape[0] % model_parallel == 0:
        return 0
    return None


@dataclass(frozen=True)
class Grid:
    """``data`` x ``model`` ranks; this process is ``rank``. ``data_group``
    joins the ranks of this rank's model shard (they split the batch),
    ``model_group`` the ranks of this rank's batch rows (they split the
    tensor-parallel leaves); both None outside a process group."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK``
    (NCCL) or the CPU (gloo) when ``device`` is ``cpu``. One process
    (``WORLD_SIZE`` unset or 1) joins nothing and returns ``device``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    want = torch.device(device)
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this rank runs on the CUDA card and the host has none; pass --device cpu")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        want = torch.device("cuda", local if want.index is None or world > 1 else want.index)
        torch.cuda.set_device(want)
    if world <= 1 or dist.is_initialized():
        return want
    dist.init_process_group("nccl" if want.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return want


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_grid(device, model_parallel: int = 1) -> Grid:
    """The ``(data, model)`` grid over the current process group (every rank
    calls this together: each subgroup is made on every rank; a one-rank
    group has one-rank subgroups, whose collectives still run through its
    backend), or the one-rank grid without groups outside one."""
    device = torch.device(device)
    n = world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the world size ({n})")
    if not (dist.is_available() and dist.is_initialized()):
        return Grid(1, 1, 0, device)
    rank, data = global_rank(), n // model_parallel
    data_group = model_group = None
    for m in range(model_parallel):  # the data columns: ranks m, m + model, ...
        g = dist.new_group(list(range(m, n, model_parallel)))
        if rank % model_parallel == m:
            data_group = g
    for d in range(data):  # the model rows: ranks d * model ... d * model + model - 1
        g = dist.new_group(list(range(d * model_parallel, (d + 1) * model_parallel)))
        if rank // model_parallel == d:
            model_group = g
    return Grid(data, model_parallel, rank, device, data_group, model_group)


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's (a broadcast
    over the whole group), in place; nothing outside a group."""
    if world_size() > 1:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_gather_objects(obj, group=None) -> list:
    """Each rank's ``obj`` in rank order (any backend: pickled on the CPU)."""
    if group is None and world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order. NCCL gathers; gloo gathers no CUDA tensor, so there each rank
    writes its slot of a zero buffer and the group sums it."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if _backend(group) == "nccl":
        out = torch.empty((n,) + x.shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        out = torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
        out[r] = x
        dist.all_reduce(out, group=group)
    return torch.cat(out.unbind(0), dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the group's sum; backward: the group's sum of the gradients
    (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)
