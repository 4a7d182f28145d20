"""Tensor parallelism (``training_settings model_parallel`` > 1): the leaves
``mesh.tp_param_spec`` names, split over the model group, as the JAX
package's ``shard_train_state`` places them on the mesh.

- Column-parallel linears (``w_1``, ``channel_proj1``, ``linear_q/k/v/pos``)
  hold their rows of the (out, in) weight and compute their part of the
  output; the parts are gathered, so what follows them sees the full
  width. That is what GSPMD does where the following code needs it: the
  CSGU splits ``channel_proj1``'s output at half (``[x_r | x_g]``), which a
  plain split would hand to two ranks, and the attention reshapes the
  projections into heads whether or not they divide over the group.
- Row-parallel linears (``w_2``, ``channel_proj2``, ``linear_out``) take
  their columns of the input and of the weight, and the group sums the
  partial products (Megatron's row-parallel layer).
- A feed-forward block (``PositionwiseFeedForward``: ``w_1``, an
  elementwise activation and dropout, ``w_2``) split on both sides runs
  as Megatron's pair: ``w_1``'s part of the hidden units stays on its rank
  through the activation into ``w_2``, with no gather between them. Its
  dropout draws each rank's own mask for its part (Megatron's
  model-parallel generator); every other dropout acts on replicated
  activations and draws alike on the ranks of a model group.
- ``pos_bias_u`` / ``pos_bias_v`` hold their heads and are gathered where
  the attention reads them.

Biases, norms and every other leaf replicate, as in the JAX rule. Adam's
moments live on the shards (the optimizer is built over them). The
gradients are exact: the gathers' backward keeps each rank's part, the
row split's backward gathers the input's gradient, and a column-parallel
layer's input gradient is summed over the group. The model's state dict
has the single-process layout: the shards are gathered when it is read
and split when it is loaded, so checkpoints are the single-process files.
The training forward takes the plain forms: tensor parallelism launches
no kernel, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.parallel import mesh


class _Group:
    """A model group, or a stand-in of ``size`` ranks for building shards on
    the meta device (no collective)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.chunk(self.size, dim=dim)[self.rank].contiguous()

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return mesh.all_gather_dim(x, dim, self.group)


class _Gather(torch.autograd.Function):
    """Forward: the group's parts concatenated along ``dim``; backward: this
    rank's part of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, g: _Group, dim: int):
        ctx.g, ctx.dim = g, dim
        return g.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.split(grad, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """Forward: this rank's part along ``dim``; backward: the parts'
    gradients gathered (the input is replicated)."""

    @staticmethod
    def forward(ctx, x, g: _Group, dim: int):
        ctx.g, ctx.dim = g, dim
        return g.split(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.gather(grad.contiguous(), ctx.dim), None, None


class _Copy(torch.autograd.Function):
    """Forward: identity; backward: the group's sum (each rank's part of the
    layer gives a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, g: _Group):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.g.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Forward: the group's sum of the partial products; backward: identity."""

    @staticmethod
    def forward(ctx, x, g: _Group):
        x = x.contiguous().clone()
        torch.distributed.all_reduce(x, group=g.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitDropout(nn.Module):
    """Dropout on this rank's part of a split feed-forward's hidden units,
    from a generator of its own: one draw of the default generator (which
    the ranks of a model group hold alike, and a checkpointed region's
    recompute restores) plus the model rank seeds it."""

    def __init__(self, p: float, g: _Group):
        super().__init__()
        self.p, self.g = p, g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        seed = int(torch.randint(2 ** 62, ())) + self.g.rank
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=torch.Generator(x.device).manual_seed(seed))
        return x * keep / (1.0 - self.p)


class _ParallelLinear(nn.Module):
    """An ``nn.Linear`` of ``in_features`` -> ``out_features`` whose weight
    holds this rank's part along ``dim`` (0: rows, column-parallel; 1:
    columns, row-parallel); the bias is replicated. ``parallel_io``: a
    column-parallel layer's output stays split (its part of the bias
    added), a row-parallel layer's input arrives split. Its state dict
    holds the whole weight."""

    tensor_parallel = True

    def __init__(self, linear: nn.Linear, dim: int, g: _Group):
        super().__init__()
        self.in_features, self.out_features, self.dim, self.g = linear.in_features, linear.out_features, dim, g
        self.weight = nn.Parameter(g.split(linear.weight.detach(), dim), requires_grad=linear.weight.requires_grad)
        self.bias = linear.bias
        self.parallel_io = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:  # a flax Dense promotes its input and kernel
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dt), w.to(dt), None if b is None else b.to(dt)
        if self.dim == 0:
            y = F.linear(_Copy.apply(x, self.g), w)
            if self.parallel_io:  # this rank's outputs and its part of the replicated bias
                return y if b is None else y + _Split.apply(b, self.g, 0)
            y = _Gather.apply(y, self.g, x.dim() - 1)
        else:
            y = _Reduce.apply(F.linear(x if self.parallel_io else _Split.apply(x, self.g, x.dim() - 1), w), self.g)
        return y if b is None else y + b

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        w = destination[prefix + "weight"]
        destination[prefix + "weight"] = self.g.gather(w if keep_vars else w.detach(), self.dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        if key in state_dict and state_dict[key].shape != self.weight.shape:
            state_dict[key] = self.g.split(state_dict[key], self.dim)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, split dim={self.dim}"


class _GatherHeads(nn.Module):
    """Parametrization of a per-head (H, dk) bias: stored as this rank's
    heads, read whole."""

    def __init__(self, g: _Group):
        super().__init__()
        self.g = g

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(shard, self.g, 0)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.g.split(full, 0)


def _head_hooks(module: nn.Module, name: str, g: _Group) -> None:
    """The state dict of ``module`` keeps ``name`` whole under its own key."""
    stored = f"parametrizations.{name}.original"

    def save(mod, sd, prefix, _meta):
        shard = sd.pop(prefix + stored)
        sd[prefix + name] = g.gather(shard.detach(), 0)
        return sd

    def load(mod, sd, prefix, *_):
        if prefix + name in sd:
            sd[prefix + stored] = g.split(sd.pop(prefix + name), 0)

    module._register_state_dict_hook(save)
    module._register_load_state_dict_pre_hook(load, with_module=True)


class TensorParallel:
    """The shards of one model on one rank: ``names`` maps each split
    parameter's name (``model.named_parameters()``) to (its single-process
    name, split dim)."""

    def __init__(self, names: Dict[str, Tuple[str, int]], g: _Group):
        self.names, self.g = names, g

    def is_split(self, name: str) -> bool:
        return name in self.names

    def full_named(self, tensors: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
        """Per-parameter tensors (an optimizer's moments) -> the
        single-process names and shapes (a collective)."""
        if tensors is None:
            return None
        out = {}
        for k, v in tensors.items():
            full, dim = self.names.get(k, (k, None))
            out[full] = v if dim is None else self.g.gather(v, dim)
        return out

    def split_named(self, tensors: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
        """The inverse of ``full_named``."""
        if tensors is None:
            return None
        back = {full: (k, dim) for k, (full, dim) in self.names.items()}
        out = {}
        for k, v in tensors.items():
            name, dim = back.get(k, (k, None))
            out[name] = v if dim is None else self.g.split(v, dim)
        return out


def apply_tensor_parallel(model: nn.Module, model_parallel: int, rank: int = 0,
                          group=None) -> TensorParallel:
    """Split ``model``'s leaves that ``tp_param_spec`` names over ``group``
    (this process being ``rank`` of ``model_parallel``), in place. With
    ``group`` None the shards are built without a collective (on the meta
    device, for their shapes)."""
    g = _Group(group, model_parallel, rank)
    names: Dict[str, Tuple[str, int]] = {}
    linears: List[Tuple[nn.Module, str, nn.Linear, int, str]] = []
    heads: List[Tuple[nn.Module, str, str]] = []
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        dim = mesh.tp_param_spec(name, tuple(p.shape), model_parallel)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        parent_name, _, attr = owner.rpartition(".")
        module = modules[owner]
        if leaf == "weight" and type(module) is nn.Linear:
            linears.append((modules[parent_name], attr, module, dim, name))
        elif leaf in mesh.HEAD_PARALLEL:
            heads.append((module, leaf, name))
        else:
            raise NotImplementedError(f"tensor parallelism splits nn.Linear weights and per-head biases; "
                                      f"{name} is a {type(module).__name__} leaf")
    for parent, attr, linear, dim, name in linears:
        setattr(parent, attr, _ParallelLinear(linear, dim, g))
        names[name] = (name, dim)
    for module in model.modules():  # Megatron's pair: no gather between w_1 and w_2
        if isinstance(module, PositionwiseFeedForward) and all(
                isinstance(m, _ParallelLinear) for m in (module.w_1, module.w_2)):
            pair = module.w_1.dim == 0 and module.w_2.dim == 1
            module.w_1.parallel_io = module.w_2.parallel_io = pair
            if pair:
                module.dropout = _SplitDropout(module.dropout.p, g)
    for module, leaf, name in heads:
        parametrize.register_parametrization(module, leaf, _GatherHeads(g), unsafe=True)
        _head_hooks(module, leaf, g)
        owner = name.rpartition(".")[0]
        names[f"{owner}.parametrizations.{leaf}.original"] = (name, 0)
    return TensorParallel(names, g)
