"""Optimizers and learning-rate schedules: Noam, OneCycle, constant; Adam /
AdamW with gradient clipping, frozen modules and gradient accumulation
(counterpart of ``tailored_avsr_tpu/train/optim.py``).

``Optimizer`` is the JAX package's optax chain written out:
[zero frozen gradients] -> [clip by global norm] -> Adam or AdamW under the
schedule -> [zero frozen updates], wrapped in ``optax.MultiSteps`` when
``accum_grad`` > 1 (the running mean of the micro-steps' gradients; the
parameters move on every ``accum_grad``-th step). A frozen parameter's
gradient is 0 before the clip and its update 0 after the optimizer, so its
moments stay 0 and it never moves: the port skips its arithmetic.

The arithmetic follows optax: ``mu = b1 mu + (1 - b1) g``,
``nu = b2 nu + (1 - b2) g^2``, bias corrections by ``count`` (updates
applied, from 1), ``u = mu_hat / (sqrt(nu_hat) + eps)`` (+ ``wd * p`` for
AdamW), ``p -= lr(count - 1) * u``; the clip scales by
``max_norm / norm`` when ``norm >= max_norm`` (optax's
``clip_by_global_norm``; torch's ``clip_grad_norm_`` divides by
``norm + 1e-6``). Everything is f32, on the parameters' device, in
multi-tensor (``torch._foreach_*``) launches. Under tensor parallelism
(``set_tensor_parallel``) the moments live on the shards, and the clip's
norm sums each split leaf's squares over the model group and each
replicated leaf's once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

Schedule = Callable[[int], float]


def noam_schedule(model_size: int, factor: float, warmup: int) -> Schedule:
    """lr(step) = factor d^-0.5 min(s^-0.5, s warmup^-1.5), s = step + 1
    (torch's _LRScheduler starts at step 1)."""
    def schedule(step: int) -> float:
        s = step + 1.0
        return factor * model_size ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

    return schedule


def onecycle_schedule(peak_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """optax's ``cosine_onecycle_schedule``: cosine from peak / div_factor up
    to peak over the first ``pct_start`` of the steps, then cosine down to
    peak / (div_factor final_div_factor); constant after the end."""
    total = max(total_steps, 1)
    bounds = (0, int(pct_start * total), int(total))
    values = (peak_lr / div_factor, peak_lr, peak_lr / (div_factor * final_div_factor))

    def schedule(step: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                a, b = values[i], values[i + 1]
                return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[2]

    return schedule


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


class Optimizer:
    """Adam / AdamW over named parameters with the JAX package's chain (see
    the module docstring). ``step()`` consumes the micro-step's gradients
    (``p.grad``; None counts as 0) and clears them; it returns whether the
    parameters moved."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, nn.Parameter]],
        schedule: Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: Optional[float] = None,
        grad_clip: float = -1.0,
        accum_grad: int = 1,
        frozen: Sequence[str] = (),
    ):
        named = list(named_params)
        self.names = [n for n, _ in named]
        unknown = set(frozen) - set(self.names)
        if unknown:
            raise KeyError(f"frozen names that are not parameters: {sorted(unknown)[:5]}")
        frozen = set(frozen)
        self.params = [p for n, p in named if n not in frozen]
        self.trainable = [n for n in self.names if n not in frozen]
        self.frozen = sorted(frozen)
        self._frozen_params = [p for n, p in named if n in frozen]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accum_grad = max(int(accum_grad), 1)
        self.count = 0  # updates applied
        self.mini_step = 0  # micro-steps accumulated since the last update
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]  # noqa: E731
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.accum_grad > 1 else None
        self._split = None  # tensor parallelism: (bool mask of split trainables, model group)

    def set_tensor_parallel(self, is_split, group) -> None:
        """Mark the trainables whose name ``is_split`` accepts as this rank's
        shards of leaves split over ``group`` (for the clip's norm)."""
        mask = torch.tensor([bool(is_split(n)) for n in self.trainable])
        self._split = (mask, group)

    def _grads(self):
        """(tensors with a gradient, their gradients, tensors without one)."""
        has, grads, none = [], [], []
        for i, p in enumerate(self.params):
            if p.grad is None:
                none.append(i)
            else:
                has.append(i)
                grads.append(p.grad.float())
        return has, grads, none

    def zero_grad(self) -> None:
        for p in (*self.params, *self._frozen_params):
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        has, grads, none = self._grads()
        if self.acc is not None:
            w = 1.0 / (self.mini_step + 1)  # optax.MultiSteps: running mean
            if has:
                torch._foreach_lerp_([self.acc[i] for i in has], grads, w)
            if none:
                torch._foreach_mul_([self.acc[i] for i in none], 1.0 - w)
            self.zero_grad()
            if self.mini_step < self.accum_grad - 1:
                self.mini_step += 1
                return False
            self.mini_step = 0
            g = self.acc
        else:
            g = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            for i, gi in zip(has, grads):
                g[i] = gi
            self.zero_grad()
        self._update(g)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    def _update(self, g) -> None:
        if self.grad_clip > 0:
            norms = torch.stack(torch._foreach_norm(g))
            if self._split is None:
                norm = torch.linalg.vector_norm(norms)
            else:
                mask, group = self._split
                mask = mask.to(norms.device)
                split_sq = (norms * norms * mask).sum()
                dist.all_reduce(split_sq, group=group)
                norm = torch.sqrt(split_sq + (norms * norms * ~mask).sum())
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            g = torch._foreach_mul(g, scale)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
        lr = self.schedule(self.count)
        self.count += 1
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, u, alpha=-lr)

    def state_dict(self) -> Dict:
        named = lambda ts: dict(zip(self.trainable, ts)) if ts is not None else None  # noqa: E731
        return {"count": self.count, "mini_step": self.mini_step, "mu": named(self.mu),
                "nu": named(self.nu), "acc": named(self.acc)}

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in zip(self.trainable, mine):
                t.copy_(state[key][name])


def set_optimizer(training_settings: dict, model_size: int, steps_per_epoch: int,
                  named_params: Iterable[Tuple[str, nn.Parameter]],
                  frozen: Sequence[str] = ()) -> Tuple[Optimizer, Schedule]:
    """(Optimizer, schedule) from the reference's ``training_settings``, as
    ``tailored_avsr_tpu/train/optim.py:set_optimizer``: Noam picks Adam's
    betas (0.9, 0.98) and eps 1e-9, OneCycle and constant (0.9, 0.999) and
    1e-8; ``frozen`` names the frozen parameters."""
    name = training_settings.get("optimizer", "adam")
    sched_name = training_settings.get("scheduler", "noam")
    lr = float(training_settings.get("learning_rate", 1e-3))
    accum = int(training_settings.get("accum_grad", 1))
    warmup = int(training_settings.get("warmup_steps", 25000))
    epochs = int(training_settings.get("epochs", 1))
    if sched_name == "noam":
        schedule = noam_schedule(model_size, float(training_settings.get("noam_factor", 1.0)), warmup)
        b1, b2, eps = 0.9, 0.98, 1e-9
    elif sched_name == "onecycle":
        schedule = onecycle_schedule(lr, max(1, steps_per_epoch // max(accum, 1)) * epochs)
        b1, b2, eps = 0.9, 0.999, 1e-8
    elif sched_name in (None, "none", "constant"):
        schedule = constant_schedule(lr)
        b1, b2, eps = 0.9, 0.999, 1e-8
    else:
        raise ValueError(f"unknown scheduler: {sched_name}")
    if name == "adam":
        weight_decay = None
    elif name == "adamw":
        weight_decay = float(training_settings.get("weight_decay", 0.01))
    else:
        raise ValueError(f"unknown optimizer: {name}")
    opt = Optimizer(named_params, schedule, b1, b2, eps, weight_decay,
                    float(training_settings.get("grad_clip", -1.0)), accum, frozen)
    return opt, schedule
