"""Activation recomputation for ``training_settings remat`` (counterpart of
the ``jax.checkpoint`` over the loss in ``tailored_avsr_tpu/train/loop.py``).

Under ``enabled()`` (the train step's forward) each encoder layer (an RNN
encoder's too), decoder layer (a Sim-T layer with the first layer's
attention probabilities passed in and returned; an S4 decoder's block)
and ResNet stage runs through ``torch.utils.checkpoint``
(non-reentrant): the forward keeps the region's inputs, and the backward
runs the region again to rebuild the activations it needs. Memory drops,
the numbers stay those of the plain step:

- dropout draws from torch's default generators, whose states the
  checkpoint saves and sets again for the recompute;
- the coins drawn from a CPU generator passed in (stochastic depth,
  branch drop) are drawn by the caller before the region and passed into
  it, so the recompute draws nothing;
- BatchNorm (``models/frontends.py``) moves its running statistics in the
  forward only: inside a recompute (``recomputing()``) it normalises with
  the batch statistics and leaves them be.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_state = threading.local()  # the backward recomputes on the autograd engine's thread


@contextlib.contextmanager
def enabled(on: bool = True):
    """Checkpoint the regions a forward runs inside this context."""
    before = getattr(_state, "on", False)
    _state.on = on
    try:
        yield
    finally:
        _state.on = before


def recomputing() -> bool:
    """True while the backward runs a checkpointed region again."""
    return getattr(_state, "recomputing", 0) > 0


@contextlib.contextmanager
def _recompute():
    _state.recomputing = getattr(_state, "recomputing", 0) + 1
    try:
        yield
    finally:
        _state.recomputing -= 1


def run(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, as a checkpointed region when ``enabled``
    and autograd records."""
    if not (getattr(_state, "on", False) and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute()), **kwargs)
