"""JAX parameters -> the port's state dict.

``utils/torch_compat.export_torch_state_dict`` (the port's numpy-only copy
of the JAX package's export) writes the reference's PyTorch key grammar, and
the port's module and parameter names follow that grammar, so exported
weights load with ``load_state_dict(strict=True)``.

The Transformer LM's keys carry an ``lm.`` prefix in that grammar (espnet's
``ESPnetLanguageModel.lm``); ``lm_state_dict`` strips it for the port's
``TransformerLM``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict

logger = logging.getLogger(__name__)


def filter_state_dict(
    model: nn.Module, state_dict: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Keep the keys of ``state_dict`` that ``model`` has.

    Returns (kept, dropped): ``dropped`` names each dropped key by its
    top-level module when the model has no such module at all (``decoder``
    for a CTC-only model), else by its full key. BatchNorm
    ``num_batches_tracked`` counters, which exported JAX trees lack, are
    filled in as 0.
    """
    expected = model.state_dict()
    tops = {k.split(".")[0] for k in expected}
    kept = {k: v for k, v in state_dict.items() if k in expected}
    dropped = sorted({
        k.split(".")[0] if k.split(".")[0] not in tops else k
        for k in state_dict if k not in expected
    })
    for k, v in expected.items():
        if k.endswith(".num_batches_tracked") and k not in kept:
            kept[k] = torch.zeros_like(v, device="cpu")
    if dropped:
        logger.info("state dict keys with no module in the port, dropped: %s", dropped)
    return kept, dropped


def convert_jax_variables(
    variables: Dict[str, Any], model: nn.Module
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX ``{'params': ..., 'batch_stats': ...}`` tree (numpy leaves) ->
    (state dict ready for ``model.load_state_dict(strict=True)``, dropped
    prefixes as in ``filter_state_dict``)."""
    exported = export_torch_state_dict(variables)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}
    return filter_state_dict(model, tensors)


LM_PREFIX = "lm."


def lm_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An LM state dict in the ``lm.`` key grammar (a ``.pth`` the JAX
    export or espnet writes) -> keys of the port's ``TransformerLM``, for a
    strict load. Raises if a key lacks the prefix."""
    stray = [k for k in state_dict if not k.startswith(LM_PREFIX)]
    if stray:
        raise KeyError(f"LM state dict keys outside the {LM_PREFIX!r} grammar: {stray[:5]}")
    return {k[len(LM_PREFIX):]: v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state_dict.items()}


def convert_jax_lm_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` variables (numpy leaves) -> state dict ready for
    the port's ``TransformerLM.load_state_dict(strict=True)``."""
    return lm_state_dict(export_torch_state_dict(variables))
