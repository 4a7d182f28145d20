"""JAX parameters -> the port's state dict.

The JAX package's ``export_torch_state_dict`` (``tailored_avsr_tpu/utils/
torch_compat.py:311``) already writes the reference's PyTorch key grammar,
and the port's module and parameter names follow that grammar, so exported
weights load with ``load_state_dict(strict=True)``. That module needs only
numpy; it is imported lazily, inside the function that uses it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def filter_state_dict(
    model: nn.Module, state_dict: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Keep the keys of ``state_dict`` that ``model`` has.

    Returns (kept, dropped): ``dropped`` names each dropped key by its
    top-level module when the model has no such module at all (``decoder``
    for the serving slice), else by its full key. BatchNorm
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
    from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict

    exported = export_torch_state_dict(variables)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}
    return filter_state_dict(model, tensors)
