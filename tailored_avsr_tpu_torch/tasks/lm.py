"""LM config -> Transformer LM (counterpart of ``tailored_avsr_tpu/tasks/lm.py``).

The Transformer LM with its ``lm_conf`` keys; the config's ``lm`` key is
not read, as the JAX LM task does not read it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.lm import TransformerLM
from tailored_avsr_tpu_torch.tasks.common import cfg_value, conf_args, materialize, resolve_device


def build_model(
    lm_config,
    token_list: List[str],
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> TransformerLM:
    """The LM for ``lm_config``, its weights drawn from ``generator`` (seed 0
    when None) on the CPU, then moved to ``device`` (the CUDA card when None;
    ``device="cpu"`` keeps it on the CPU) / ``dtype``."""
    lm = TransformerLM(**conf_args(TransformerLM, cfg_value(lm_config, "lm_conf", {}),
                                   vocab_size=len(token_list)), device="meta")
    return materialize(lm, generator, resolve_device(device, "build_model"), dtype)
