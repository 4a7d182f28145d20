"""LM config -> Transformer LM (counterpart of ``tailored_avsr_tpu/tasks/lm.py``).

``lm: transformer`` with its ``lm_conf`` keys; any other LM raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that will port it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.lm import TransformerLM
from tailored_avsr_tpu_torch.tasks.avsr import _cfg, _conf, _require, materialize, resolve_device


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
    _require("lm", _cfg(lm_config, "lm", "transformer"), ("transformer",), 8)
    lm = TransformerLM(**_conf(TransformerLM, _cfg(lm_config, "lm_conf", {}),
                               vocab_size=len(token_list)), device="meta")
    return materialize(lm, generator, resolve_device(device, "build_model"), dtype)
