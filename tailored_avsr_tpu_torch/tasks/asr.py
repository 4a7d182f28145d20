"""ASR / VSR config -> model (counterpart of ``tailored_avsr_tpu/tasks/asr.py``).

Ported: the ``default`` (log-mel) and ``conv3dresnet18`` frontends,
SpecAug, ``utterance_mvn`` or no normalisation, the ``branchformer``
encoder, the ``transformer`` attention decoder (built unless
``model_conf.ctc_weight`` is 1.0), the CTC head and the ``espnet`` model
with its loss settings. Refused: ``model: maskctc`` (``ROADMAP.md`` item
7); ``pit_espnet``, transducer decoders, multi-blank vocabularies, pre- /
post-encoders and the other encoders and frontends (item 8). The
registries and the config-key rule are ``tasks/common.py``'s.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.asr_model import ASRModel
from tailored_avsr_tpu_torch.tasks.common import (
    NONE,
    build_decoder_and_ctc,
    build_encoder,
    build_frontend,
    build_normalize,
    build_specaug,
    cfg_value,
    loss_settings,
    materialize,
    refuse,
    require,
    resolve_device,
)


def build_meta(config, token_list: List[str]) -> ASRModel:
    """The model for ``config`` on the meta device (shapes, no weights).
    Config choices the port does not build raise here."""
    model_name = cfg_value(config, "model", "espnet") or "espnet"
    if model_name == "maskctc":
        raise refuse("model", model_name, 7)
    require("model", model_name, ("espnet",), 8)
    for key in ("preencoder", "postencoder"):
        require(key, cfg_value(config, key, "none"), NONE, 8)
    frontend = build_frontend(cfg_value(config, "frontend", "default"), cfg_value(config, "frontend_conf", {}))
    specaug = build_specaug(cfg_value(config, "specaug", "none"), cfg_value(config, "specaug_conf", {}))
    normalize = build_normalize(cfg_value(config, "normalize", "none"), cfg_value(config, "normalize_conf", {}))
    encoder_conf = dict(cfg_value(config, "encoder_conf", {}))
    encoder = build_encoder(cfg_value(config, "encoder", "branchformer"), encoder_conf,
                            input_size=frontend.output_size() if frontend is not None else 80)
    decoder, ctc = build_decoder_and_ctc(config, len(token_list), encoder.output_size)
    return ASRModel(vocab_size=len(token_list), encoder=encoder, ctc=ctc, decoder=decoder, frontend=frontend,
                    specaug=specaug, normalize=normalize, **loss_settings(config))


def build_model(
    config,
    token_list: List[str],
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> ASRModel:
    """The model for ``config``, its weights drawn from ``generator`` (seed 0
    when None) on the CPU, then moved to ``device`` (the CUDA card when
    None; ``device="cpu"`` keeps it on the CPU) / ``dtype``. Config choices
    the port does not build raise before the device is looked at."""
    model = build_meta(config, token_list)
    return materialize(model, generator, resolve_device(device, "build_model"), dtype)
