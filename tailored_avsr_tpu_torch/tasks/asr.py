"""ASR / VSR config -> model (counterpart of ``tailored_avsr_tpu/tasks/asr.py``).

Ported: the ``default`` (log-mel) and ``conv3dresnet18`` frontends,
SpecAug, ``utterance_mvn`` or no normalisation, the ``branchformer``,
``e_branchformer``, ``conformer``, ``transformer``, ``longformer``, ``rnn``
and ``vgg_rnn`` encoders (interCTC taps and conditioning among the
options of the first five), every attention decoder of the JAX registry
but the two that need pretrained weights (built unless
``model_conf.ctc_weight`` is 1.0), the transducer's prediction and joint
networks (``decoder: transducer``, with the multi-blank vocabulary
extension), the CTC head, and the ``espnet`` and ``maskctc`` models (the
MLM decoder, or the Sim-T MLM decoder for ``sim_t``, over V + 1 tokens)
with their loss settings. Refused, naming ``ROADMAP.md`` item 8:
``pit_espnet``, pre- / post-encoders and the other encoders
(``transformer_multispkr``, ``contextual_block_*``) and frontends. The
registries and the config-key rule are ``tasks/common.py``'s.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.asr_model import ASRModel
from tailored_avsr_tpu_torch.models.maskctc import MaskCTCModel
from tailored_avsr_tpu_torch.tasks.common import (
    NONE,
    build_decoder_and_ctc,
    build_encoder,
    build_frontend,
    build_normalize,
    build_specaug,
    cfg_value,
    extend_multi_blank,
    loss_settings,
    materialize,
    require,
    resolve_device,
)


def build_meta(config, token_list: List[str]) -> ASRModel:
    """The model for ``config`` on the meta device (shapes, no weights).
    Config choices the port does not build raise here. A multi-blank
    transducer's ``<blank{d}>`` tokens go into ``token_list`` in place."""
    model_name = cfg_value(config, "model", "espnet") or "espnet"
    require("model", model_name, ("espnet", "maskctc"), 8)
    durations = extend_multi_blank(config, token_list)
    for key in ("preencoder", "postencoder"):
        require(key, cfg_value(config, key, "none"), NONE, 8)
    frontend = build_frontend(cfg_value(config, "frontend", "default"), cfg_value(config, "frontend_conf", {}))
    specaug = build_specaug(cfg_value(config, "specaug", "none"), cfg_value(config, "specaug_conf", {}))
    normalize = build_normalize(cfg_value(config, "normalize", "none"), cfg_value(config, "normalize_conf", {}))
    encoder_conf = dict(cfg_value(config, "encoder_conf", {}))
    encoder = build_encoder(cfg_value(config, "encoder", "branchformer"), encoder_conf,
                            input_size=frontend.output_size() if frontend is not None else 80,
                            vocab_size=len(token_list))
    decoder, joint, ctc = build_decoder_and_ctc(config, len(token_list), encoder.output_size,
                                                maskctc=model_name == "maskctc")
    cls = MaskCTCModel if model_name == "maskctc" else ASRModel
    return cls(vocab_size=len(token_list), encoder=encoder, ctc=ctc, decoder=decoder, frontend=frontend,
               specaug=specaug, normalize=normalize, joint_network=joint, prediction_network=decoder,
               transducer_multi_blank_durations=durations, **loss_settings(config))


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
