"""ASR / VSR config -> model (counterpart of ``tailored_avsr_tpu/tasks/asr.py``).

Every choice of the JAX task is built: the ``default`` (log-mel),
``sliding_window``, ``fused`` and ``conv3dresnet18`` frontends, SpecAug,
``utterance_mvn`` (``norm_vars`` too), ``global_mvn`` (over the
frontend's feature width) or no normalisation, the ``linear`` pre- and
post-encoders, every encoder of the registry (interCTC taps and
conditioning among the options of the Branchformer-based ones; the
contextual-block and multi-speaker encoders; the RNN encoders), every
attention decoder but the two that need pretrained weights (built unless
``model_conf.ctc_weight`` is 1.0), the transducer's prediction and joint
networks (``decoder: transducer``, with the multi-blank vocabulary
extension), the CTC head, and the ``espnet``, ``maskctc`` (the MLM
decoder, or the Sim-T MLM decoder for ``sim_t``, over V + 1 tokens) and
``pit_espnet`` (``model_conf`` ``num_inf`` / ``num_ref``) models with
their loss settings. The registries and the config-key rule are
``tasks/common.py``'s.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.asr_model import ASRModel
from tailored_avsr_tpu_torch.models.maskctc import MaskCTCModel
from tailored_avsr_tpu_torch.models.pit_model import PITASRModel
from tailored_avsr_tpu_torch.tasks.common import (
    build_decoder_and_ctc,
    build_encoder,
    build_frontend,
    build_normalize,
    build_postencoder,
    build_preencoder,
    build_specaug,
    cfg_value,
    extend_multi_blank,
    loss_settings,
    materialize,
    resolve_device,
)

MODELS = {"espnet": ASRModel, "maskctc": MaskCTCModel, "pit_espnet": PITASRModel}


def build_meta(config, token_list: List[str]) -> ASRModel:
    """The model for ``config`` on the meta device (shapes, no weights).
    Config choices the port does not build raise here. A multi-blank
    transducer's ``<blank{d}>`` tokens go into ``token_list`` in place."""
    model_name = cfg_value(config, "model", "espnet") or "espnet"
    durations = extend_multi_blank(config, token_list)
    frontend = build_frontend(cfg_value(config, "frontend", "default"), cfg_value(config, "frontend_conf", {}))
    specaug = build_specaug(getattr(config, "specaug", None), cfg_value(config, "specaug_conf", {}))
    # without a frontend the features arrive as they are: the config's
    # ``input_size`` (espnet's key) gives their width, 80 by default (the
    # JAX modules infer it from the first batch)
    feature_size = frontend.output_size() if frontend is not None else int(cfg_value(config, "input_size", 80))
    normalize = build_normalize(getattr(config, "normalize", None), cfg_value(config, "normalize_conf", {}),
                                feature_size)
    preencoder = build_preencoder(getattr(config, "preencoder", None), cfg_value(config, "preencoder_conf", {}),
                                  feature_size)
    encoder_conf = dict(cfg_value(config, "encoder_conf", {}))
    encoder = build_encoder(cfg_value(config, "encoder", "branchformer"), encoder_conf,
                            input_size=preencoder.output_size if preencoder is not None else feature_size,
                            vocab_size=len(token_list))
    postencoder = build_postencoder(getattr(config, "postencoder", None), cfg_value(config, "postencoder_conf", {}),
                                    encoder.output_size)
    decoder, joint, ctc = build_decoder_and_ctc(
        config, len(token_list), encoder.output_size, maskctc=model_name == "maskctc",
        memory_size=postencoder.output_size if postencoder is not None else None)
    settings = loss_settings(config)
    extra = dict(joint_network=joint, prediction_network=decoder, transducer_multi_blank_durations=durations)
    if model_name == "pit_espnet":  # the JAX PIT model takes no transducer or interCTC setting
        model_conf = dict(cfg_value(config, "model_conf", {}))
        extra = dict(num_inf=int(model_conf.get("num_inf", 2)), num_ref=int(model_conf.get("num_ref", 2)))
        settings.update(interctc_weight=0.0, transducer_multi_blank_sigma=0.05)
    return MODELS[model_name](vocab_size=len(token_list), encoder=encoder, ctc=ctc, decoder=decoder,
                              frontend=frontend, specaug=specaug, normalize=normalize, preencoder=preencoder,
                              postencoder=postencoder, **extra, **settings)


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
