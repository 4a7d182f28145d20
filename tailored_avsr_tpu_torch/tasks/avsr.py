"""AVSR config -> model (counterpart of ``tailored_avsr_tpu/tasks/avsr.py``).

Every choice of the JAX task is built: the acoustic and visual frontends
through the registry (log-mel, sliding window, fused, the lip frontend),
utterance or global MVN, the ``linear`` acoustic / visual pre-encoders and
post-encoder, default embeddings (every positional encoding), the
tailored and the conventional (Branchformer or Conformer stacks) encoders
with their attention types and interCTC taps, adaptive fusion, the CTC
head, every attention decoder of ``tasks/common.DECODERS`` (built unless
``model_conf.ctc_weight`` is 1.0, as in the JAX task), the transducer's
prediction and joint networks (with the multi-blank vocabulary
extension), SpecAug, and the ``espnet`` and ``maskctc`` models (the MLM
decoder, or the Sim-T MLM decoder, over V + 1 tokens) with their loss
settings (``model_conf``). A choice the JAX task rejects raises what it
raises (``ValueError`` for another AVSR encoder or fusion). The
registries and the config-key rule are ``tasks/common.py``'s.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tailored_avsr_tpu_torch.models.avsr_model import AVSRModel
from tailored_avsr_tpu_torch.models.embedding import DefaultEmbeddingLayerForAVSR
from tailored_avsr_tpu_torch.models.fusion import AdaptiveAudioVisualFusion
from tailored_avsr_tpu_torch.models.maskctc import AVSRMaskCTCModel
from tailored_avsr_tpu_torch.tasks.common import (
    META,
    build_decoder_and_ctc,
    build_encoder,
    build_frontend,
    build_normalize,
    build_postencoder,
    build_preencoder,
    build_specaug,
    cfg_value,
    conf_args,
    extend_multi_blank,
    loss_settings,
    materialize,
    resolve_device,
)

MODELS = {"espnet": AVSRModel, "maskctc": AVSRMaskCTCModel}


def build_meta(config, token_list: List[str]) -> AVSRModel:
    """The model for ``config`` on the meta device (shapes, no weights).
    Config choices the port does not build raise here. A multi-blank
    transducer's ``<blank{d}>`` tokens go into ``token_list`` in place."""
    model_name = cfg_value(config, "model", "espnet") or "espnet"
    durations = extend_multi_blank(config, token_list)
    a_embed_conf = dict(cfg_value(config, "acoustic_embed_conf", {}))
    v_embed_conf = dict(cfg_value(config, "visual_embed_conf", {}))
    encoder_conf = dict(cfg_value(config, "encoder_conf", {}))
    # the JAX task's pairing checks (``tailored_avsr_tpu/tasks/avsr.py:79-99``)
    a_pos = a_embed_conf.get("pos_enc_layer_type", "rel_pos")
    if a_pos != v_embed_conf.get("pos_enc_layer_type", "rel_pos"):
        raise ValueError("acoustic and visual embeds must share pos_enc_layer_type")
    att_type = str(encoder_conf.get("attention_layer_type", "rel_selfattn"))
    if att_type.endswith("rel_selfattn") != (a_pos in ("rel_pos", "legacy_rel_pos")):
        raise ValueError(f"encoder attention_layer_type {att_type!r} is incompatible with embed "
                         f"pos_enc_layer_type {a_pos!r}")

    acoustic_frontend = build_frontend(getattr(config, "acoustic_frontend", "default"),
                                       cfg_value(config, "acoustic_frontend_conf", {}))
    visual_frontend = build_frontend(getattr(config, "visual_frontend", "conv3dresnet18"),
                                     cfg_value(config, "visual_frontend_conf", {}))
    specaug = build_specaug(getattr(config, "specaug", None), cfg_value(config, "specaug_conf", {}))
    a_size = acoustic_frontend.output_size() if acoustic_frontend is not None else 80
    normalize = build_normalize(getattr(config, "normalize", None), cfg_value(config, "normalize_conf", {}),
                                a_size)
    size = int(encoder_conf.get("output_size", 256))
    encoder_name = getattr(config, "encoder", "tailored")
    if encoder_name not in ("tailored", "conventional"):
        raise ValueError(f"unknown AVSR encoder: {encoder_name}")
    fusion_name = getattr(config, "audiovisual_fusion", "adaptive")
    if fusion_name != "adaptive":
        raise ValueError(f"unknown audiovisual_fusion: {fusion_name}")
    acoustic_pre = build_preencoder(getattr(config, "acoustic_preencoder", None),
                                    cfg_value(config, "acoustic_preencoder_conf", {}), a_size)
    v_size = visual_frontend.output_size() if visual_frontend is not None else None
    visual_pre = build_preencoder(getattr(config, "visual_preencoder", None),
                                  cfg_value(config, "visual_preencoder_conf", {}), v_size)
    acoustic_embed = DefaultEmbeddingLayerForAVSR(
        **conf_args(DefaultEmbeddingLayerForAVSR, a_embed_conf,
                    input_size=acoustic_pre.output_size if acoustic_pre is not None else a_size,
                    output_size=size, input_layer=a_embed_conf.get("input_layer", "conv2d")), **META)
    visual_embed = DefaultEmbeddingLayerForAVSR(
        **conf_args(DefaultEmbeddingLayerForAVSR, v_embed_conf,
                    input_size=visual_pre.output_size if visual_pre is not None else v_size,
                    output_size=size, input_layer=v_embed_conf.get("input_layer", "linear")), **META)
    encoder = build_encoder(encoder_name, encoder_conf, vocab_size=len(token_list))
    fusion = AdaptiveAudioVisualFusion(
        **conf_args(AdaptiveAudioVisualFusion, cfg_value(config, "audiovisual_fusion_conf", {}),
                    output_size=size), **META)
    postencoder = build_postencoder(getattr(config, "postencoder", None), cfg_value(config, "postencoder_conf", {}),
                                    size)
    decoder, joint, ctc = build_decoder_and_ctc(
        config, len(token_list), size, maskctc=model_name == "maskctc",
        memory_size=postencoder.output_size if postencoder is not None else None)
    return MODELS[model_name](
        vocab_size=len(token_list),
        encoder=encoder,
        audiovisual_fusion=fusion,
        ctc=ctc,
        acoustic_embed=acoustic_embed,
        visual_embed=visual_embed,
        acoustic_frontend=acoustic_frontend,
        visual_frontend=visual_frontend,
        normalize=normalize,
        decoder=decoder,
        specaug=specaug,
        joint_network=joint,
        prediction_network=decoder,
        transducer_multi_blank_durations=durations,
        acoustic_preencoder=acoustic_pre,
        visual_preencoder=visual_pre,
        postencoder=postencoder,
        **loss_settings(config),
    )


def build_model(
    config,
    token_list: List[str],
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> AVSRModel:
    """The serving model for ``config``, its weights drawn from ``generator``
    (seed 0 when None) on the CPU, then moved to ``device`` (the CUDA card
    when None; ``device="cpu"`` keeps it on the CPU) / ``dtype``. Config
    choices the port does not build raise before the device is looked at."""
    model = build_meta(config, token_list)
    return materialize(model, generator, resolve_device(device, "build_model"), dtype)

