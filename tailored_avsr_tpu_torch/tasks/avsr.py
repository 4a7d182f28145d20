"""AVSR config -> model, for the combination the flagship serves
(counterpart of ``tailored_avsr_tpu/tasks/avsr.py``).

Ported: the default log-mel frontend, utterance MVN, the conv3dresnet18
visual frontend, default embeddings with rel-pos, the tailored encoder,
adaptive fusion, the CTC head, the ``transformer`` attention decoder
(built unless ``model_conf.ctc_weight`` is 1.0, as in the JAX task) and the
``espnet`` model. Any other choice raises ``NotImplementedError`` naming the
``ROADMAP.md`` item ("Modules to port") that will port it. Training-only
settings (SpecAug, loss weights) are not read; dropout rates are kept and
inert in eval mode.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional

import torch

from tailored_avsr_tpu_torch import not_ported
from tailored_avsr_tpu_torch.models.avsr_model import AVSRModel
from tailored_avsr_tpu_torch.models.ctc import CTCHead
from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder
from tailored_avsr_tpu_torch.models.embedding import DefaultEmbeddingLayerForAVSR
from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18
from tailored_avsr_tpu_torch.models.fusion import AdaptiveAudioVisualFusion
from tailored_avsr_tpu_torch.models.tailored import TailoredEncoder
from tailored_avsr_tpu_torch.ops.frontend_audio import LogMelFrontend
from tailored_avsr_tpu_torch.ops.normalize import UtteranceMVN
from tailored_avsr_tpu_torch.utils.initialize import init_params_

# encoder_conf keys whose other values are not ported (ROADMAP item 8)
_ENCODER_FIXED = {
    "attention_layer_type": ("rel_selfattn",),
    "zero_triu": (False,),
    "normalize_before": (True,),
    "interctc_use_conditioning": (False,),
    "audiovisual_interctc_conditioning": (False,),
    "interctc_layer_idx": ((),),
    "positionwise_layer_type": (None, "linear"),
}
# decoder_conf keys whose other values are not ported (ROADMAP item 8)
_DECODER_FIXED = {"use_output_layer": (True,), "layer_variant": ("transformer",)}


def _not_ported(what: str, value, item: int) -> NotImplementedError:
    return not_ported(f"{what}={value!r}", item)


def _require(what: str, value, allowed, item: int) -> None:
    if value not in allowed:
        raise _not_ported(what, value, item)


def _conf(cls, conf: Optional[Dict], fixed: Optional[Dict] = None, **extra) -> Dict:
    """Constructor arguments of ``cls`` from a config section; keys in
    ``fixed`` must hold one of its values, other keys (training-only) are
    dropped."""
    names = set(inspect.signature(cls.__init__).parameters) - {"self", "device", "dtype"}
    kept = {}
    for k, v in {**(conf or {}), **extra}.items():
        v = tuple(v) if isinstance(v, list) else v
        if k in names:
            kept[k] = v
        elif fixed and k in fixed:
            _require(f"{cls.__name__} {k}", v, fixed[k], 8)
    return kept


def _cfg(config, key: str, default=None):
    value = getattr(config, key, default)
    return default if value is None else value


def resolve_device(device, who: str) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when the card is
    asked for and the host has none (no silent CPU)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the CUDA card and this host has no CUDA device; "
            "pass device='cpu' to run it on the CPU")
    return device


def materialize(module: torch.nn.Module, generator: Optional[torch.Generator], device,
                dtype: Optional[torch.dtype]) -> torch.nn.Module:
    """A module built on the meta device -> its weights drawn from
    ``generator`` (seed 0 when None) on the CPU, moved to ``device`` /
    ``dtype``, in eval mode."""
    module = module.to_empty(device="cpu")
    init_params_(module, generator if generator is not None else torch.Generator().manual_seed(0))
    return module.to(device=device, dtype=dtype).eval()


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
    _require("model", _cfg(config, "model", "espnet"), ("espnet",), 7)
    _require("acoustic_frontend", _cfg(config, "acoustic_frontend", "default"), ("default",), 8)
    _require("visual_frontend", _cfg(config, "visual_frontend", "conv3dresnet18"),
             ("conv3dresnet18",), 8)
    _require("normalize", _cfg(config, "normalize", "none"), ("utterance_mvn",), 8)
    _require("encoder", _cfg(config, "encoder", "tailored"), ("tailored",), 8)
    _require("audiovisual_fusion", _cfg(config, "audiovisual_fusion", "adaptive"), ("adaptive",), 8)
    if "transducer" in str(_cfg(config, "decoder", "")):
        raise _not_ported("decoder", config.decoder, 8)
    for key in ("acoustic_preencoder", "visual_preencoder", "postencoder"):
        _require(key, _cfg(config, key, "none"), ("none", ""), 8)
    model_conf = dict(_cfg(config, "model_conf", {}))
    if model_conf.get("transducer_multi_blank_durations"):
        raise _not_ported("transducer_multi_blank_durations",
                          model_conf["transducer_multi_blank_durations"], 8)

    kw = {"device": "meta"}  # no memory, no RNG: weights come from the generator below
    acoustic_frontend = LogMelFrontend(**_conf(LogMelFrontend, _cfg(config, "acoustic_frontend_conf", {})))
    normalize = UtteranceMVN(**_conf(UtteranceMVN, _cfg(config, "normalize_conf", {})))
    visual_frontend = Conv3dResNet18(
        **_conf(Conv3dResNet18, _cfg(config, "visual_frontend_conf", {})), **kw)
    encoder_conf = dict(_cfg(config, "encoder_conf", {}))
    size = int(encoder_conf.get("output_size", 256))
    acoustic_embed = DefaultEmbeddingLayerForAVSR(
        **_conf(DefaultEmbeddingLayerForAVSR, _cfg(config, "acoustic_embed_conf", {}),
                input_size=acoustic_frontend.output_size(), output_size=size,
                input_layer=_cfg(config, "acoustic_embed_conf", {}).get("input_layer", "conv2d")),
        **kw)
    visual_embed = DefaultEmbeddingLayerForAVSR(
        **_conf(DefaultEmbeddingLayerForAVSR, _cfg(config, "visual_embed_conf", {}),
                input_size=visual_frontend.output_size(), output_size=size,
                input_layer=_cfg(config, "visual_embed_conf", {}).get("input_layer", "linear")),
        **kw)
    encoder = TailoredEncoder(**_conf(TailoredEncoder, encoder_conf, _ENCODER_FIXED), **kw)
    fusion = AdaptiveAudioVisualFusion(
        **_conf(AdaptiveAudioVisualFusion, _cfg(config, "audiovisual_fusion_conf", {}),
                output_size=size), **kw)
    ctc = CTCHead(size, len(token_list),
                  float(_cfg(config, "ctc_conf", {}).get("dropout_rate", 0.0)), **kw)
    decoder = None
    if float(model_conf.get("ctc_weight", 0.5)) < 1.0:
        _require("decoder", _cfg(config, "decoder", "transformer") or "transformer", ("transformer",), 8)
        decoder = TransformerDecoder(
            **_conf(TransformerDecoder, _cfg(config, "decoder_conf", {}), _DECODER_FIXED,
                    vocab_size=len(token_list), encoder_output_size=size), **kw)
    model = AVSRModel(
        vocab_size=len(token_list),
        encoder=encoder,
        audiovisual_fusion=fusion,
        ctc=ctc,
        acoustic_embed=acoustic_embed,
        visual_embed=visual_embed,
        acoustic_frontend=acoustic_frontend,
        visual_frontend=visual_frontend,
        normalize=normalize,
        ignore_id=int(model_conf.get("ignore_id", -1)),
        decoder=decoder,
    )
    return materialize(model, generator, resolve_device(device, "build_model"), dtype)

