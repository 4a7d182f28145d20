"""AVSR config -> model, for the combination the flagship serves
(counterpart of ``tailored_avsr_tpu/tasks/avsr.py``).

Ported: the default log-mel frontend, utterance MVN, the conv3dresnet18
visual frontend, default embeddings with rel-pos, the tailored encoder,
adaptive fusion, the CTC head, the ``transformer`` attention decoder
(built unless ``model_conf.ctc_weight`` is 1.0, as in the JAX task), SpecAug
and the ``espnet`` model with its loss settings (``model_conf``). Any other
choice raises ``NotImplementedError`` naming the ``ROADMAP.md`` item
("Modules to port") that will port it.

A config key reaches a constructor as in ``tailored_avsr_tpu/tasks/common.py``
(``filter_conf``): a key the port's constructor takes is passed; a key the
JAX constructor takes and the port's does not is listed in the section's
``*_FIXED`` table and must hold a value the port builds (else it raises
naming its item); any other key is one the JAX constructor drops too, and is
dropped here after the same check of ``positionwise_layer_type`` and
``ctc_type``. ``tests/test_torch_port_train.py`` holds the tables to the JAX
constructors' fields.
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
from tailored_avsr_tpu_torch.ops.specaug import SpecAug
from tailored_avsr_tpu_torch.utils.initialize import init_params_

# Keys a JAX constructor takes and the port's does not: (values the port
# builds, ROADMAP item that ports the others).
ENCODER_FIXED = {
    "attention_layer_type": (("rel_selfattn",), 8),
    "zero_triu": ((False,), 8),
    "normalize_before": ((True,), 8),
    "interctc_use_conditioning": ((False,), 8),
    "audiovisual_interctc_conditioning": ((False,), 8),
    "interctc_layer_idx": (((),), 8),
}
DECODER_FIXED = {
    "use_output_layer": ((True,), 8),
    "layer_variant": (("transformer",), 8),
    # read only by the conv layer variants
    "conv_kernel_length": (None, 8),
    "conv_wshare": (None, 8),
    "conv_usebias": (None, 8),
}
VISUAL_FRONTEND_FIXED = {
    "bn_axis_name": ((None,), 9),  # cross-replica BatchNorm: data parallel
    "stem_s2d": (None, 8),  # the TPU's evaluation of the same stem weights
}
# keys that both packages drop, and the values they may hold
# (``tailored_avsr_tpu/tasks/common.py:_DROPPED_KEY_ALLOWED``)
DROPPED_KEY_ALLOWED = {
    "positionwise_layer_type": (None, "linear"),
    "ctc_type": ("builtin", "builtin2"),
}


def _not_ported(what: str, value, item: int) -> NotImplementedError:
    return not_ported(f"{what}={value!r}", item)


def _require(what: str, value, allowed, item: int) -> None:
    if value not in allowed:
        raise _not_ported(what, value, item)


def check_dropped_key(owner: str, key: str, value) -> None:
    allowed = DROPPED_KEY_ALLOWED.get(key)
    if allowed is not None and value not in allowed:
        raise NotImplementedError(
            f"{owner} config key {key}={value!r} is not supported (supported values: {allowed})")


def _conf(cls, conf: Optional[Dict], fixed: Optional[Dict] = None, **extra) -> Dict:
    """Constructor arguments of ``cls`` from a config section. A key of
    ``fixed`` (one the JAX constructor takes and the port's does not) must
    hold one of its values (None: any); other keys unknown to ``cls`` are
    dropped, as the JAX task drops them."""
    names = set(inspect.signature(cls.__init__).parameters) - {"self", "device", "dtype"}
    kept = {}
    for k, v in {**(conf or {}), **extra}.items():
        v = tuple(v) if isinstance(v, list) else v
        if k in names:
            kept[k] = v
        elif fixed and k in fixed:
            allowed, item = fixed[k]
            if allowed is not None:
                _require(f"{cls.__name__} {k}", v, allowed, item)
        else:
            check_dropped_key(cls.__name__, k, v)
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
        **_conf(Conv3dResNet18, _cfg(config, "visual_frontend_conf", {}), VISUAL_FRONTEND_FIXED), **kw)
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
    encoder = TailoredEncoder(**_conf(TailoredEncoder, encoder_conf, ENCODER_FIXED), **kw)
    fusion = AdaptiveAudioVisualFusion(
        **_conf(AdaptiveAudioVisualFusion, _cfg(config, "audiovisual_fusion_conf", {}),
                output_size=size), **kw)
    ctc_conf = dict(_cfg(config, "ctc_conf", {}))
    check_dropped_key("ctc_conf", "ctc_type", ctc_conf.get("ctc_type", "builtin"))
    ctc = CTCHead(size, len(token_list), float(ctc_conf.get("dropout_rate", 0.0)), **kw)
    specaug = None
    if _cfg(config, "specaug", "none") != "none":
        _require("specaug", config.specaug, ("specaug",), 8)
        specaug = SpecAug(**_conf(SpecAug, _cfg(config, "specaug_conf", {})))
    decoder = None
    if float(model_conf.get("ctc_weight", 0.5)) < 1.0:
        _require("decoder", _cfg(config, "decoder", "transformer") or "transformer", ("transformer",), 8)
        decoder = TransformerDecoder(
            **_conf(TransformerDecoder, _cfg(config, "decoder_conf", {}), DECODER_FIXED,
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
        specaug=specaug,
        # model_conf interctc_weight weighs interCTC taps, which are refused
        ctc_weight=float(model_conf.get("ctc_weight", 0.5)),
        lsm_weight=float(model_conf.get("lsm_weight", 0.0)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
    )
    return materialize(model, generator, resolve_device(device, "build_model"), dtype)

