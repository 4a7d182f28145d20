"""Shared pieces of the config -> model builders
(counterpart of ``tailored_avsr_tpu/tasks/common.py``): the registries of
frontends (log-mel, sliding window, fused, the lip frontend), SpecAug,
normalisation (utterance or global MVN), pre- and post-encoders,
encoders and decoders (the attention decoders of every layer variant,
MLM, LSTM and S4, the transducer's prediction and joint networks), the
multi-blank vocabulary extension, the config-key rule, seeded
materialisation and the device rule.

A config key reaches a constructor as in the JAX ``filter_conf``: a key the
port's constructor takes is passed; a key the JAX constructor takes and
the port's does not is listed in the section's ``*_FIXED`` table, with why
any value of it builds the same model; any other
key is one the JAX constructor drops too (the flagship's ``num_blocks``
reaching an ``rnn`` decoder), and is dropped here after the same check of
``positionwise_layer_type`` and ``ctc_type``.
``tests/test_torch_port_train.py``, ``tests/test_torch_port_asr.py`` and
``tests/test_torch_port_decoders.py`` hold the tables to the JAX
constructors' fields. Every name of the JAX registries is built; the names
that need pretrained weights from outside the repository raise
``NotImplementedError`` and an unknown name ``ValueError``, as in JAX.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder
from tailored_avsr_tpu_torch.models.conformer import ConformerEncoder
from tailored_avsr_tpu_torch.models.contextual_block import ContextualBlockEncoder
from tailored_avsr_tpu_torch.models.conventional import ConventionalEncoder
from tailored_avsr_tpu_torch.models.ctc import CTCHead
from tailored_avsr_tpu_torch.models.decoder import (
    DynamicConv2DDecoder,
    DynamicConvDecoder,
    LightConv2DDecoder,
    LightConvDecoder,
    MLMDecoder,
    SimTDecoder,
    SimTMLMDecoder,
    TransformerDecoder,
)
from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18
from tailored_avsr_tpu_torch.models.prepostencoder import LinearPostencoder, LinearProjection
from tailored_avsr_tpu_torch.models.rnn_decoder import RNNDecoder
from tailored_avsr_tpu_torch.models.rnn_encoder import RNNEncoder
from tailored_avsr_tpu_torch.models.s4_decoder import S4Decoder
from tailored_avsr_tpu_torch.models.tailored import TailoredEncoder
from tailored_avsr_tpu_torch.models.transformer_encoder import (
    LongformerEncoder,
    MultiSpeakerTransformerEncoder,
    TransformerEncoder,
)
from tailored_avsr_tpu_torch.ops.attention import RelPositionMultiHeadedAttention
from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalSpatialGatingUnit
from tailored_avsr_tpu_torch.ops.frontend_audio import FusedFrontend, LogMelFrontend, SlidingWindowFrontend
from tailored_avsr_tpu_torch.ops.normalize import GlobalMVN, UtteranceMVN
from tailored_avsr_tpu_torch.ops.rnnt import JointNetwork, PredictionNetwork
from tailored_avsr_tpu_torch.ops.specaug import SpecAug
from tailored_avsr_tpu_torch.utils.initialize import init_params_

# Keys a JAX constructor takes and the port's does not, and why any value
# builds the same model. The encoders and the decoders take every key of theirs.
VISUAL_FRONTEND_FIXED = {
    "stem_s2d": "the TPU's evaluation of the same stem weights: any value builds the stem",
}
ASR_ENCODERS = {
    "branchformer": BranchformerEncoder,
    "e_branchformer": BranchformerEncoder,
    "conformer": ConformerEncoder,
    "transformer": TransformerEncoder,
    "longformer": LongformerEncoder,
    "rnn": RNNEncoder,
    "vgg_rnn": RNNEncoder,
    "contextual_block_transformer": ContextualBlockEncoder,
    "contextual_block_conformer": ContextualBlockEncoder,
    "transformer_multispkr": MultiSpeakerTransformerEncoder,
}
PRETRAINED_ENCODERS = ("wav2vec2", "hubert", "hubert_pretrain", "torchaudiohubert", "whisper")
# ``tailored_avsr_tpu/tasks/common.py:build_decoder``'s table; ``whisper``
# and ``hugging_face_transformers`` need pretrained weights from outside
# the repository, and both packages refuse them
DECODERS = {
    "transformer": TransformerDecoder,
    "sim_t": SimTDecoder,
    "simt": SimTDecoder,
    "mlm": MLMDecoder,
    "sim_t_mlm": SimTMLMDecoder,
    "lightweight_conv": LightConvDecoder,
    "dynamic_conv": DynamicConvDecoder,
    "lightweight_conv2d": LightConv2DDecoder,
    "dynamic_conv2d": DynamicConv2DDecoder,
    "rnn": RNNDecoder,
    "s4": S4Decoder,
}
PRETRAINED_DECODERS = ("whisper", "hugging_face_transformers")
# keys that both packages drop, and the values they may hold
# (``tailored_avsr_tpu/tasks/common.py:_DROPPED_KEY_ALLOWED``)
DROPPED_KEY_ALLOWED = {
    "positionwise_layer_type": (None, "linear"),
    "ctc_type": ("builtin", "builtin2"),
}
NONE = (None, "none", "")


def check_dropped_key(owner: str, key: str, value) -> None:
    allowed = DROPPED_KEY_ALLOWED.get(key)
    if allowed is not None and value not in allowed:
        raise NotImplementedError(
            f"{owner} config key {key}={value!r} is not supported (supported values: {allowed})")


def constructor_names(cls) -> set:
    """The keyword names ``cls`` takes: its constructor's and, where it
    passes ``*args`` / ``**kwargs`` on (the encoders built on the
    Branchformer scaffold), its bases' too."""
    names = set()
    for c in cls.__mro__:
        if c is nn.Module or not issubclass(c, nn.Module) or "__init__" not in vars(c):
            continue
        params = inspect.signature(c.__init__).parameters.values()
        names |= {p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            break
    return names - {"self", "device", "dtype"}


def conf_args(cls, conf: Optional[Dict], fixed: Optional[Dict] = None, **extra) -> Dict:
    """Constructor arguments of ``cls`` from a config section. A key of
    ``fixed`` (one the JAX constructor takes and the port's does not) is
    dropped whatever its value; other keys unknown to ``cls`` are dropped
    after the check of the keys the JAX task drops."""
    names = constructor_names(cls)
    kept = {}
    for k, v in {**(conf or {}), **extra}.items():
        v = tuple(v) if isinstance(v, list) else v
        if k in names:
            kept[k] = v
        elif not (fixed and k in fixed):
            check_dropped_key(cls.__name__, k, v)
    return kept


def cfg_value(config, key: str, default=None):
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


def materialize(module: nn.Module, generator: Optional[torch.Generator], device,
                dtype: Optional[torch.dtype]) -> nn.Module:
    """A module built on the meta device -> its weights drawn from
    ``generator`` (seed 0 when None) on the CPU, moved to ``device`` /
    ``dtype``, in eval mode."""
    module = module.to_empty(device="cpu")
    init_params_(module, generator if generator is not None else torch.Generator().manual_seed(0))
    return module.to(device=device, dtype=dtype).eval()


META = {"device": "meta"}  # no memory, no RNG: weights come from the generator later


def set_kernels(model: nn.Module, on: bool) -> nn.Module:
    """Flash attention (K1 / K2) and the fused cgMLP gate (K3) on or off in
    every layer of ``model`` (off: the plain path)."""
    for m in model.modules():
        if isinstance(m, RelPositionMultiHeadedAttention):
            m.use_flash = on
        elif isinstance(m, ConvolutionalSpatialGatingUnit):
            m.use_fused = on
    return model


def build_frontend(name, conf: Optional[Dict]):
    """``default`` (log-mel), ``sliding_window``, ``fused`` (its
    ``frontends`` list of sub-frontend configs), ``conv3dresnet18`` or
    none (``tailored_avsr_tpu/tasks/common.py:68-96``)."""
    if name in (None, "none"):
        return None
    if name == "default":
        return LogMelFrontend(**conf_args(LogMelFrontend, conf))
    if name == "conv3dresnet18":
        return Conv3dResNet18(**conf_args(Conv3dResNet18, conf, VISUAL_FRONTEND_FIXED), **META)
    if name == "sliding_window":
        return SlidingWindowFrontend(**conf_args(SlidingWindowFrontend, conf))
    if name == "fused":
        conf = dict(conf or {})
        if "frontends" in conf:
            conf["frontends"] = tuple(dict(f) for f in conf["frontends"])
        return FusedFrontend(**conf_args(FusedFrontend, conf), **META)
    if name in ("s3prl", "whisper"):
        raise NotImplementedError(f"frontend '{name}' needs external pretrained weights, which are not part "
                                  "of this repository; use 'default' (log-mel), 'sliding_window', 'fused', or "
                                  "'conv3dresnet18'")
    raise ValueError(f"unknown frontend: {name}")


def build_specaug(name, conf: Optional[Dict]):
    if name in (None, "none"):
        return None
    if name != "specaug":
        raise ValueError(f"unknown specaug: {name}")
    return SpecAug(**conf_args(SpecAug, conf))


def build_normalize(name, conf: Optional[Dict], feature_size: int = 80):
    """``utterance_mvn``, ``global_mvn`` (over ``feature_size`` features,
    its statistics 0 / 1 until loaded) or none."""
    if name in (None, "none"):
        return None
    if name == "utterance_mvn":
        return UtteranceMVN(**conf_args(UtteranceMVN, conf))
    if name == "global_mvn":
        return GlobalMVN(**conf_args(GlobalMVN, conf, feature_size=feature_size), **META)
    raise ValueError(f"unknown normalize: {name}")


def build_preencoder(name, conf: Optional[Dict], input_size: int):
    """``linear`` (``LinearProjection`` from ``input_size`` features) or none."""
    if name in NONE:
        return None
    if name == "linear":
        return LinearProjection(**conf_args(LinearProjection, conf, input_size=input_size), **META)
    raise ValueError(f"unknown preencoder: {name}")


def build_postencoder(name, conf: Optional[Dict], input_size: int):
    """``linear`` (``LinearPostencoder`` from ``input_size`` features) or
    none; ``hugging_face_transformers`` needs pretrained weights."""
    if name in NONE:
        return None
    if name == "linear":
        return LinearPostencoder(**conf_args(LinearPostencoder, conf, input_size=input_size), **META)
    if name == "hugging_face_transformers":
        raise NotImplementedError("postencoder 'hugging_face_transformers' needs external pretrained weights, "
                                  "which are not part of this repository; use 'linear'")
    raise ValueError(f"unknown postencoder: {name}")


def build_encoder(name: str, conf: Optional[Dict], input_size: Optional[int] = None,
                  vocab_size: Optional[int] = None) -> nn.Module:
    """The encoder registry (``tailored_avsr_tpu/tasks/common.py:117-176``):
    the ASR / VSR encoders ``branchformer``, ``e_branchformer``
    (``concat`` and ``merge_conv_kernel: 3`` unless set), ``conformer``,
    ``transformer``, ``longformer`` and ``transformer_multispkr``
    (``abs_pos``, ``selfattn`` and ``relu`` unless set),
    ``contextual_block_transformer`` / ``_conformer`` (``abs_pos``,
    ``selfattn`` and the ``block_layer`` of the name unless set), ``rnn``
    and ``vgg_rnn`` (``use_vgg`` by the name unless set), whose
    ``input_size`` is the feature width they receive (the ``embed`` input
    layer's token count comes from the config), and the AVSR encoders
    ``tailored`` and ``conventional``. ``vocab_size`` is the interCTC
    conditioning layer's input width. The names that need pretrained
    weights raise ``NotImplementedError``, an unknown one ``ValueError``."""
    conf = dict(conf or {})
    if name in ("tailored", "conventional"):
        cls = TailoredEncoder if name == "tailored" else ConventionalEncoder
        return cls(**conf_args(cls, conf, vocab_size=vocab_size), **META)
    if name == "e_branchformer":
        conf.setdefault("merge_method", "concat")
        conf.setdefault("merge_conv_kernel", 3)
    elif name in ("transformer", "longformer", "transformer_multispkr"):
        conf.setdefault("pos_enc_layer_type", "abs_pos")
        conf.setdefault("attention_layer_type", "selfattn")
        conf.setdefault("ffn_activation_type", "relu")
    elif name in ("contextual_block_transformer", "contextual_block_conformer"):
        conf.setdefault("pos_enc_layer_type", "abs_pos")
        conf.setdefault("attention_layer_type", "selfattn")
        conf.setdefault("block_layer", "conformer" if name.endswith("conformer") else "transformer")
    elif name in ("rnn", "vgg_rnn"):
        conf.setdefault("use_vgg", name == "vgg_rnn")
    if name in PRETRAINED_ENCODERS:
        raise NotImplementedError(f"encoder '{name}' needs external pretrained weights, which are not part of "
                                  "this repository")
    if name not in ASR_ENCODERS:
        raise ValueError(f"unknown encoder: {name}")
    cls = ASR_ENCODERS[name]
    if conf.get("input_layer", "conv2d") != "embed":
        conf["input_size"] = input_size
    return cls(**conf_args(cls, conf, vocab_size=vocab_size), **META)


def is_transducer(decoder_name) -> bool:
    return bool(decoder_name) and "transducer" in str(decoder_name)


# Mask-CTC needs the non-causal MLM variant of the decoder
# (``tailored_avsr_tpu/tasks/asr.py:78-84``)
MLM_VARIANT = {"transformer": "mlm", "sim_t": "sim_t_mlm", "simt": "sim_t_mlm"}


def build_transducer_modules(config, vocab_size: int, encoder_size: int, memory_size: Optional[int] = None):
    """(prediction network, joint network) from the espnet-style keys
    (``tailored_avsr_tpu/tasks/common.py:234-272``): ``decoder_conf``
    ``rnn_type`` (lstm only), ``num_layers``, ``hidden_size`` (the
    embedding's too unless ``embed_size``; ``encoder_size`` unless set),
    ``dropout`` / ``dropout_rate``; ``joint_net_conf`` ``joint_space_size``,
    ``joint_activation_type``. The joint reads frames of ``memory_size``
    (a post-encoder's width; ``encoder_size`` when None)."""
    jconf = dict(cfg_value(config, "joint_net_conf", {}))
    dconf = dict(cfg_value(config, "decoder_conf", {}))
    rnn_type = dconf.get("rnn_type", "lstm")
    if rnn_type != "lstm":
        raise NotImplementedError(
            f"decoder_conf rnn_type={rnn_type!r}: only 'lstm' prediction networks are implemented "
            "(espnet TransducerDecoder also offers 'gru')")
    hidden = int(dconf.get("hidden_size", encoder_size))
    prediction = PredictionNetwork(
        vocab_size, embed_dim=int(dconf.get("embed_size", hidden)), hidden_dim=hidden,
        num_layers=int(dconf.get("num_layers", 1)),
        dropout_rate=float(dconf.get("dropout", dconf.get("dropout_rate", 0.1))), **META)
    joint = JointNetwork(vocab_size, memory_size or encoder_size, hidden,
                         joint_dim=int(jconf.get("joint_space_size", 320)),
                         activation=str(jconf.get("joint_activation_type", "tanh")), **META)
    return prediction, joint


def extend_multi_blank(config, token_list: List[str]) -> Tuple[int, ...]:
    """The multi-blank transducer's durations; their ``<blank{d}>`` tokens go
    into ``token_list`` in place, just before the blank, so the caller's
    token list is the model's (``tailored_avsr_tpu/tasks/asr.py:37-45``)."""
    model_conf = dict(cfg_value(config, "model_conf", {}))
    durations = tuple(int(d) for d in model_conf.get("transducer_multi_blank_durations") or ())
    if durations:
        blank_idx = token_list.index(model_conf.get("sym_blank", "<blank>"))
        for d in durations:
            if f"<blank{d}>" not in token_list:
                token_list.insert(blank_idx, f"<blank{d}>")
    return durations


def build_decoder_and_ctc(config, vocab_size: int, encoder_size: int, maskctc: bool = False,
                          memory_size: Optional[int] = None):
    """(decoder, joint network, CTC head). A transducer ``decoder`` gives the
    LSTM prediction network and the joint network; otherwise the attention
    decoder of ``DECODERS`` is built unless ``model_conf.ctc_weight`` is 1.0
    (as the JAX tasks build none), for a Mask-CTC model over V + 1 tokens
    and, for ``transformer`` and ``sim_t``, as its MLM variant. The
    decoders are ``encoder_size`` wide; what reads the memory (the CTC
    head, the joint, a decoder's cross-attention, the LSTM decoder) takes
    ``memory_size`` features when a post-encoder changes the width, as the
    JAX modules infer their input widths."""
    memory = memory_size if memory_size not in (None, encoder_size) else None
    decoder_name = cfg_value(config, "decoder", "transformer") or "transformer"
    model_conf = dict(cfg_value(config, "model_conf", {}))
    decoder = joint = None
    if is_transducer(decoder_name):
        decoder, joint = build_transducer_modules(config, vocab_size, encoder_size, memory)
    elif float(model_conf.get("ctc_weight", 0.5)) < 1.0:
        if maskctc:
            decoder_name = MLM_VARIANT.get(decoder_name, decoder_name)
        if decoder_name in PRETRAINED_DECODERS:
            raise NotImplementedError(f"decoder {decoder_name!r} needs external pretrained weights, which are "
                                      "not part of this repository")
        if decoder_name not in DECODERS:
            raise ValueError(f"unknown decoder: {decoder_name}")
        cls = DECODERS[decoder_name]
        width = {"encoder_output_size": memory or encoder_size} if cls is RNNDecoder else {
            "encoder_output_size": encoder_size, **({"memory_size": memory} if memory else {})}
        decoder = cls(**conf_args(cls, cfg_value(config, "decoder_conf", {}),
                                  vocab_size=vocab_size + 1 if maskctc else vocab_size, **width), **META)
    ctc_conf = dict(cfg_value(config, "ctc_conf", {}))
    check_dropped_key("ctc_conf", "ctc_type", ctc_conf.get("ctc_type", "builtin"))
    ctc = CTCHead(memory or encoder_size, vocab_size, float(ctc_conf.get("dropout_rate", 0.0)), **META)
    return decoder, joint, ctc


def loss_settings(config) -> Dict:
    """The model's loss settings from ``model_conf``."""
    model_conf = dict(cfg_value(config, "model_conf", {}))
    return {
        "ctc_weight": float(model_conf.get("ctc_weight", 0.5)),
        "interctc_weight": float(model_conf.get("interctc_weight", 0.0)),
        "ignore_id": int(model_conf.get("ignore_id", -1)),
        "lsm_weight": float(model_conf.get("lsm_weight", 0.0)),
        "length_normalized_loss": bool(model_conf.get("length_normalized_loss", False)),
        "transducer_multi_blank_sigma": float(model_conf.get("transducer_multi_blank_sigma", 0.05)),
    }


def task_of(config) -> str:
    task = getattr(config, "task", "avsr") or "avsr"
    if task not in ("avsr", "asr", "vsr"):
        raise ValueError(f"unknown task: {task!r} (avsr, asr or vsr)")
    return task


def build_model(config, token_list: List[str], *, generator: Optional[torch.Generator] = None,
                device=None, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The model of ``config.task`` (``tasks/avsr.py`` for avsr,
    ``tasks/asr.py`` for asr and vsr), as the JAX engine picks its task
    (``tailored_avsr_tpu/inference.py:154``)."""
    if task_of(config) == "avsr":
        from tailored_avsr_tpu_torch.tasks import avsr as task
    else:
        from tailored_avsr_tpu_torch.tasks import asr as task
    return task.build_model(config, token_list, generator=generator, device=device, dtype=dtype)
