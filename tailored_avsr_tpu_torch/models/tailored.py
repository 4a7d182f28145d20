"""Tailored unified audio-visual encoder
(counterpart of ``tailored_avsr_tpu/models/tailored.py``).

A learned modality embedding is added to each stream; each of the N layers
runs both streams through a per-modality single branch (the attention of
``attention_layer_type`` if ``*_use_attn[l]``, else cgMLP), with
macaron-FFN and FFN weights shared across the modalities; per layer and
modality: macaron-FFN -> branch -> FFN -> LayerNorm. When the streams have
the same shape, the shared FFNs run on the stacked [audio; video] batch
(one GEMM of twice the rows). The attention is the rel-pos MHA
(``rel_selfattn``, ``legacy_rel_selfattn`` over the legacy table; with
``zero_triu``), the absolute MHA (``selfattn``) or Fastformer's
(``fast_selfattn``), as ``models/branchformer.self_attention`` builds them.
Without ``normalize_before`` there is no ``after_norm``.

interCTC: after each layer of ``interctc_layer_idx`` both streams are
tapped (after ``after_norm``) and fused by the model's audio-visual fusion
module, passed in; the fused tap is the layer's ``intermediate_outs``
entry. With ``interctc_use_conditioning`` and the model's CTC head passed
in, ``conditioning_layer`` (vocab -> d) of ``ctc.softmax`` of the fused tap
(``audiovisual_interctc_conditioning``) or of each stream's own tap is
added to each stream, as ``tailored_avsr_tpu/models/tailored.py:282-333``.

Training: stochastic depth skips a whole layer with probability
``stochastic_depth_rate`` (one coin per layer and step, drawn on the CPU
from the generator passed in) and scales the kept branch residuals by
1 / (1 - rate), as ``tailored_avsr_tpu/models/tailored.py:37-40,158-211``.
``acoustic_branch_drop_rate`` and ``positional_dropout_rate`` are stored and
unused, as in the JAX encoder (the active acoustic drop is the fusion
module's; positional dropout is the embeddings').
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from tailored_avsr_tpu_torch.models import remat
from tailored_avsr_tpu_torch.models.branchformer import attend, coin, conditioning_layer, per_layer, self_attention
from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalGatingMLP
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward

_LN_EPS = 1e-6  # flax LayerNorm default


class TailoredEncoderLayer(nn.Module):
    def __init__(
        self,
        size: int,
        acoustic_use_attn: bool,
        visual_use_attn: bool,
        attention_heads: int = 4,
        attention_dropout_rate: float = 0.0,
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        linear_units: int = 2048,
        ffn_activation: str = "swish",
        macaron: bool = True,
        dropout_rate: float = 0.1,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        stochastic_depth_rate: float = 0.0,
        attention_layer_type: str = "rel_selfattn",
        zero_triu: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.macaron = macaron
        self.stochastic_depth_rate = float(stochastic_depth_rate)
        if macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, dropout_rate, ffn_activation, **kw)
            self.norm_ff_macaron = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
        self.norm_ff = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm_final = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)
        self.use_attn = {"acoustic": bool(acoustic_use_attn), "visual": bool(visual_use_attn)}
        for prefix, attn in self.use_attn.items():
            # attribute names follow the reference keys: <m>_attn + <m>_norm_mha,
            # or <m>_cgmlp + <m>_norm_cgmlp
            if attn:
                branch = self_attention(attention_layer_type, size, attention_heads, attention_dropout_rate,
                                        use_flash, zero_triu, **kw)
            else:
                branch = ConvolutionalGatingMLP(
                    size, cgmlp_linear_units, cgmlp_conv_kernel, dropout_rate,
                    use_linear_after_conv, gate_activation, use_fused_csgu, **kw)
            kind = "attn" if attn else "cgmlp"
            setattr(self, f"{prefix}_{kind}", branch)
            setattr(self, f"{prefix}_norm_{'mha' if attn else 'cgmlp'}",
                    nn.LayerNorm(size, eps=_LN_EPS, **kw))

    def _branch(self, prefix: str, x, pos_emb, mask, coeff: float):
        attn = self.use_attn[prefix]
        norm = getattr(self, f"{prefix}_norm_{'mha' if attn else 'cgmlp'}")
        h = norm(x)
        if attn:
            h = attend(getattr(self, f"{prefix}_attn"), h, pos_emb, mask)
        else:
            h = getattr(self, f"{prefix}_cgmlp")(h)
        return x + coeff * self.dropout(h)

    def _ffn(self, ffn, norm, x):
        return x + 0.5 * self.dropout(ffn(norm(x)))

    def forward(self, audio, audio_pos_emb, audio_mask, video, video_pos_emb, video_mask,
                generator: Optional[torch.Generator] = None, skip: Optional[bool] = None):
        """``skip``: the stochastic-depth coin, drawn by the caller (a
        recomputed region must not draw it again); None draws it here."""
        if skip is None:
            skip = coin(self.stochastic_depth_rate, self.training, generator)
        if skip:
            return audio, video  # the layer is skipped this step
        coeff = 1.0 / (1.0 - self.stochastic_depth_rate) if self.training else 1.0
        stack = audio.shape == video.shape
        b = audio.shape[0]
        a, v = audio, video
        if self.macaron:
            if stack:
                a, v = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron,
                                 torch.cat([a, v], 0)).split(b)
            else:
                a = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron, a)
                v = self._ffn(self.feed_forward_macaron, self.norm_ff_macaron, v)
        a = self._branch("acoustic", a, audio_pos_emb, audio_mask, coeff)
        v = self._branch("visual", v, video_pos_emb, video_mask, coeff)
        if stack:
            av = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, torch.cat([a, v], 0)))
            a, v = av.split(b)
        else:
            a = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, a))
            v = self.norm_final(self._ffn(self.feed_forward, self.norm_ff, v))
        return a, v


class AudioVisualInterCTC:
    """Mixin of the audio-visual encoders: their interCTC taps
    (``interctc_layers``) and the optional ``conditioning_layer``
    (``models/branchformer.conditioning_layer``)."""

    def init_interctc(self, size: int, interctc_layer_idx: Sequence[int], use_conditioning: bool,
                      audiovisual_conditioning: bool, vocab_size: Optional[int], **kw) -> None:
        if audiovisual_conditioning and not use_conditioning:
            raise ValueError("audiovisual_interctc_conditioning requires interctc_use_conditioning")
        self.interctc_layers = tuple(int(i) for i in interctc_layer_idx)
        self.audiovisual_interctc_conditioning = bool(audiovisual_conditioning)
        self.conditioning_layer = conditioning_layer(size, self.interctc_layers, use_conditioning, vocab_size, **kw)

    def interctc_tap(self, layer: int, a_out, v_out, audio, audio_mask, video, video_mask, intermediate_outs: list,
                     ctc: Optional[nn.Module], fusion: Optional[nn.Module], generator=None):
        """Fuse the streams' taps ``a_out`` / ``v_out`` after ``layer`` (the
        fused tap is appended to ``intermediate_outs``) and condition the
        streams; returns (audio, video)."""
        if fusion is None:
            raise ValueError("interCTC taps need the model's audio-visual fusion module")
        av_out = fusion(a_out, audio_mask, v_out, video_mask, generator)[0]
        intermediate_outs.append((layer, av_out))
        if self.conditioning_layer is not None and ctc is not None:
            if self.audiovisual_interctc_conditioning:
                ca = cv = ctc.softmax(av_out)
            else:
                ca, cv = ctc.softmax(a_out), ctc.softmax(v_out)
            audio = audio + self.conditioning_layer(ca)
            video = video + self.conditioning_layer(cv)
        return audio, video


class TailoredEncoder(AudioVisualInterCTC, nn.Module):
    def __init__(
        self,
        output_size: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 12,
        dropout_rate: float = 0.1,
        attention_dropout_rate: float = 0.1,
        ffn_activation_type: str = "swish",
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        gate_activation: str = "identity",
        use_linear_after_conv: bool = False,
        acoustic_use_attn: Sequence[bool] = (True,) * 12,
        visual_use_attn: Sequence[bool] = (False,) * 12,
        macaron: bool = True,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        stochastic_depth_rate: Union[float, Sequence[float]] = 0.0,
        acoustic_branch_drop_rate: Union[float, Sequence[float]] = 0.0,
        positional_dropout_rate: float = 0.1,
        attention_layer_type: str = "rel_selfattn",
        zero_triu: bool = False,
        normalize_before: bool = True,
        interctc_layer_idx: Sequence[int] = (),
        interctc_use_conditioning: bool = False,
        audiovisual_interctc_conditioning: bool = False,
        vocab_size: Optional[int] = None,  # the conditioning layer's input width
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        if len(acoustic_use_attn) != num_blocks or len(visual_use_attn) != num_blocks:
            raise ValueError("acoustic_use_attn / visual_use_attn need one entry per block")
        self.positional_dropout_rate = positional_dropout_rate
        self.acoustic_branch_drop_rate = acoustic_branch_drop_rate
        sdr = per_layer(stochastic_depth_rate, num_blocks, "stochastic_depth_rate")
        self.modality_encoding = nn.Embedding(2, output_size, **kw)
        self.encoders = nn.ModuleList(
            TailoredEncoderLayer(
                output_size, acoustic_use_attn[i], visual_use_attn[i], attention_heads,
                attention_dropout_rate, cgmlp_linear_units, cgmlp_conv_kernel,
                use_linear_after_conv, gate_activation, linear_units, ffn_activation_type,
                macaron, dropout_rate, use_flash, use_fused_csgu, sdr[i], attention_layer_type, zero_triu, **kw,
            )
            for i in range(num_blocks)
        )
        self.after_norm = nn.LayerNorm(output_size, eps=_LN_EPS, **kw) if normalize_before else None
        self.init_interctc(output_size, interctc_layer_idx, interctc_use_conditioning,
                           audiovisual_interctc_conditioning, vocab_size, **kw)

    def tap(self, x: torch.Tensor) -> torch.Tensor:
        return self.after_norm(x) if self.after_norm is not None else x

    def forward(
        self,
        audio: torch.Tensor,
        audio_pos_emb: Optional[torch.Tensor],
        audio_mask: Optional[torch.Tensor],
        video: torch.Tensor,
        video_pos_emb: Optional[torch.Tensor],
        video_mask: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        ctc: Optional[nn.Module] = None,
        audiovisual_fusion: Optional[nn.Module] = None,
    ):
        """Returns (audio, audio_mask, video, video_mask, aux), both streams
        after ``after_norm``, aux's ``intermediate_outs`` the fused taps
        ``[(layer, (B, T, D))]``, as the JAX encoder returns them;
        ``generator`` (CPU) draws the stochastic-depth coins (and the
        fusion's at the taps in training)."""
        mod = self.modality_encoding.weight
        audio = audio + mod[0].to(audio.dtype)
        video = video + mod[1].to(video.dtype)
        intermediate_outs = []
        for i, layer in enumerate(self.encoders):
            if not coin(layer.stochastic_depth_rate, layer.training, generator):  # else skipped this step
                audio, video = remat.run(layer, audio, audio_pos_emb, audio_mask, video, video_pos_emb,
                                         video_mask, skip=False)
            if i + 1 in self.interctc_layers:
                audio, video = self.interctc_tap(i + 1, self.tap(audio), self.tap(video), audio, audio_mask, video,
                                                 video_mask, intermediate_outs, ctc, audiovisual_fusion, generator)
        return self.tap(audio), audio_mask, self.tap(video), video_mask, {"intermediate_outs": intermediate_outs}
