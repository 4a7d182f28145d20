"""Conventional audio-visual encoder: two independent per-modality stacks of
Branchformer or Conformer layers (counterpart of
``tailored_avsr_tpu/models/conventional.py``).

The AVSR embeddings own the input projections and the positional encoding;
each stream runs through its own ``num_blocks`` layers
(``acoustic_encoder.encoders`` / ``visual_encoder.encoders``, the layers
zipped: acoustic layer i, then visual layer i) and its own ``after_norm``.
``encoder_class_type: conformer`` builds Conformer layers
(``cnn_module_kernel``; ``models/conformer.py``), else Branchformer ones of
``attention_layer_type``. The learned merge weights come back as
``branch_weights`` ``[(layer, {"acoustic": aux, "visual": aux})]``.
``use_fused_csgu`` routes the cgMLP gates through K3 (the JAX encoder has
no such field and runs its plain gate, the same function). interCTC taps
and their (audio-visual) conditioning are the tailored encoder's
(``models/tailored.AudioVisualInterCTC``), each stream tapped after its
own ``after_norm``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoderLayer, per_layer, run_layer
from tailored_avsr_tpu_torch.models.conformer import ConformerEncoderLayer
from tailored_avsr_tpu_torch.models.tailored import AudioVisualInterCTC

_LN_EPS = 1e-6  # flax LayerNorm default


class _ModalityStack(nn.Module):
    """One stream's layers (``encoders``) and its ``after_norm``."""

    def __init__(self, layers, size: int, normalize_before: bool, **kw):
        super().__init__()
        self.encoders = nn.ModuleList(layers)
        self.after_norm = nn.LayerNorm(size, eps=_LN_EPS, **kw) if normalize_before else None

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.after_norm(x) if self.after_norm is not None else x


class ConventionalEncoder(AudioVisualInterCTC, nn.Module):
    def __init__(
        self,
        output_size: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 12,
        dropout_rate: float = 0.1,
        attention_dropout_rate: float = 0.0,
        attention_layer_type: str = "rel_selfattn",
        ffn_activation_type: str = "swish",
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        merge_method: str = "learned_ave",
        cgmlp_weight: Union[float, Sequence[float]] = 0.5,
        attn_branch_drop_rate: Union[float, Sequence[float]] = 0.0,
        stochastic_depth_rate: Union[float, Sequence[float]] = 0.0,
        macaron: bool = True,
        normalize_before: bool = True,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        encoder_class_type: str = "branchformer",
        cnn_module_kernel: int = 31,
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
        cgw = per_layer(cgmlp_weight, num_blocks, "cgmlp_weight")
        abd = per_layer(attn_branch_drop_rate, num_blocks, "attn_branch_drop_rate")
        sdr = per_layer(stochastic_depth_rate, num_blocks, "stochastic_depth_rate")

        def layer(i):
            if encoder_class_type == "conformer":
                return ConformerEncoderLayer(
                    output_size, attention_heads, attention_layer_type, attention_dropout_rate, cnn_module_kernel,
                    linear_units, ffn_activation_type, macaron, dropout_rate, sdr[i], use_flash, **kw)
            return BranchformerEncoderLayer(
                output_size, attention_heads, attention_dropout_rate, True, True, cgmlp_linear_units,
                cgmlp_conv_kernel, use_linear_after_conv, gate_activation, linear_units, ffn_activation_type,
                macaron, dropout_rate, merge_method, cgw[i], abd[i], sdr[i], use_flash, use_fused_csgu,
                attention_layer_type, **kw)

        self.acoustic_encoder = _ModalityStack([layer(i) for i in range(num_blocks)], output_size,
                                               normalize_before, **kw)
        self.visual_encoder = _ModalityStack([layer(i) for i in range(num_blocks)], output_size,
                                             normalize_before, **kw)
        self.init_interctc(output_size, interctc_layer_idx, interctc_use_conditioning,
                           audiovisual_interctc_conditioning, vocab_size, **kw)

    def forward(
        self,
        audio: torch.Tensor,
        audio_pos_emb: torch.Tensor,
        audio_mask: Optional[torch.Tensor],
        video: torch.Tensor,
        video_pos_emb: torch.Tensor,
        video_mask: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        ctc: Optional[nn.Module] = None,
        audiovisual_fusion: Optional[nn.Module] = None,
    ):
        """Returns (audio, audio_mask, video, video_mask, aux), both streams
        after their ``after_norm``, aux's ``intermediate_outs`` the fused
        taps; ``generator`` (CPU) draws the coins."""
        branch_weights, intermediate_outs = [], []
        for i, (a_layer, v_layer) in enumerate(zip(self.acoustic_encoder.encoders, self.visual_encoder.encoders)):
            audio, a_aux = run_layer(a_layer, generator, audio, audio_pos_emb, audio_mask)
            video, v_aux = run_layer(v_layer, generator, video, video_pos_emb, video_mask)
            if a_aux or v_aux:
                branch_weights.append((i + 1, {"acoustic": a_aux, "visual": v_aux}))
            if i + 1 in self.interctc_layers:
                audio, video = self.interctc_tap(
                    i + 1, self.acoustic_encoder.norm(audio), self.visual_encoder.norm(video), audio, audio_mask,
                    video, video_mask, intermediate_outs, ctc, audiovisual_fusion, generator)
        return (self.acoustic_encoder.norm(audio), audio_mask, self.visual_encoder.norm(video), video_mask,
                {"intermediate_outs": intermediate_outs, "branch_weights": branch_weights})
