"""Branchformer encoder: parallel attention and cgMLP branches with a
learned, fixed or concatenating merge
(counterpart of ``tailored_avsr_tpu/models/branchformer.py``), and the
scaffold the Conformer, Transformer and Longformer encoders reuse
(``models/conformer.py``, ``models/transformer_encoder.py``).

A layer is: macaron FFN (half-scale) -> attention branch beside the cgMLP
branch (K3 under ``use_fused_csgu``) -> merge -> FFN (half-scale) -> final
LayerNorm. The attention branch is the rel-pos MHA (``rel_selfattn``, or
``legacy_rel_selfattn`` over the legacy table; K1 or K2 under
``use_flash``, the legacy shift and ``zero_triu`` K2 only), the absolute
MHA (``selfattn``) or Fastformer's (``fast_selfattn``). Merges: ``concat``
(Linear over [attn; cgmlp]; with ``merge_conv_kernel`` > 0 the
E-Branchformer's depthwise conv over the concatenation is added to it
first, SAME-padded over every frame, padded ones included, as in JAX),
``learned_ave`` (each branch attention-pooled over time to one logit per
utterance; an f32 softmax over the two, cast back to the activation
dtype, weighs them; the weights are returned as the layer's
``weight_global`` (attention) / ``weight_local`` (cgMLP) aux) and
``fixed_ave`` (``1 - cgmlp_weight`` : ``cgmlp_weight``). A ``fixed_ave``
layer whose weight is 0.0 or 1.0 builds one branch and keeps its
``merge_proj``, as ``tailored_avsr_tpu/models/branchformer.py:111-118,195``.

The encoder takes per-layer ``cgmlp_weight`` / ``attn_branch_drop_rate`` /
``stochastic_depth_rate`` lists, an input layer (``conv2d`` and its
x1/x2/x6/x8 variants, ``conv1d2`` / ``conv1d3``, ``linear``, ``conv1d`` /
``conv3dresnet18`` (a 512->d Linear), ``embed`` (token ids, ``input_size``
rows) or none), the positional encoding its attention type pairs with
(``rel_pos``, ``legacy_rel_pos`` under ``rel_pos_type: legacy``,
``abs_pos``, ``scaled_abs_pos``) and a final LayerNorm unless
``normalize_before`` is false. It returns ``branch_weights`` as
``[(layer, aux)]`` and the interCTC taps as ``intermediate_outs``
``[(layer, out)]``: after each layer of ``interctc_layer_idx`` the output
(after ``after_norm``) is tapped, and with ``interctc_use_conditioning``
and the model's CTC head passed in, ``conditioning_layer(ctc.softmax(out))``
(``vocab_size`` -> d) is added to the stream.

Training: stochastic depth skips a whole layer (its input returned, its
aux empty) with probability ``stochastic_depth_rate`` and scales the kept
merge residual by 1 / (1 - rate); with ``attn_branch_drop_rate`` one coin
sets the learned weights to (0, 1) for the whole batch. The coins are
drawn on the CPU from the generator passed in, one per layer and step, as
the tailored encoder draws its own; the JAX package draws them from its
``skip`` RNG, so the two compare by their statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from tailored_avsr_tpu_torch.models import remat
from tailored_avsr_tpu_torch.ops.attention import (
    FastSelfAttention,
    MultiHeadedAttention,
    RelPositionMultiHeadedAttention,
)
from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalGatingMLP
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.ops.masking import MASK_MIN, make_valid_mask
from tailored_avsr_tpu_torch.ops.posenc import RELATIVE, positional_encoding
from tailored_avsr_tpu_torch.ops.subsampling import Conv1dSubsampling, Conv2dSubsampling, subsampled_length
from tailored_avsr_tpu_torch.utils.tracing import span

_LN_EPS = 1e-6  # flax LayerNorm default
CONV2D_FACTORS = {"conv2d": 4, "conv2d1": 1, "conv2d2": 2, "conv2d6": 6, "conv2d8": 8}
CONV1D_FACTORS = {"conv1d2": 2, "conv1d3": 3}
REL_ATTENTION = ("rel_selfattn", "legacy_rel_selfattn")


def attention_pooled_weight(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    pooling_proj: nn.Linear,
    weight_proj: nn.Linear,
    size: int,
) -> torch.Tensor:
    """Attention-pool a branch (or stream) over time and project it to one
    logit per utterance. The score is f32 over sqrt(size); padded frames
    score ``MASK_MIN`` and get weight 0 after the softmax, so a fully
    masked utterance pools to 0. Returns (B, 1)."""
    score = pooling_proj(x).squeeze(-1).float() / size ** 0.5  # (B, T)
    if mask is not None:
        w = torch.softmax(score.masked_fill(~mask, MASK_MIN), dim=-1).masked_fill(~mask, 0.0)
    else:
        w = torch.softmax(score, dim=-1)
    pooled = torch.einsum("bt,btd->bd", w.to(x.dtype), x)
    return weight_proj(pooled)


def coin(rate: float, training: bool, generator: Optional[torch.Generator]) -> bool:
    """One bernoulli(rate) draw on the CPU; False outside training."""
    if not training or rate <= 0.0:
        return False
    return float(torch.rand((), generator=generator)) < rate


def per_layer(value, num_blocks: int, name: str) -> list:
    """A value for every layer: one for all, or one per layer."""
    if isinstance(value, (int, float)):
        return [float(value)] * num_blocks
    if len(value) != num_blocks:
        raise ValueError(f"{name} needs one entry per block, got {len(value)} for {num_blocks}")
    return [float(v) for v in value]


def self_attention(att_type: str, size: int, heads: int, dropout_rate: float, use_flash: bool,
                   zero_triu: bool = False, fast: bool = True, **kw) -> nn.Module:
    """The attention module of ``att_type``: the rel-pos MHA (legacy under
    ``legacy_rel_selfattn``), Fastformer's for ``fast_selfattn`` when
    ``fast`` (the Branchformer and tailored layers), else the absolute MHA
    (the Conformer and Transformer layers build it for every other type)."""
    if att_type in REL_ATTENTION:
        return RelPositionMultiHeadedAttention(size, heads, dropout_rate, use_flash, zero_triu,
                                               att_type == "legacy_rel_selfattn", **kw)
    if att_type == "fast_selfattn" and fast:
        return FastSelfAttention(size, heads, dropout_rate, **kw)
    if att_type in ("selfattn", "fast_selfattn"):
        return MultiHeadedAttention(heads, dropout_rate, size, **kw)
    raise ValueError(att_type)


def attend(attn: nn.Module, h: torch.Tensor, pos_emb: Optional[torch.Tensor], mask: Optional[torch.Tensor]):
    """Self-attention of ``h`` as the JAX layers call each kind: Fastformer's
    on (h, mask), the rel-pos MHA with the table, the absolute MHA without."""
    if isinstance(attn, FastSelfAttention):
        return attn(h, mask)
    if isinstance(attn, RelPositionMultiHeadedAttention):
        return attn(h, h, h, pos_emb, mask)
    return attn(h, h, h, mask)


class BranchformerEncoderLayer(nn.Module):
    def __init__(
        self,
        size: int,
        attention_heads: int = 4,
        attention_dropout_rate: float = 0.0,
        use_attn: bool = True,
        use_cgmlp: bool = True,
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        linear_units: int = 2048,
        ffn_activation: str = "swish",
        macaron: bool = True,
        dropout_rate: float = 0.1,
        merge_method: str = "learned_ave",
        cgmlp_weight: float = 0.5,
        attn_branch_drop_rate: float = 0.0,
        stochastic_depth_rate: float = 0.0,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        attention_layer_type: str = "rel_selfattn",
        zero_triu: bool = False,
        merge_conv_kernel: int = 0,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        if merge_method not in ("concat", "learned_ave", "fixed_ave"):
            raise ValueError(merge_method)
        both = use_attn and use_cgmlp
        if merge_method == "fixed_ave" and both and cgmlp_weight in (0.0, 1.0):
            # degenerate weights collapse to one branch; merge_proj stays
            use_attn, use_cgmlp = cgmlp_weight == 0.0, cgmlp_weight == 1.0
        if not (use_attn or use_cgmlp):
            raise ValueError("a Branchformer layer needs at least one branch")
        self.size = size
        self.use_attn, self.use_cgmlp = use_attn, use_cgmlp
        self.merge_method = merge_method
        self.cgmlp_weight = float(cgmlp_weight)
        self.attn_branch_drop_rate = float(attn_branch_drop_rate)
        self.stochastic_depth_rate = float(stochastic_depth_rate)
        self.ff_scale = 0.5 if macaron else 1.0
        if macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, dropout_rate, ffn_activation, **kw)
            self.norm_ff_macaron = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        else:
            self.feed_forward_macaron = None
        if use_attn:
            self.attn = self_attention(attention_layer_type, size, attention_heads, attention_dropout_rate,
                                       use_flash, zero_triu, **kw)
            self.norm_mha = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        if use_cgmlp:
            self.cgmlp = ConvolutionalGatingMLP(
                size, cgmlp_linear_units, cgmlp_conv_kernel, dropout_rate,
                use_linear_after_conv, gate_activation, use_fused_csgu, **kw)
            self.norm_mlp = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, ffn_activation, **kw)
        self.norm_ff = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm_final = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)
        self.merge_proj = self.depthwise_conv_fusion = None
        if use_attn and use_cgmlp:
            self.merge_proj = nn.Linear(2 * size if merge_method == "concat" else size, size, **kw)
            if merge_method == "concat" and merge_conv_kernel > 0:  # E-Branchformer
                self.depthwise_conv_fusion = nn.Conv1d(2 * size, 2 * size, merge_conv_kernel, padding="same",
                                                       groups=2 * size, **kw)
            if merge_method == "learned_ave":
                for name in ("pooling_proj1", "pooling_proj2", "weight_proj1", "weight_proj2"):
                    setattr(self, name, nn.Linear(size, 1, **kw))
        elif merge_method == "fixed_ave" and both:
            self.merge_proj = nn.Linear(size, size, **kw)

    def coins(self, generator: Optional[torch.Generator]) -> Tuple[bool, bool]:
        """(skip the layer, drop the attention branch): the step's coins in
        the order the forward uses them (the branch-drop coin only for a
        kept learned-average layer)."""
        skip = coin(self.stochastic_depth_rate, self.training, generator)
        learned = self.use_attn and self.use_cgmlp and self.merge_method == "learned_ave"
        return skip, not skip and learned and coin(self.attn_branch_drop_rate, self.training, generator)

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None, coins: Optional[Tuple[bool, bool]] = None):
        """Returns (x, aux); aux holds the learned merge weights, (B,) each.
        ``coins``: ``self.coins(generator)`` drawn by the caller (a
        recomputed region must not draw them again); None draws them here."""
        skip, drop = self.coins(generator) if coins is None else coins
        if skip:
            return x, {}  # the layer is skipped this step
        coeff = 1.0 / (1.0 - self.stochastic_depth_rate) if self.training else 1.0
        aux = {}
        if self.feed_forward_macaron is not None:
            x = x + self.ff_scale * self.dropout(self.feed_forward_macaron(self.norm_ff_macaron(x)))
        x1 = x2 = x
        if self.use_attn:
            x1 = self.dropout(attend(self.attn, self.norm_mha(x), pos_emb, mask))
        if self.use_cgmlp:
            x2 = self.dropout(self.cgmlp(self.norm_mlp(x)))
        if self.use_attn and self.use_cgmlp:
            if self.merge_method == "concat":
                x_concat = torch.cat([x1, x2], dim=-1)
                if self.depthwise_conv_fusion is not None:
                    x_concat = x_concat + self.depthwise_conv_fusion(x_concat.transpose(1, 2)).transpose(1, 2)
                merged = self.merge_proj(x_concat)
            elif self.merge_method == "learned_ave":
                w1l = attention_pooled_weight(x1, mask, self.pooling_proj1, self.weight_proj1, self.size)
                w2l = attention_pooled_weight(x2, mask, self.pooling_proj2, self.weight_proj2, self.size)
                w = torch.softmax(torch.cat([w1l, w2l], dim=-1).float(), dim=-1).to(x.dtype)
                w1, w2 = w[:, 0], w[:, 1]
                if drop:
                    w1, w2 = torch.zeros_like(w1), torch.ones_like(w2)
                aux["weight_global"], aux["weight_local"] = w1, w2
                merged = self.merge_proj(w1[:, None, None] * x1 + w2[:, None, None] * x2)
            else:  # fixed_ave
                merged = self.merge_proj((1.0 - self.cgmlp_weight) * x1 + self.cgmlp_weight * x2)
        else:
            merged = x1 if self.use_attn else x2
            if self.merge_proj is not None:
                merged = self.merge_proj(merged)
        x = x + coeff * self.dropout(merged)
        x = x + self.ff_scale * self.dropout(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x), aux


def run_layer(layer: nn.Module, generator: Optional[torch.Generator], x, pos_emb, mask):
    """One layer's (x, aux), its coins drawn first and the layer run as a
    recomputed region under ``remat``."""
    coins = layer.coins(generator)
    if coins[0]:
        return x, {}  # the layer is skipped this step
    return remat.run(layer, x, pos_emb, mask, coins=coins)


def conditioning_layer(size: int, taps: Sequence[int], use_conditioning: bool, vocab_size: Optional[int],
                       **kw) -> Optional[nn.Linear]:
    """interCTC's conditioning layer (vocab -> d), or None: built only when a
    tap can use it, as flax creates it at its first use."""
    if not (use_conditioning and taps):
        return None
    if vocab_size is None:
        raise ValueError("interctc_use_conditioning needs vocab_size")
    return nn.Linear(vocab_size, size, **kw)


ATTENTION_PAIRS = {
    "rel_selfattn": ("rel_pos",),
    "legacy_rel_selfattn": ("legacy_rel_pos",),
    "selfattn": ("abs_pos", "scaled_abs_pos"),
    "fast_selfattn": ("abs_pos", "scaled_abs_pos"),
}


def resolve_types(attention_layer_type: str, pos_enc_layer_type: str, rel_pos_type: str,
                  use_attn_branch: bool = True) -> Tuple[str, str]:
    """The JAX encoder's type resolution and pairing check
    (``tailored_avsr_tpu/models/branchformer.py:320-345``): ``rel_pos_type:
    legacy`` turns the "latest" rel-pos choices into their legacy forms;
    a mismatched pair raises ValueError. Returns (attention, encoding)."""
    att, pos = attention_layer_type, pos_enc_layer_type
    if rel_pos_type == "legacy":
        att = "legacy_rel_selfattn" if att == "rel_selfattn" else att
        pos = "legacy_rel_pos" if pos == "rel_pos" else pos
    if use_attn_branch and pos not in ATTENTION_PAIRS.get(att, (pos,)):
        raise ValueError(f"attention_layer_type {att!r} requires pos_enc_layer_type in {ATTENTION_PAIRS[att]} "
                         f"(got {pos!r})")
    return att, pos


class BranchformerEncoder(nn.Module):
    """The encoder scaffold (input layer, positional encoding, layers,
    interCTC taps, ``after_norm``) with Branchformer layers; a subclass
    builds its own layers by ``make_layer``."""

    def __init__(
        self,
        output_size: int = 256,
        input_size: Optional[int] = None,  # feature dim before the input layer; token count for embed
        attention_heads: int = 4,
        attention_layer_type: str = "rel_selfattn",
        pos_enc_layer_type: str = "rel_pos",
        rel_pos_type: str = "latest",
        ffn_activation_type: str = "swish",
        linear_units: int = 2048,
        cgmlp_linear_units: int = 2048,
        cgmlp_conv_kernel: int = 31,
        use_linear_after_conv: bool = False,
        gate_activation: str = "identity",
        num_blocks: int = 12,
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        attention_dropout_rate: float = 0.0,
        input_layer: Optional[str] = "conv2d",
        merge_method: str = "learned_ave",
        use_attn_branch: bool = True,
        use_cgmlp_branch: bool = True,
        cgmlp_weight: Union[float, Sequence[float]] = 0.5,
        attn_branch_drop_rate: Union[float, Sequence[float]] = 0.0,
        stochastic_depth_rate: Union[float, Sequence[float]] = 0.0,
        normalize_before: bool = True,
        use_flash: bool = False,
        use_fused_csgu: bool = False,
        zero_triu: bool = False,
        interctc_layer_idx: Sequence[int] = (),
        interctc_use_conditioning: bool = False,
        vocab_size: Optional[int] = None,  # the conditioning layer's input width
        merge_conv_kernel: int = 0,  # > 0: the E-Branchformer merge
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        att, pos = resolve_types(attention_layer_type, pos_enc_layer_type, rel_pos_type, use_attn_branch)
        self.output_size = output_size
        self.input_layer = input_layer
        # the span of the input layer: the frontend's, which the lip frontend's 512-d features enter
        self.frontend_span = "encode.visual_frontend" if input_layer == "conv3dresnet18" else "encode.audio_frontend"
        if input_layer in CONV2D_FACTORS:
            self.embed = Conv2dSubsampling(input_size, output_size, CONV2D_FACTORS[input_layer],
                                           pos_enc_slot=True, **kw)
        elif input_layer in CONV1D_FACTORS:
            self.embed = Conv1dSubsampling(input_size, output_size, CONV1D_FACTORS[input_layer], **kw)
        elif input_layer == "linear":
            self.embed = nn.Sequential(nn.Linear(input_size, output_size, **kw),
                                       nn.LayerNorm(output_size, eps=_LN_EPS, **kw), nn.Dropout(dropout_rate))
        elif input_layer in ("conv1d", "conv3dresnet18"):  # 512-d frontend features -> d
            self.embed = nn.Sequential(nn.Linear(input_size, output_size, **kw))
        elif input_layer == "embed":
            if input_size is None:
                raise ValueError("input_layer 'embed' needs input_size (the number of tokens)")
            self.embed = nn.Sequential(nn.Embedding(input_size, output_size, **kw))
        elif input_layer is None:
            self.embed = None
        else:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.relative = pos in RELATIVE
        self.pos_enc = positional_encoding(pos, positional_dropout_rate, **kw)
        conf = dict(size=output_size, num_blocks=num_blocks, heads=attention_heads, att_type=att,
                    att_dropout=attention_dropout_rate, use_attn=use_attn_branch, use_cgmlp=use_cgmlp_branch, cgmlp_units=cgmlp_linear_units,
                    cgmlp_kernel=cgmlp_conv_kernel, linear_after_conv=use_linear_after_conv,
                    gate_activation=gate_activation, linear_units=linear_units, ffn_activation=ffn_activation_type,
                    dropout=dropout_rate, merge_method=merge_method, use_flash=use_flash,
                    use_fused_csgu=use_fused_csgu, zero_triu=zero_triu, merge_conv_kernel=merge_conv_kernel)
        cgw = per_layer(cgmlp_weight, num_blocks, "cgmlp_weight")
        abd = per_layer(attn_branch_drop_rate, num_blocks, "attn_branch_drop_rate")
        sdr = per_layer(stochastic_depth_rate, num_blocks, "stochastic_depth_rate")
        self.encoders = nn.ModuleList(self.make_layer(i, conf, cgw[i], abd[i], sdr[i], kw) for i in range(num_blocks))
        self.after_norm = nn.LayerNorm(output_size, eps=_LN_EPS, **kw) if normalize_before else None
        self.interctc_layer_idx = tuple(int(i) for i in interctc_layer_idx)
        self.conditioning_layer = conditioning_layer(output_size, self.interctc_layer_idx, interctc_use_conditioning,
                                                     vocab_size, **kw)

    def make_layer(self, i: int, conf: dict, cgmlp_weight: float, attn_branch_drop_rate: float,
                   stochastic_depth_rate: float, kw: dict) -> nn.Module:
        """Layer ``i`` (a subclass builds its own kind from the same ``conf``)."""
        c = conf
        return BranchformerEncoderLayer(
            c["size"], c["heads"], c["att_dropout"], c["use_attn"], c["use_cgmlp"], c["cgmlp_units"],
            c["cgmlp_kernel"], c["linear_after_conv"], c["gate_activation"], c["linear_units"], c["ffn_activation"],
            True, c["dropout"], c["merge_method"], cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate,
            c["use_flash"], c["use_fused_csgu"], c["att_type"], c["zero_triu"], c["merge_conv_kernel"], **kw)

    def embed_frames(self, xs: torch.Tensor, ilens: torch.Tensor):
        """The input layer and the positional encoding: (x, lengths, pos_emb
        or None)."""
        if self.embed is not None:
            xs = self.embed(xs)
        if self.input_layer in CONV2D_FACTORS:
            ilens = subsampled_length(ilens, CONV2D_FACTORS[self.input_layer])
        elif self.input_layer in CONV1D_FACTORS:
            ilens = subsampled_length(ilens, CONV1D_FACTORS[self.input_layer], conv1d=True)
        if self.relative:
            xs, pos_emb = self.pos_enc(xs)
            return xs, ilens, pos_emb
        return self.pos_enc(xs), ilens, None

    def tap(self, xs: torch.Tensor):
        """An interCTC tap of the stream: after ``after_norm`` when it exists."""
        return self.after_norm(xs) if self.after_norm is not None else xs

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor, generator: Optional[torch.Generator] = None,
                ctc: Optional[nn.Module] = None):
        """Returns (xs, olens, aux); aux holds ``intermediate_outs``
        ``[(layer, tap)]`` and ``branch_weights`` as ``[(layer,
        {weight_global, weight_local})]``, layers from 1. ``ctc`` (the
        model's head) conditions the stream at each tap when the encoder
        has a conditioning layer."""
        with span(self.frontend_span):
            xs, ilens, pos_emb = self.embed_frames(xs, ilens)
        with span("encode.encoder"):
            mask = make_valid_mask(ilens, xs.shape[1])
            branch_weights, intermediate_outs = [], []
            for i, layer in enumerate(self.encoders):
                xs, aux = run_layer(layer, generator, xs, pos_emb, mask)
                if aux:
                    branch_weights.append((i + 1, aux))
                if i + 1 in self.interctc_layer_idx:
                    out = self.tap(xs)
                    intermediate_outs.append((i + 1, out))
                    if self.conditioning_layer is not None and ctc is not None:
                        xs = xs + self.conditioning_layer(ctc.softmax(out))
            xs = self.tap(xs)
        return xs, ilens, {"intermediate_outs": intermediate_outs, "branch_weights": branch_weights}
